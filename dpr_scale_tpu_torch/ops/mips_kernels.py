"""One-sweep reductions of inner-product scores for the exact MIPS index.

Counterparts of :mod:`dpr_scale_tpu.ops.mips_kernels`. Each function takes
queries ``(B, D)`` and corpus rows ``(N, D)``, casts the queries to the corpus
dtype, sums the products in fp32 and returns the JAX function's layout:

* :func:`count_above_groups` ``(B, N // group)`` int32 — per query and
  ``group``-row corpus group, the scores ``q . c > tau``: pass 2 of the fused
  search (``csrc/count_groups.cu``);
* :func:`count_above` ``(B,)`` int32 — the scores above ``tau`` over the
  whole corpus, any N: the verification pass of ``method="auto"``
  (``csrc/mips_scan.cu``);
* :func:`groupmax` ``(t1 (N // 8, B), t2 (N // 128, B))`` fp32 — the max of
  every ``GMAX_ROWS``-row group and of every ``GMAX_TIER2`` such groups,
  N % 128 == 0: the sweep of ``method="groupmax"`` (``csrc/mips_scan.cu``);
* :func:`tile_max_scores` ``(B, N // tile)`` fp32 — the max score of each
  ``tile``-row corpus tile, N % tile == 0 (``csrc/mips_scan.cu``): the
  threshold step of :func:`topk_candidates` on the score tile;
* :func:`topk_candidates` ``(scores (B, kc) fp32 descending, rows (B, kc)
  int64)`` — the exact top-kc rows below ``n_valid`` of each query, missing
  entries ``NEG_INF`` / -1: pass 1 of the fused, auto, approx and
  exact_sort searches (``csrc/topk_sweep.cu``), the counterpart of the JAX
  program's dot fused into ``lax.approx_max_k`` (an XLA TPU primitive, no
  Pallas kernel).

Each comes as ``<name>_plain`` (plain PyTorch: the CPU path and the oracle,
scores materialise chunk by chunk), ``<name>_kernel`` (the hand-written CUDA
kernel, bf16 or fp32, scores never reach memory; ``.launches`` counts its
launches) and ``<name>`` (dispatch: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises). Each runs a wgmma kernel on a
bf16 corpus (for the group counts, groups of a multiple of 128 rows; for
the tile maxima, tiles of a multiple of 256 rows), fed by TMA where TMA can
address the rows (D % 8 == 0, 16-byte aligned bases: "wgmma") and by
cp.async where D is even and the bases 4-byte aligned ("wgmma_cp_async",
SPLADE's D = 30,522), and the older score-tile kernel on every other shape
(fp32, odd D), chosen by shape in the C entry point; ``.launches_by_route``
counts each route (:data:`ROUTES`); :func:`topk_candidates` takes the same
three routes: one select sweep on the two wgmma routes, the tile maxima
and an emit sweep on the score tile.
"""
from __future__ import annotations

import torch

GROUP_ROWS = 256  # rescue granularity of the fused pipeline
GMAX_ROWS = 8  # corpus rows per tier-1 max group (selection granularity)
GMAX_TIER2 = 16  # tier-1 groups per tier-2 group (128 rows)
TILE_ROWS = 4096  # corpus rows per tile_max_scores tile
PLAIN_CHUNK_ROWS = 131072  # rows of fp32 scores the plain versions hold at once

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
ROUTES = ("score_tile", "wgmma", "wgmma_cp_async")  # the dst_*_route entry points' 0, 1, 2


def _check_pair(what, queries, corpus, *, divisor=1):
    if queries.dim() != 2 or corpus.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"{what}: queries {tuple(queries.shape)} and corpus "
            f"{tuple(corpus.shape)} do not agree"
        )
    if divisor < 1 or corpus.shape[0] % divisor:
        raise ValueError(
            f"{what}: {divisor} must divide the corpus rows {corpus.shape[0]}"
        )


def _check_thresholds(what, queries, thresholds):
    if thresholds.shape != (queries.shape[0],):
        raise ValueError(
            f"{what}: thresholds {tuple(thresholds.shape)} do not match "
            f"{queries.shape[0]} queries"
        )


def _kernel_inputs(what, queries, corpus, *others):
    """Refuse what the CUDA kernels cannot take; returns the queries cast to
    the corpus dtype, contiguous."""
    if corpus.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} kernel takes a bf16 or fp32 corpus, got {corpus.dtype}")
    if not corpus.is_contiguous():
        raise ValueError(f"{what} kernel: the corpus must be contiguous")
    if not corpus.is_cuda:
        raise ValueError(f"{what} kernel takes CUDA tensors, got {corpus.device}")
    if any(t.device != corpus.device for t in (queries, *others)):
        raise ValueError(f"{what} kernel: all tensors must be on one CUDA device")
    return queries.to(corpus.dtype).contiguous()


def _dispatch(what, corpus, kernel, plain, *args):
    if corpus.is_cuda:
        return kernel(*args)
    if corpus.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"{what}: unsupported device {corpus.device}")


def _score_chunks(queries, corpus, chunk):
    """(lo, hi, fp32 scores (B, hi - lo)) over corpus rows in ``chunk``-row
    pieces; the queries are cast to the corpus dtype first."""
    qf = queries.to(corpus.dtype).float()
    for lo in range(0, corpus.shape[0], chunk):
        hi = min(lo + chunk, corpus.shape[0])
        yield lo, hi, torch.matmul(qf, corpus[lo:hi].float().T)


# --------------------------------------------------------------------- #
# per-group counts (pass 2 of method="fused")


def count_above_groups_plain(queries, corpus, thresholds, group: int = GROUP_ROWS):
    _check_pair("count_above_groups", queries, corpus, divisor=group)
    _check_thresholds("count_above_groups", queries, thresholds)
    B, N = queries.shape[0], corpus.shape[0]
    out = torch.empty((B, N // group), dtype=torch.int32, device=corpus.device)
    tau = thresholds.float()[:, None]
    chunk = max(group, PLAIN_CHUNK_ROWS // group * group)
    for lo, hi, s in _score_chunks(queries, corpus, chunk):
        above = (s > tau).view(B, (hi - lo) // group, group)
        out[:, lo // group : hi // group] = above.sum(dim=2, dtype=torch.int32)
    return out


def count_above_groups_kernel(queries, corpus, thresholds, group: int = GROUP_ROWS):
    """Launch ``csrc/count_groups.cu`` on the current CUDA stream."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    _check_pair("count_above_groups", queries, corpus, divisor=group)
    _check_thresholds("count_above_groups", queries, thresholds)
    q = _kernel_inputs("count_above_groups", queries, corpus, thresholds)
    B, N, D = queries.shape[0], corpus.shape[0], corpus.shape[1]
    tau = thresholds.to(torch.float32).contiguous()
    out = torch.empty((B, N // group), dtype=torch.int32, device=corpus.device)
    dtype = _KERNEL_DTYPES[corpus.dtype]
    with torch.cuda.device(corpus.device):
        lib = cuda_lib.library()
        route = ROUTES[lib.dst_count_above_groups_route(
            q.data_ptr(), corpus.data_ptr(), N, D, group, dtype)]
        rc = lib.dst_count_above_groups(
            q.data_ptr(), corpus.data_ptr(), tau.data_ptr(), out.data_ptr(),
            B, N, D, group, dtype, torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "count_above_groups")
    count_above_groups_kernel.launches += 1
    count_above_groups_kernel.launches_by_route[route] += 1
    return out


count_above_groups_kernel.launches = 0
count_above_groups_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def count_above_groups(queries, corpus, thresholds, group: int = GROUP_ROWS):
    return _dispatch(
        "count_above_groups", corpus, count_above_groups_kernel, count_above_groups_plain,
        queries, corpus, thresholds, group,
    )


# --------------------------------------------------------------------- #
# whole-corpus counts (the verification of method="auto")


def count_above_plain(queries, corpus, thresholds):
    _check_pair("count_above", queries, corpus)
    _check_thresholds("count_above", queries, thresholds)
    out = torch.zeros((queries.shape[0],), dtype=torch.int32, device=corpus.device)
    tau = thresholds.float()[:, None]
    for _lo, _hi, s in _score_chunks(queries, corpus, PLAIN_CHUNK_ROWS):
        out += (s > tau).sum(dim=1, dtype=torch.int32)
    return out


def count_above_kernel(queries, corpus, thresholds):
    """Launch ``csrc/mips_scan.cu``'s count on the current CUDA stream."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    _check_pair("count_above", queries, corpus)
    _check_thresholds("count_above", queries, thresholds)
    q = _kernel_inputs("count_above", queries, corpus, thresholds)
    B, N, D = queries.shape[0], corpus.shape[0], corpus.shape[1]
    tau = thresholds.to(torch.float32).contiguous()
    out = torch.zeros((B,), dtype=torch.int32, device=corpus.device)  # blocks add into it
    dtype = _KERNEL_DTYPES[corpus.dtype]
    with torch.cuda.device(corpus.device):
        lib = cuda_lib.library()
        route = ROUTES[lib.dst_count_above_route(q.data_ptr(), corpus.data_ptr(), N, D, dtype)]
        rc = lib.dst_count_above(
            q.data_ptr(), corpus.data_ptr(), tau.data_ptr(), out.data_ptr(),
            B, N, D, dtype, torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "count_above")
    count_above_kernel.launches += 1
    count_above_kernel.launches_by_route[route] += 1
    return out


count_above_kernel.launches = 0
count_above_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def count_above(queries, corpus, thresholds):
    return _dispatch(
        "count_above", corpus, count_above_kernel, count_above_plain,
        queries, corpus, thresholds,
    )


# --------------------------------------------------------------------- #
# hierarchical group maxima (the sweep of method="groupmax")

_GMAX_SPAN = GMAX_ROWS * GMAX_TIER2


def groupmax_plain(queries, corpus):
    _check_pair("groupmax", queries, corpus, divisor=_GMAX_SPAN)
    B, N = queries.shape[0], corpus.shape[0]
    t1 = torch.empty((N // GMAX_ROWS, B), dtype=torch.float32, device=corpus.device)
    for lo, hi, s in _score_chunks(queries, corpus, PLAIN_CHUNK_ROWS):
        t1[lo // GMAX_ROWS : hi // GMAX_ROWS] = s.view(B, -1, GMAX_ROWS).amax(dim=2).T
    t2 = t1.view(N // _GMAX_SPAN, GMAX_TIER2, B).amax(dim=1)
    return t1, t2


def groupmax_kernel(queries, corpus):
    """Launch ``csrc/mips_scan.cu``'s group maxima on the current CUDA stream."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    _check_pair("groupmax", queries, corpus, divisor=_GMAX_SPAN)
    q = _kernel_inputs("groupmax", queries, corpus)
    B, N, D = queries.shape[0], corpus.shape[0], corpus.shape[1]
    t1 = torch.empty((N // GMAX_ROWS, B), dtype=torch.float32, device=corpus.device)
    t2 = torch.empty((N // _GMAX_SPAN, B), dtype=torch.float32, device=corpus.device)
    dtype = _KERNEL_DTYPES[corpus.dtype]
    with torch.cuda.device(corpus.device):
        lib = cuda_lib.library()
        route = ROUTES[lib.dst_groupmax_route(q.data_ptr(), corpus.data_ptr(), N, D, dtype)]
        rc = lib.dst_groupmax(
            q.data_ptr(), corpus.data_ptr(), t1.data_ptr(), t2.data_ptr(),
            B, N, D, dtype, torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "groupmax")
    groupmax_kernel.launches += 1
    groupmax_kernel.launches_by_route[route] += 1
    return t1, t2


groupmax_kernel.launches = 0
groupmax_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def groupmax(queries, corpus):
    return _dispatch("groupmax", corpus, groupmax_kernel, groupmax_plain, queries, corpus)


# --------------------------------------------------------------------- #
# per-tile maxima (the threshold of topk_candidates)


def tile_max_scores_plain(queries, corpus, tile: int = TILE_ROWS):
    _check_pair("tile_max_scores", queries, corpus, divisor=tile)
    B, N = queries.shape[0], corpus.shape[0]
    out = torch.empty((B, N // tile), dtype=torch.float32, device=corpus.device)
    chunk = max(tile, PLAIN_CHUNK_ROWS // tile * tile)
    for lo, hi, s in _score_chunks(queries, corpus, chunk):
        out[:, lo // tile : hi // tile] = s.view(B, -1, tile).amax(dim=2)
    return out


def tile_max_scores_kernel(queries, corpus, tile: int = TILE_ROWS):
    """Launch ``csrc/mips_scan.cu``'s tile maxima on the current CUDA stream."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    _check_pair("tile_max_scores", queries, corpus, divisor=tile)
    q = _kernel_inputs("tile_max_scores", queries, corpus)
    B, N, D = queries.shape[0], corpus.shape[0], corpus.shape[1]
    out = torch.empty((B, N // tile), dtype=torch.float32, device=corpus.device)
    dtype = _KERNEL_DTYPES[corpus.dtype]
    with torch.cuda.device(corpus.device):
        lib = cuda_lib.library()
        route = ROUTES[lib.dst_tile_max_route(q.data_ptr(), corpus.data_ptr(), N, D, tile, dtype)]
        rc = lib.dst_tile_max(
            q.data_ptr(), corpus.data_ptr(), out.data_ptr(), B, N, D, tile, dtype,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "tile_max_scores")
    tile_max_scores_kernel.launches += 1
    tile_max_scores_kernel.launches_by_route[route] += 1
    return out


tile_max_scores_kernel.launches = 0
tile_max_scores_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def tile_max_scores(queries, corpus, tile: int = TILE_ROWS):
    return _dispatch(
        "tile_max_scores", corpus, tile_max_scores_kernel, tile_max_scores_plain,
        queries, corpus, tile,
    )


# --------------------------------------------------------------------- #
# the top-kc rows of each query (pass 1 of fused, auto, approx, exact_sort)

NEG_INF = -1e30  # the score of a missing candidate (a large finite -inf)
TOPK_CAP = 4  # the score tile's emit-sweep slots a query, in multiples of kc
TOPK_TILES = 4  # whole tiles the score tile's threshold tile is cut to give, in multiples of kc
TOPK_TILE_MAX = 4096  # the largest tile of the score tile's threshold maxima
_KEY_EMPTY = -(2**63)  # an empty slot of the sweeps' keys, below every candidate's


def _check_topk(queries, corpus, n_valid, kc):
    _check_pair("topk_candidates", queries, corpus)
    if not 0 <= n_valid <= corpus.shape[0] or kc < 1:
        raise ValueError(f"topk_candidates: n_valid {n_valid} of {corpus.shape[0]} rows, kc {kc}")


def merge_chunk_topk(chunks, n_valid: int, kc: int):
    """The top-kc (scores descending, rows) of fp32 score chunks ``(lo, hi,
    (B, hi - lo) scores)`` that cover rows [0, N) in order: each chunk's
    top-kc merged into the running one, rows >= n_valid never returned,
    missing entries NEG_INF / -1. Writes NEG_INF into the chunks' pad
    columns."""
    best_s = best_i = None
    for lo, hi, s in chunks:
        if hi > n_valid:  # pad rows
            s[:, max(n_valid - lo, 0) :] = NEG_INF
        ts, ti = torch.topk(s, min(kc, hi - lo), dim=1)
        ti = ti + lo
        if best_s is not None:
            ts, ti = torch.cat([best_s, ts], 1), torch.cat([best_i, ti], 1)
        best_s, pos = torch.topk(ts, min(kc, ts.shape[1]), dim=1)
        best_i = torch.gather(ti, 1, pos)
    if best_s.shape[1] < kc:  # fewer rows than kc
        pad = (0, kc - best_s.shape[1])
        best_s = torch.nn.functional.pad(best_s, pad, value=NEG_INF)
        best_i = torch.nn.functional.pad(best_i, pad)
    return best_s, torch.where(best_s <= NEG_INF, -1, best_i)


def topk_candidates_plain(queries, corpus, n_valid: int, kc: int):
    _check_topk(queries, corpus, n_valid, kc)
    return merge_chunk_topk(_score_chunks(queries, corpus, PLAIN_CHUNK_ROWS), n_valid, kc)


def topk_tile_rows(n_valid: int, kc: int) -> int:
    """The tile of the threshold's maxima: the largest power-of-two multiple
    of 256 rows, at most TOPK_TILE_MAX, that leaves TOPK_TILES * kc whole
    tiles below n_valid, else 256."""
    tile = 256
    while 2 * tile <= TOPK_TILE_MAX and n_valid // (2 * tile) >= TOPK_TILES * kc:
        tile *= 2
    return tile


def _decode_keys(keys):
    """(scores fp32, rows int64) of ``topk_sweep.cu::topk_key``'s keys, the
    empty slots NEG_INF / -1."""
    hi = (keys >> 32).to(torch.int32)
    scores = torch.where(hi >= 0, hi, hi ^ 0x7FFFFFFF).view(torch.float32)
    empty = keys == _KEY_EMPTY
    return (torch.where(empty, NEG_INF, scores),
            torch.where(empty, -1, 0xFFFFFFFF - (keys & 0xFFFFFFFF)))


def _topk_sweeps(queries, corpus, n_valid, kc, tile_max, emit):
    """Pass 1 on the score tile (route 0) in its steps, on the queries (cast
    to the corpus dtype) and the corpus, with the sweeps launched by
    ``tile_max(q, rows, tile)`` -> (B, rows // tile) fp32 maxima and
    ``emit(q, theta, cap)`` -> (count (B,) int32, keys (B, cap) int64). The
    threshold theta is the kc-th largest maximum of the wholly valid tiles;
    the emit sweep writes each score >= theta as a key and ``torch.topk``
    over the keys keeps the best kc. Where fewer than kc tiles are whole,
    theta is -inf and every valid row a candidate, each in its own slot (cap
    >= n_valid: no count, no rerun). A query whose count passed ``cap`` is
    swept again with a buffer of its count. Each tile maximum is a row's
    score in the emit sweep's bits, so every query counts at least kc rows;
    one that counts fewer raises. Returns (scores, rows, the queries swept
    again)."""
    B = queries.shape[0]
    tile = topk_tile_rows(n_valid, kc)
    ntiles = n_valid // tile
    if ntiles < kc:
        theta = torch.full((B,), float("-inf"), device=corpus.device)
        _count, keys = emit(queries, theta, max(n_valid, kc))
        return (*_decode_keys(torch.topk(keys, kc, dim=1).values), 0)
    maxima = tile_max(queries, corpus[: ntiles * tile], tile)
    theta = torch.topk(maxima, kc, dim=1).values[:, kc - 1].contiguous()
    cap = TOPK_CAP * kc
    count, keys = emit(queries, theta, cap)
    scores, rows = _decode_keys(torch.topk(keys, kc, dim=1).values)
    count = count.cpu()  # the one sync: the reruns' sizes
    if (count < kc).any():
        raise RuntimeError(f"topk_candidates: the emit sweep counted {count.min()} rows at a "
                           f"threshold {kc} tile maxima reach: the two sweeps' sums differ")
    redo = torch.nonzero(count > cap)[:, 0]
    if len(redo):
        cap_r = int(count[redo].max())
        idx = redo.to(corpus.device)
        count_r, keys_r = emit(queries[idx].contiguous(), theta[idx].contiguous(), cap_r)
        # the same bits: the same counts (below n_valid slots; past them a slot a row)
        if cap_r < n_valid and not torch.equal(count_r.cpu(), count[redo]):
            raise RuntimeError(f"topk_candidates: a rerun counted {count_r.tolist()} rows, "
                               f"the first sweep {count[redo].tolist()}")
        scores[idx], rows[idx] = _decode_keys(torch.topk(keys_r, kc, dim=1).values)
    return scores, rows, len(redo)


def topk_select(queries, kc: int, select):
    """Pass 1 on the wgmma routes (1, 2): ``select(q)`` launches
    ``csrc/topk_sweep.cu``'s one sweep and returns its keys (B, width)
    int64, each part's sorted best kc; ``torch.topk`` over them keeps each
    query's best kc. No host sync, no rerun. Returns (scores, rows)."""
    return _decode_keys(torch.topk(select(queries), kc, dim=1).values)


def topk_candidates_kernel(queries, corpus, n_valid: int, kc: int):
    """Pass 1 on the current CUDA stream, on the design ``dst_topk_route``
    gives the shape: on bf16 rows of even D (routes ``wgmma`` /
    ``wgmma_cp_async``) ``csrc/topk_sweep.cu``'s select sweep, one read of
    the corpus with each part's top kc kept on the card, then ``torch.topk``
    over the parts' keys (:func:`topk_select`); on every other shape
    (``score_tile``) the tile maxima, a threshold and the emit sweep
    (:func:`_topk_sweeps`, which reads the counts back once). ``.launches``
    counts the select and emit sweeps (the score tile's maxima count on
    :func:`tile_max_scores_kernel`), ``.overflow_reruns`` the queries the
    score tile's emit swept again."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    _check_topk(queries, corpus, n_valid, kc)
    q = _kernel_inputs("topk_candidates", queries, corpus)
    if n_valid > 2**31 - 1:
        raise ValueError(f"topk_candidates kernel takes at most 2**31 - 1 rows, got {n_valid}")
    if q.data_ptr() % 16:  # the wgmma routes' queries: 16-byte aligned
        q = q.clone()
    (B, D), N = q.shape, corpus.shape[0]
    if n_valid == 0:
        return (torch.full((B, kc), NEG_INF, device=corpus.device),
                torch.full((B, kc), -1, dtype=torch.int64, device=corpus.device))
    dtype = _KERNEL_DTYPES[corpus.dtype]
    with torch.cuda.device(corpus.device):
        lib = cuda_lib.library()
        stream = torch.cuda.current_stream().cuda_stream
        route = ROUTES[lib.dst_topk_route(q.data_ptr(), corpus.data_ptr(), N, D, dtype)]

        def launched():
            topk_candidates_kernel.launches += 1
            topk_candidates_kernel.launches_by_route[route] += 1

        if route != "score_tile":
            def select(qs):
                width = lib.dst_topk_select_width(N, n_valid, B, D, kc)
                if width < 0:
                    cuda_lib.check(-width, "topk_candidates")
                keys = torch.empty((B, width), dtype=torch.int64, device=corpus.device)
                pub = torch.empty((B, 32), dtype=torch.int64, device=corpus.device)
                cuda_lib.check(lib.dst_topk_select(qs.data_ptr(), corpus.data_ptr(),
                                                   keys.data_ptr(), pub.data_ptr(), B, N,
                                                   n_valid, D, kc, dtype, stream),
                               "topk_candidates")
                launched()
                return keys

            return topk_select(q, kc, select)

        def emit(qs, theta, cap):
            count = torch.empty((qs.shape[0],), dtype=torch.int32, device=corpus.device)
            keys = torch.full((qs.shape[0], cap), _KEY_EMPTY, dtype=torch.int64,
                              device=corpus.device)
            cuda_lib.check(lib.dst_topk_emit(qs.data_ptr(), corpus.data_ptr(), theta.data_ptr(),
                                             count.data_ptr(), keys.data_ptr(), qs.shape[0], N,
                                             n_valid, D, cap, dtype, stream), "topk_candidates")
            launched()
            return count, keys

        scores, rows, reruns = _topk_sweeps(q, corpus, n_valid, kc, tile_max_scores_kernel, emit)
    topk_candidates_kernel.overflow_reruns += reruns
    return scores, rows


topk_candidates_kernel.launches = 0
topk_candidates_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
topk_candidates_kernel.overflow_reruns = 0


def topk_candidates(queries, corpus, n_valid: int, kc: int):
    return _dispatch(
        "topk_candidates", corpus, topk_candidates_kernel, topk_candidates_plain,
        queries, corpus, n_valid, kc,
    )
