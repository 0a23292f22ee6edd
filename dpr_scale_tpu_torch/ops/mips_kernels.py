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
  ``tile``-row corpus tile, N % tile == 0 (``csrc/mips_scan.cu``; no caller
  in either package).

Each comes as ``<name>_plain`` (plain PyTorch: the CPU path and the oracle,
scores materialise chunk by chunk), ``<name>_kernel`` (the hand-written CUDA
kernel, bf16 or fp32, scores never reach memory; ``.launches`` counts its
launches) and ``<name>`` (dispatch: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises).
"""
from __future__ import annotations

import torch

GROUP_ROWS = 256  # rescue granularity of the fused pipeline
GMAX_ROWS = 8  # corpus rows per tier-1 max group (selection granularity)
GMAX_TIER2 = 16  # tier-1 groups per tier-2 group (128 rows)
TILE_ROWS = 4096  # corpus rows per tile_max_scores tile
PLAIN_CHUNK_ROWS = 131072  # rows of fp32 scores the plain versions hold at once

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


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
    with torch.cuda.device(corpus.device):
        rc = cuda_lib.library().dst_count_above_groups(
            q.data_ptr(), corpus.data_ptr(), tau.data_ptr(), out.data_ptr(),
            B, N, D, group, _KERNEL_DTYPES[corpus.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "count_above_groups")
    count_above_groups_kernel.launches += 1
    return out


count_above_groups_kernel.launches = 0


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
    with torch.cuda.device(corpus.device):
        rc = cuda_lib.library().dst_count_above(
            q.data_ptr(), corpus.data_ptr(), tau.data_ptr(), out.data_ptr(),
            B, N, D, _KERNEL_DTYPES[corpus.dtype], torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "count_above")
    count_above_kernel.launches += 1
    return out


count_above_kernel.launches = 0


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
    with torch.cuda.device(corpus.device):
        rc = cuda_lib.library().dst_groupmax(
            q.data_ptr(), corpus.data_ptr(), t1.data_ptr(), t2.data_ptr(),
            B, N, D, _KERNEL_DTYPES[corpus.dtype], torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "groupmax")
    groupmax_kernel.launches += 1
    return t1, t2


groupmax_kernel.launches = 0


def groupmax(queries, corpus):
    return _dispatch("groupmax", corpus, groupmax_kernel, groupmax_plain, queries, corpus)


# --------------------------------------------------------------------- #
# per-tile maxima (no caller: the building block of blocked max pruning)


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
    with torch.cuda.device(corpus.device):
        rc = cuda_lib.library().dst_tile_max(
            q.data_ptr(), corpus.data_ptr(), out.data_ptr(), B, N, D, tile,
            _KERNEL_DTYPES[corpus.dtype], torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "tile_max_scores")
    tile_max_scores_kernel.launches += 1
    return out


tile_max_scores_kernel.launches = 0


def tile_max_scores(queries, corpus, tile: int = TILE_ROWS):
    return _dispatch(
        "tile_max_scores", corpus, tile_max_scores_kernel, tile_max_scores_plain,
        queries, corpus, tile,
    )
