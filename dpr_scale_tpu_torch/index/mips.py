"""Exact MIPS engine: verified-exact top-k over embedding blocks on one device.

Counterpart of :class:`dpr_scale_tpu.index.mips.MipsIndex` with its five
unquantised methods: ``"fused"`` (the default), ``"groupmax"``, ``"auto"``,
``"approx"`` and ``"exact_sort"``. The fused pipeline per block:

  1. pass 1: ``kc`` candidates per query from a matmul + ``torch.topk`` over
     ``CHUNK_ROWS``-row chunks. The JAX pass is a dot fused into
     ``lax.approx_max_k`` (a TPU primitive, no Pallas kernel); here it is
     exact, so verification passes more often and the output is the same
     exact top-k. It materialises one ``B x CHUNK_ROWS`` fp32 score tile
     per chunk; a GEMM + top-kc epilogue kernel that keeps the scores on
     chip is queued in ROADMAP.md;
  2. pass 2: exact per-``GROUP_ROWS``-group counts of scores above the k-th
     candidate score (the hand-written count kernel, ``ops.mips_kernels``);
  3. groups whose count exceeds the candidates credited there are rescued
     whole (``RESCUE_GROUPS`` per query, ``RESCUE_PAIRS_PER_QUERY`` pairs per
     batch) and merged exactly; queries beyond that budget fall back to an
     exact host-driven rescan.

``"groupmax"`` is verified-exact in one sweep: the group-max kernel
(``ops.mips_kernels.groupmax``) reduces the scores to the max of every 8-row
group and of every 128 rows; the true top-k lives in the top-k groups by
max, so the selected groups are gathered whole, rescored in fp32 and
re-ranked, and a soundness check sends any query whose selection could have
missed a group to the exact fallback. ``"auto"`` is pass 1 alone followed
by a whole-block count of the scores above the k-th (``ops.mips_kernels.
count_above``), failing queries rescanned exactly. ``"approx"`` is pass 1
with ``max(4k, 128)`` candidates and no verification; the JAX pass is
``lax.approx_max_k`` (recall ~0.994 at k = 100 on the TPU), this one is
exact, so its recall is 1.0. ``"exact_sort"`` is pass 1 at depth k.

The quantised tiers ``"int8"`` and ``"int4"`` quantise each block on the
host as the JAX index does (column equalisation, per-row symmetric int8 or
nibble-packed int4; pad rows get scale 1 and score 0) and the queries on the
device (one or, ``int8_query_planes = 2``, two int8 planes). The sweep is
the integer group-max kernel (``ops.int_kernels.int_groupmax``), followed by
``"groupmax"``'s selection, whole-group rescore and soundness check: the
result is the exact top-k of the dequantised scores. The JAX tiers take the
top-k of a ``lax.approx_max_k`` pool of ``max(8k, 128)`` candidates, which
is exact on the CPU; pass-1 faults cannot hide behind "approximate" here.
The lossy methods (``int8``, ``int4``, ``approx``) take a host exact-rerank
tier (:meth:`MipsIndex.set_rerank`). Host-resident blocks are not ported
(ROADMAP A1).

Blocks are searched one after another and merged on the host
(``merge_topk_batched``); global row ids follow insertion order, and masked
(pad) rows surface as index ``-1``.

Exactness caveat, as in the JAX package: scores are fp32 accumulations of
bf16 inputs, so rows whose scores differ by under ~1 ulp may swap ranks; the
verification is written so such near-ties only add rescue work.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from dpr_scale_tpu_torch.ops.int_kernels import (
    INV127,
    int_groupmax,
    int_rescore,
    int_scores,
    unpack_int4,
)
from dpr_scale_tpu_torch.ops.mips_kernels import (
    GMAX_ROWS,
    GMAX_TIER2,
    GROUP_ROWS,
    count_above,
    count_above_groups,
    groupmax,
)

NEG_INF = -1e30
CHUNK_ROWS = 131072  # pass-1 / exact-scan chunk (scores tile: B x CHUNK fp32)
FUSED_KC = 128  # pass-1 candidates per query
RESCUE_GROUPS = 6  # most-discrepant corpus groups rescued whole per query
RESCUE_PAIRS_PER_QUERY = 2  # gathered (query, group) pairs per batch
COUNT_MARGIN_REL = 2e-5  # candidates are credited only when they clear tau by
# this relative margin: pass 1 and the count kernel sum in different orders,
# so a candidate straddling tau by an ulp must not cancel a genuine miss in
# its group (see dpr_scale_tpu/index/mips.py for the bound)
EXACT_QUERY_CHUNK = 256  # queries per exact-fallback rescan
# groupmax-pipeline tuning (method="groupmax")
GMAX_T1_SLACK = 28  # extra tier-1 groups selected beyond k (tie headroom)
GMAX_T2_SLACK = 16  # extra tier-2 groups beyond the tier-1 selection size
GMAX_RESCORE_QUERIES = 64  # queries whose selected groups are rescored at once
# (fp32 copies of 64 x (k + 28) x 8 rows: 200 MB at k = 100, D = 768)
METHODS = ("fused", "groupmax", "auto", "approx", "exact_sort", "int8", "int4")
QUANTISED = ("int8", "int4")
LOSSY = ("int8", "int4", "approx")  # the methods a rerank tier applies to
UNVERIFIED = ("approx", "exact_sort")  # no verification, no last_repair events


def merge_topk_batched(
    scores: np.ndarray, indices: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-block top-k lists: (num_blocks, B, k) -> (B, k), sorted
    descending."""
    s = np.concatenate(list(scores), axis=1)
    i = np.concatenate(list(indices), axis=1)
    if s.shape[1] > k:
        part = np.argpartition(-s, k - 1, axis=1)[:, :k]
        s = np.take_along_axis(s, part, axis=1)
        i = np.take_along_axis(i, part, axis=1)
    order = np.argsort(-s, kind="stable", axis=1)
    return np.take_along_axis(s, order, axis=1), np.take_along_axis(i, order, axis=1)


@dataclasses.dataclass
class QuantBlock:
    """A quantised block on the device: ``rows`` int8 (n_pad, D) or, packed,
    int4 nibbles (n_pad, D/2); ``row_scales`` (n_pad,) fp32, 1 on pad rows;
    ``col_scales`` (D,) fp32, the column equalisation the queries take."""

    rows: torch.Tensor
    row_scales: torch.Tensor
    col_scales: torch.Tensor
    packed: bool

    @property
    def shape(self) -> Tuple[int, int]:
        return self.rows.shape[0], self.col_scales.shape[0]


class MipsIndex:
    """Inner-product top-k over one or more embedding blocks on ``device``.

    ``add(embeddings)`` appends a block (rows indexed globally in insertion
    order); ``search(queries, k)`` returns global (scores, indices) as numpy.
    ``last_repair`` counts, per search, the (query, block) verification
    failures routed to the exact fallback and the distinct queries repaired
    (methods fused, groupmax, auto, int8 and int4).
    """

    # 2 = int16-precision queries of the quantised tiers as two int8 planes
    # (the corpus is unchanged), as the JAX index's attribute
    int8_query_planes = 1

    def __init__(
        self, device, dtype=torch.bfloat16, method: str = "fused", host_resident: bool = False
    ):
        if host_resident:
            raise NotImplementedError(
                "MipsIndex host_resident is not ported: the host-resident tiers are ROADMAP A1"
            )
        if method not in METHODS:
            raise ValueError(f"unknown MipsIndex method {method!r} (one of {METHODS})")
        self.device = torch.device(device)
        self.dtype = dtype
        self.method = method
        self._blocks: List[Tuple[torch.Tensor, int, int]] = []  # (emb, n_valid, offset)
        self._total_rows = 0
        self._dim: Optional[int] = None
        self.last_repair = {"block_fail_events": 0, "queries_repaired": 0}
        self._repaired_queries: set = set()
        self._rerank_rows = None  # the host exact-rerank tier (set_rerank)
        self.rerank_oversample = 4

    @staticmethod
    def _quantize_int8_host(emb: np.ndarray):
        """Column-equalised per-row symmetric int8: (q8, row_sc, col_sc)."""
        col = np.abs(emb).max(axis=0)
        col[col == 0.0] = 1.0
        x = emb / col[None, :]
        sc = np.abs(x).max(axis=1) / 127.0
        sc[sc == 0.0] = 1.0
        q8 = np.clip(np.rint(x / sc[:, None]), -127, 127).astype(np.int8)
        return q8, sc.astype(np.float32), col.astype(np.float32)

    @staticmethod
    def _quantize_int4_host(emb: np.ndarray):
        """Column-equalised per-row symmetric 4-bit, nibble-packed: (packed
        (N, D/2) int8, row_sc, col_sc). Byte j holds dim j in its low nibble
        and dim j + D/2 in its high nibble; values clip to [-7, 7]."""
        n, d = emb.shape
        if d % 2:
            raise ValueError(f"int4 packing needs an even embedding dim, got {d}")
        col = np.abs(emb).max(axis=0)
        col[col == 0.0] = 1.0
        x = emb / col[None, :]
        sc = np.abs(x).max(axis=1) / 7.0
        sc[sc == 0.0] = 1.0
        q4 = np.clip(np.rint(x / sc[:, None]), -7, 7).astype(np.int8)
        lo = q4[:, : d // 2].view(np.uint8) & 0xF
        hi = q4[:, d // 2 :].view(np.uint8) & 0xF
        packed = ((hi << 4) | lo).view(np.int8)
        return np.ascontiguousarray(packed), sc.astype(np.float32), col.astype(np.float32)

    _unpack_int4 = staticmethod(unpack_int4)

    def set_rerank(self, rows_fn, oversample: int = 4) -> None:
        """Attach a host exact-rerank tier to the lossy methods (``int8`` /
        ``int4`` / ``approx``): ``rows_fn(ids (M,) int64) -> (M, D) fp32``
        returns the original rows of global row ids (e.g. a
        ``ShardRowReader``). ``search`` then fetches ``oversample * k``
        device candidates and rescores them exactly on the host. ``None``
        detaches it."""
        self._rerank_rows = rows_fn
        self.rerank_oversample = int(oversample)

    @staticmethod
    def _pad_rows(n: int) -> int:
        """Round up to a GROUP_ROWS multiple (CHUNK_ROWS above one chunk), so
        every block splits into whole rescue groups: a block whose rows were
        one group would rescue (B, n_pad, D) rows a batch."""
        base = GROUP_ROWS
        n_pad = (n + base - 1) // base * base
        if n_pad > CHUNK_ROWS:
            n_pad = (n + CHUNK_ROWS - 1) // CHUNK_ROWS * CHUNK_ROWS
        return n_pad

    def add(self, embeddings) -> None:
        """Append a (n, D) block (numpy or tensor); pad rows are zero (the
        quantised tiers: quantised on the host, pad rows of scale 1)."""
        n, d = embeddings.shape
        if self._dim is None:
            self._dim = d
        if d != self._dim:
            raise ValueError(f"embedding dim {d} != the index's {self._dim}")
        if self.method in QUANTISED:
            block = self._quantize_block(embeddings, self._pad_rows(n))
        else:
            if not isinstance(embeddings, torch.Tensor):  # torch needs writable arrays
                embeddings = torch.from_numpy(np.require(embeddings, requirements="W"))
            block = torch.zeros((self._pad_rows(n), d), dtype=self.dtype, device=self.device)
            block[:n] = embeddings.to(self.device, self.dtype)
        self._blocks.append((block, n, self._total_rows))
        self._total_rows += n

    def _quantize_block(self, embeddings, n_pad: int) -> QuantBlock:
        """The JAX ``add``'s host quantisation of the zero-padded fp32 block
        (several fp32 copies of it at once, as there)."""
        if isinstance(embeddings, torch.Tensor):
            embeddings = embeddings.detach().float().cpu().numpy()
        emb = np.zeros((n_pad, embeddings.shape[1]), np.float32)
        emb[: embeddings.shape[0]] = embeddings
        packed = self.method == "int4"
        quant = self._quantize_int4_host if packed else self._quantize_int8_host
        rows, row_sc, col_sc = (torch.from_numpy(a).to(self.device) for a in quant(emb))
        return QuantBlock(rows, row_sc, col_sc, packed)

    @property
    def num_rows(self) -> int:
        return self._total_rows

    # ------------------------------------------------------------------ #

    def _score_chunks(self, q, emb):
        """(lo, hi, fp32 scores (B, hi - lo)) of a block's rows, CHUNK_ROWS
        at a time: fp32 sums of the fp32-upcast inputs (bf16 products are
        exact in fp32, so this is the fp32 accumulation the count kernel
        uses), or a quantised block's dequantised scores (the arithmetic of
        the int kernels' plain versions)."""
        if isinstance(emb, QuantBlock):
            planes = int(self.int8_query_planes)
            q8, qsc = self._quantize_queries(q, emb.col_scales, planes)
            for lo in range(0, emb.shape[0], CHUNK_ROWS):
                hi = min(lo + CHUNK_ROWS, emb.shape[0])
                yield lo, hi, int_scores(q8, emb.rows[lo:hi], emb.row_scales[lo:hi], qsc,
                                         packed=emb.packed, planes=planes)
            return
        qd = q.to(self.dtype).float()
        for lo in range(0, emb.shape[0], CHUNK_ROWS):
            hi = min(lo + CHUNK_ROWS, emb.shape[0])
            yield lo, hi, torch.matmul(qd, emb[lo:hi].float().T)

    def _topk_rows(self, q, emb, k, n_valid):
        """Exact top-k (scores, rows) per query over one block, chunk by
        chunk; rows >= n_valid (pads) score NEG_INF."""
        B = q.shape[0]
        best_s = torch.full((B, 0), NEG_INF, device=q.device)
        best_i = torch.zeros((B, 0), dtype=torch.int64, device=q.device)
        for lo, hi, s in self._score_chunks(q, emb):
            if hi > n_valid:
                s[:, max(n_valid - lo, 0) :] = NEG_INF
            ts, ti = torch.topk(s, min(k, hi - lo), dim=1)
            merged_s = torch.cat([best_s, ts], 1)
            best_s, pos = torch.topk(merged_s, min(k, merged_s.shape[1]), dim=1)
            best_i = torch.gather(torch.cat([best_i, ti + lo], 1), 1, pos)
        return best_s, best_i

    def _exact_topk(self, emb, n_valid, q, k):
        """Exact top-k of one block; masked rows surface as -1."""
        s, i = self._topk_rows(q, emb, k, n_valid)
        return s, torch.where(s <= NEG_INF, -1, i)

    def _candidates(self, qd, emb, kc, n_valid):
        """Pass 1 of the fused, auto and approx searches: kc candidates per
        query (exact here, approximate on the TPU)."""
        return self._topk_rows(qd, emb, kc, n_valid)

    def _fused_search(self, emb, q, k, n_valid):
        """Verified-exact search of one block. Returns (scores (B, k),
        indices (B, k), not_exact (B,) bool) on the device."""
        n_pad, D = emb.shape
        B = q.shape[0]
        dev = q.device
        group = GROUP_ROWS  # _pad_rows makes every block a multiple of it
        ngroups = n_pad // group
        kc = min(max(FUSED_KC, k), n_pad)
        qd = q.to(self.dtype)

        # ---- pass 1: kc candidates per query, pad rows masked ----
        cand_s, cand_i = self._candidates(qd, emb, kc, n_valid)
        tau = torch.topk(cand_s, k, dim=1).values[:, k - 1]

        # ---- pass 2: exact per-group counts of scores > tau ----
        cnt = count_above_groups(qd, emb, tau, group)  # (B, ngroups) int32
        # pad rows score exactly 0: subtract their analytic contribution
        g_starts = np.arange(ngroups, dtype=np.int64) * group
        pad_counts = np.clip(
            np.minimum(g_starts + group, n_pad) - np.maximum(g_starts, n_valid), 0, group
        )
        pad_counts = torch.as_tensor(pad_counts, dtype=torch.int32, device=dev)
        cnt = cnt - torch.where(tau[:, None] < 0.0, pad_counts[None, :], 0)

        # ---- verification: true per-group counts vs margin-credited
        # candidates (COUNT_MARGIN_REL) ----
        gid = cand_i // group  # (B, kc)
        tau_hi = tau + COUNT_MARGIN_REL * tau.abs()
        above = (cand_s > tau_hi[:, None]).to(torch.int32)
        found = torch.zeros((B, ngroups), dtype=torch.int32, device=dev)
        found.scatter_add_(1, gid, above)
        diff = (cnt - found).clamp_min(0)  # missed elements per group

        # ---- rescue: the P most-discrepant groups per query, whole ----
        P_sel = min(RESCUE_GROUPS, ngroups)
        dwork = diff.clone()
        sel_g, sel_v = [], []
        for _ in range(P_sel):  # iterative argmax: cheap vs sorting all groups
            g = torch.argmax(dwork, dim=1)
            v = torch.gather(dwork, 1, g[:, None])[:, 0]
            sel_g.append(g)
            sel_v.append(v)
            dwork.scatter_(1, g[:, None], -1)
        sel_g = torch.stack(sel_g, dim=1)  # (B, P) distinct groups
        sel_v = torch.stack(sel_v, dim=1)

        # compact to the (query, group) pairs that need rescuing, at most R
        R = min(max(1024, RESCUE_PAIRS_PER_QUERY * B), B * P_sel)
        flat_v = sel_v.reshape(-1)
        pos_idx = torch.nonzero(flat_v > 0)[:, 0][:R]
        pair_q = pos_idx // P_sel
        pair_p = pos_idx % P_sel
        pair_g = sel_g.reshape(-1)[pos_idx]
        tiles = emb.view(ngroups, group, D)[pair_g]  # (R', group, D)
        rs_pairs = torch.bmm(tiles.float(), qd[pair_q].float()[:, :, None])[:, :, 0]
        pair_rows = pair_g[:, None] * group + torch.arange(group, device=dev)[None, :]
        rs_pairs = torch.where(pair_rows < n_valid, rs_pairs, NEG_INF)
        rs = torch.full((B, P_sel, group), NEG_INF, device=dev)
        rs[pair_q, pair_p] = rs_pairs
        row_global = sel_g[:, :, None] * group + torch.arange(group, device=dev)[None, None, :]

        # exactness: every discrepant group selected AND rescued
        covered_q = torch.zeros((B,), dtype=torch.int32, device=dev)
        covered_q.index_add_(0, pair_q, flat_v[pos_idx])
        not_exact = diff.sum(dim=1) > covered_q

        # drop candidates that live in rescued groups (the rescue holds them)
        sel_rescued = torch.where(sel_v > 0, sel_g, -1)
        in_sel = (gid[:, :, None] == sel_rescued[:, None, :]).any(dim=2)
        cand_s = torch.where(in_sel, NEG_INF, cand_s)

        all_s = torch.cat([cand_s, rs.view(B, P_sel * group)], dim=1)
        all_i = torch.cat([cand_i, row_global.view(B, P_sel * group)], dim=1)
        fs, fpos = torch.topk(all_s, k, dim=1)
        fi = torch.gather(all_i, 1, fpos)
        fi = torch.where(fs <= NEG_INF, -1, fi)  # pad/masked rows -> -1
        return fs, fi, not_exact

    def _exact_fallback(self, emb, n_valid, queries, k, fail_idx):
        """Exact rescan for the queries whose verification failed."""
        out_s, out_i = [], []
        for lo in range(0, len(fail_idx), EXACT_QUERY_CHUNK):
            idx = torch.as_tensor(fail_idx[lo : lo + EXACT_QUERY_CHUNK], device=queries.device)
            s, i = self._exact_topk(emb, n_valid, queries[idx], k)
            out_s.append(s.cpu().numpy())
            out_i.append(i.cpu().numpy())
        return np.concatenate(out_s), np.concatenate(out_i)

    def _groupmax_search(self, emb, q, k, n_valid):
        """Verified-exact search of one block in one sweep (the JAX
        ``_groupmax_search_impl`` step for step); same contract as
        :meth:`_fused_search`."""
        D = emb.shape[1]
        qd = q.to(self.dtype)
        t1, t2 = groupmax(qd, emb)  # (ng, B), (n2, B) fp32
        groups = emb.view(-1, GMAX_ROWS, D)

        def rescore(lo, hi, sel1):
            # fp32 sums of the exact (fp32) products of the bf16 inputs,
            # never rounded to bf16
            tiles = groups[sel1].view(hi - lo, -1, D).float()
            return torch.bmm(tiles, qd[lo:hi].float()[:, :, None])[:, :, 0]

        return self._select_groups(t1, t2, k, n_valid, rescore)

    @staticmethod
    def _quantize_queries(q, col, planes: int):
        """Per-query symmetric int8 on the device, the JAX search's (``q8
        (planes * B, D)``, ``qsc (B,)``): ``q * col``, ``qsc = max|q| / 127``
        (0 -> 1), ``hi = clip(rint(q / qsc))`` and, two planes, ``lo =
        clip(rint((q / qsc - hi) * 127))`` after it. XLA rewrites the division
        by the constant 127 as a product with float32(1/127); so does this."""
        q = q * col[None, :]
        qsc = q.abs().amax(dim=1) * INV127
        qsc = torch.where(qsc == 0.0, torch.ones_like(qsc), qsc)
        qn = q / qsc[:, None]
        q8 = torch.round(qn).clamp(-127, 127)
        if planes == 2:
            q8 = torch.cat([q8, torch.round((qn - q8) * 127.0).clamp(-127, 127)])
        return q8.to(torch.int8), qsc

    def _int_search(self, emb: QuantBlock, q, k, n_valid):
        """Exact top-k of the dequantised scores of a quantised block: the
        integer group-max sweep, then :meth:`_select_groups` with the same
        integer dot and scaling for the rescore. Same contract as
        :meth:`_fused_search`."""
        planes = int(self.int8_query_planes)
        B = q.shape[0]
        q8, qsc = self._quantize_queries(q, emb.col_scales, planes)
        t1, _ = int_groupmax(q8, emb.rows, emb.row_scales, qsc, packed=emb.packed,
                             planes=planes, want_rows=False)  # (ng, B): 512 MB at B = 512, 2M rows
        groups = emb.rows.view(-1, GMAX_ROWS, emb.rows.shape[1])
        group_sc = emb.row_scales.view(-1, GMAX_ROWS)
        q8 = q8.view(planes, B, -1)

        def rescore(lo, hi, sel1):
            n = hi - lo
            return int_rescore(q8[:, lo:hi].reshape(planes * n, -1),
                               groups[sel1].view(n, -1, groups.shape[2]),
                               group_sc[sel1].view(n, -1), qsc[lo:hi],
                               packed=emb.packed, planes=planes)

        return self._select_groups(t1, None, k, n_valid, rescore)

    def _select_groups(self, t1, t2, k, n_valid, rescore):
        """The exact selection behind a group-max sweep. ``t1`` (ng, B): the
        max score of each GMAX_ROWS-row group; ``t2`` (ng / GMAX_TIER2, B)
        the max of GMAX_TIER2 of them, or None to take it from ``t1``;
        ``rescore(lo, hi, sel1 (hi - lo, T1))``: fp32 scores (hi - lo, T1 *
        GMAX_ROWS) of the selected groups' rows for queries [lo, hi), in the
        sweep's arithmetic. Returns (scores (B, k), indices (B, k),
        not_exact (B,) bool) on the device."""
        ng, B = t1.shape
        dev = t1.device
        n2 = ng // GMAX_TIER2
        T1 = min(k + GMAX_T1_SLACK, ng)
        T2 = min(T1 + GMAX_T2_SLACK, n2)
        # pad rows score exactly 0 and would outrank real negatives: mask the
        # groups past the valid span (the one partly valid group keeps its
        # 0-inflated max; the soundness check absorbs it)
        t1[(n_valid + GMAX_ROWS - 1) // GMAX_ROWS :] = NEG_INF
        if t2 is None:
            t2 = t1.view(n2, GMAX_TIER2, B).amax(dim=1)
        else:
            t2[(n_valid + GMAX_ROWS * GMAX_TIER2 - 1) // (GMAX_ROWS * GMAX_TIER2) :] = NEG_INF

        # selection: the top-T2 tier-2 groups, then the top-T1 tier-1 groups
        # among their children (the top-T1 tier-1 groups lie inside them)
        sel2 = torch.topk(t2.T, T2, dim=1).indices  # (B, T2)
        cand1 = (sel2[:, :, None] * GMAX_TIER2 + torch.arange(GMAX_TIER2, device=dev)).reshape(
            B, T2 * GMAX_TIER2
        )
        v1, pos1 = torch.topk(torch.gather(t1.T, 1, cand1), T1, dim=1)  # (B, T1)
        sel1 = torch.gather(cand1, 1, pos1)

        # gather the selected groups whole and rescore them
        rs = torch.empty((B, T1 * GMAX_ROWS), dtype=torch.float32, device=dev)
        for lo in range(0, B, GMAX_RESCORE_QUERIES):
            hi = min(lo + GMAX_RESCORE_QUERIES, B)
            rs[lo:hi] = rescore(lo, hi, sel1[lo:hi])
        rows = (sel1[:, :, None] * GMAX_ROWS + torch.arange(GMAX_ROWS, device=dev)).view(B, -1)
        rs = torch.where(rows < n_valid, rs, NEG_INF)
        ls, lpos = torch.topk(rs, min(k, T1 * GMAX_ROWS), dim=1)
        li = torch.gather(rows, 1, lpos)

        # soundness: every group whose sweep max strictly beats the k-th
        # rescored score must be among the selected (ties at tau are
        # arbitrary, as in FAISS); sweep maxima on both sides
        tau = ls[:, -1]
        cnt_all = (t1 > tau[None, :]).sum(dim=0)
        cnt_sel = (v1 > tau[:, None]).sum(dim=1)
        li = torch.where(ls <= NEG_INF, -1, li)  # pad/masked rows -> -1
        return ls, li, cnt_all > cnt_sel

    def _count_above(self, emb, n_valid, qd, tau):
        """Per query, the block's rows scoring above ``tau``. The pad rows
        score exactly 0: their count is subtracted where tau < 0 instead of
        masking the sweep."""
        cnt = count_above(qd, emb, tau)
        return cnt - torch.where(tau < 0.0, emb.shape[0] - n_valid, 0).to(cnt.dtype)

    def _auto_search(self, emb, q, k, n_valid):
        """Pass 1 at depth k, verified by a whole-block count of the scores
        above the k-th: exact iff that count equals the candidates above it
        (credited with the COUNT_MARGIN_REL margin)."""
        qd = q.to(self.dtype)
        s, i = self._candidates(qd, emb, k, n_valid)
        tau = s[:, k - 1]
        cnt = self._count_above(emb, n_valid, qd, tau)
        found = (s > (tau + COUNT_MARGIN_REL * tau.abs())[:, None]).sum(dim=1)
        return s, torch.where(s <= NEG_INF, -1, i), cnt != found

    def _approx_search(self, emb, q, k, n_valid):
        """Pass 1 with max(4k, FUSED_KC) candidates, unverified."""
        kc = min(max(4 * k, FUSED_KC), emb.shape[0])
        cand_s, cand_i = self._candidates(q.to(self.dtype), emb, kc, n_valid)
        s, pos = torch.topk(cand_s, k, dim=1)
        return s, torch.where(s <= NEG_INF, -1, torch.gather(cand_i, 1, pos))

    def _device_search(self, emb, q, k, n_valid):
        """One block by ``self.method``: (scores (B, k), indices (B, k),
        not_exact (B,) bool), all on the device."""
        if self.method == "fused":
            return self._fused_search(emb, q, k, n_valid)
        if self.method == "groupmax":
            return self._groupmax_search(emb, q, k, n_valid)
        if self.method in QUANTISED:
            return self._int_search(emb, q, k, n_valid)
        if self.method == "auto":
            return self._auto_search(emb, q, k, n_valid)
        if self.method == "approx":
            s, i = self._approx_search(emb, q, k, n_valid)
        else:
            s, i = self._exact_topk(emb, n_valid, q, k)
        return s, i, torch.zeros((q.shape[0],), dtype=torch.bool, device=q.device)

    def _search_block(self, emb, n_valid, q, k):
        s, i, not_exact = self._device_search(emb, q, k, n_valid)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        if self.method in UNVERIFIED:
            return s, i
        fail_idx = np.nonzero(not_exact.cpu().numpy())[0]
        # fail events count once per (query, block); queries_repaired stays
        # distinct queries across the blocks of one search
        self.last_repair["block_fail_events"] += len(fail_idx)
        self._repaired_queries.update(int(x) for x in fail_idx)
        self.last_repair["queries_repaired"] = len(self._repaired_queries)
        if len(fail_idx):  # verification failed: exact rescan
            s[fail_idx], i[fail_idx] = self._exact_fallback(emb, n_valid, q, k, fail_idx)
        return s, i

    def benchmark(self, queries_batches, k: int = 100) -> dict:
        """Throughput of ``self.method`` over the index's single block, the
        JAX ``MipsIndex.benchmark`` contract: ``queries_batches`` (iters, B,
        D). Phase 1 searches every batch with the results left on the
        device and one sync at the end (the fail flags); phase 2 rescans the
        failing queries exactly. The time covers both phases, after one
        untimed warm-up of each."""
        import time

        if len(self._blocks) != 1:
            raise ValueError(f"benchmark expects a single block, the index has {len(self._blocks)}")
        emb, n_valid, _off = self._blocks[0]
        k = min(k, emb.shape[0])
        iters, B, D = queries_batches.shape

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        with torch.inference_mode():
            qs = torch.as_tensor(queries_batches).to(self.device, torch.float32)

            def phase1():
                fails = [self._device_search(emb, q, k, n_valid)[2] for q in qs]
                return torch.stack(fails).reshape(-1).cpu().numpy()  # the one sync

            def phase2(fails):
                idx = np.nonzero(fails)[0]
                if len(idx):
                    self._exact_fallback(emb, n_valid, qs.reshape(-1, D), k, idx)
                sync()

            phase2(phase1())  # warm-up: allocator growth, kernel build
            t0 = time.perf_counter()
            fails = phase1()
            t1 = time.perf_counter()
            phase2(fails)
            dt = time.perf_counter() - t0
        return {
            "seconds": dt,
            "phase1_seconds": t1 - t0,
            "qps": iters * B / dt,
            # exact by construction after phase 2, except the lossy serving
            # modes (the quantised ones are exact only over their
            # dequantised scores)
            "all_exact": self.method not in LOSSY,
            "fallback_queries": int(fails.sum()),
            "iters": iters,
            "batch": B,
        }

    def search(self, queries, k: int = 100) -> Tuple[np.ndarray, np.ndarray]:
        """Global top-k over all blocks. ``queries``: (B, D) numpy array or
        tensor (a device tensor never leaves the device, unless a rerank
        tier rescores on the host). Returns numpy (scores (B, k) fp32,
        indices (B, k) int64)."""
        if not self._blocks:
            raise ValueError("index is empty")
        self.last_repair = {"block_fail_events": 0, "queries_repaired": 0}
        self._repaired_queries = set()
        k_eff = min(k, self._total_rows)
        with torch.inference_mode():
            q = torch.as_tensor(queries).to(self.device, torch.float32)
            if self._rerank_rows is None or self.method not in LOSSY:
                return self._per_block_host_merge(q, k_eff)
            # the host exact-rerank tier: over-fetch device candidates, then
            # rescore them against the original rows (set_rerank)
            s, i = self._per_block_host_merge(q, min(self.rerank_oversample * k, self._total_rows))
        return self._host_rerank(q.cpu().numpy(), s, i, k_eff)

    def _host_rerank(self, queries, cand_s, cand_i, k):
        """Exact fp32 rescore of the device candidates against the original
        rows; the JAX ``_host_rerank`` line for line."""
        uniq, inv = np.unique(cand_i, return_inverse=True)
        valid_from = 1 if uniq.size and uniq[0] < 0 else 0
        rows = np.zeros((uniq.size, queries.shape[1]), np.float32)
        if uniq.size > valid_from:
            rows[valid_from:] = self._rerank_rows(uniq[valid_from:])
        # (B, k_deep) exact scores, -1 candidates -inf; chunked over queries
        # so the (chunk, k_deep, D) row gather stays small
        inv2 = inv.reshape(cand_i.shape)
        es = np.empty(cand_i.shape, np.float32)
        for lo in range(0, queries.shape[0], 64):
            hi = min(lo + 64, queries.shape[0])
            es[lo:hi] = np.einsum("bd,bkd->bk", queries[lo:hi], rows[inv2[lo:hi]], optimize=True)
        es = np.where(cand_i < 0, -np.inf, es)
        part = np.argpartition(-es, min(k, es.shape[1]) - 1, axis=1)[:, :k]
        ps = np.take_along_axis(es, part, axis=1)
        pi = np.take_along_axis(cand_i, part, axis=1)
        order = np.argsort(-ps, kind="stable", axis=1)
        return np.take_along_axis(ps, order, axis=1), np.take_along_axis(pi, order, axis=1)

    def _per_block_host_merge(self, q, k_eff):
        per_block_s, per_block_i = [], []
        for emb, n_valid, offset in self._blocks:
            k_block = min(k_eff, emb.shape[0])
            s, i = self._search_block(emb, n_valid, q, k_block)
            i = i.astype(np.int64)
            i[i >= 0] += offset  # -1 = masked pad rows (rows_to_ctxs skips)
            if k_block < k_eff:  # pad so merge shapes agree
                pad = k_eff - k_block
                s = np.pad(s, ((0, 0), (0, pad)), constant_values=-np.inf)
                i = np.pad(i, ((0, 0), (0, pad)), constant_values=-1)
            per_block_s.append(s)
            per_block_i.append(i)
        if len(per_block_s) == 1:
            return per_block_s[0], per_block_i[0]
        return merge_topk_batched(np.stack(per_block_s), np.stack(per_block_i), k_eff)
