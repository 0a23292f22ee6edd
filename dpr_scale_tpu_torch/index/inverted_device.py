"""Device-resident CITADEL/COIL inverted-index search on one device or,
expert-parallel, over a list of devices.

Counterpart of :mod:`dpr_scale_tpu.index.inverted_device`, the device search
over the posting lists of
:class:`dpr_scale_tpu_torch.index.inverted.InvertedExpertIndex`:

  * experts are grouped into LENGTH BUCKETS (posting counts padded to the
    next bucket size): ``vecs: (experts_b, L_b, D)`` in the index dtype,
    ``run_id: (experts_b, L_b)`` (per-expert doc-run segmentation, postings
    sorted by doc) and the RUN-COMPACT emission layout ``run_doc`` /
    ``start_pos: (experts_b, R_b)`` (one update per unique doc per expert);
  * a query batch's routed (expert, weighted vector) entries are grouped by
    bucket on the host, and each bucket is scored on the device: a posting
    gather-score kernel (:mod:`dpr_scale_tpu_torch.ops.gather_score`) gives
    (E, L) fp32 scores, a doubling suffix-max over the doc-sorted rows gives
    each run's max (the MaxSim inner max) with the training objective's zero
    floor, emitting flat (row, doc, value) updates;
  * the combine: with a CLS plane, or below ``sorted_combine_min_docs``, a
    dense fp32 accumulator over the docs (the CLS GEMM writes it, one
    ``index_add_`` adds every bucket's updates) and a tiled exact top-k;
    without one on a large corpus, a sort-based combine whose cost scales
    with the updates.

The scorer per bucket follows the JAX package's decisions: the streamed
kernel when ``STREAM_MODE`` is "on", or "auto" and the byte model says so;
otherwise the serial kernel, or the pipelined one with
``DPR_GATHER_KERNEL=pipelined``. The TPU gate ``D % 128 == 0`` (its 128-lane
tiling) is gone: the kernels take any D.

The index lives on a list of devices (``mesh``,
:func:`parallel.mesh.get_mesh`; one device is a list of one), and is
EXPERT-PARALLEL over more than one (the JAX class docstring,
inverted_device.py:214-229): each bucket's expert axis is padded to a
multiple of ndev x the streamed group and cut into ndev contiguous blocks,
shard ``i`` holding experts ``[i * epd, (i + 1) * epd)``; the CLS plane is
padded to the accumulator's column grid (:meth:`_tiles`) and cut by doc
rows. The routing tables keep global slots (a slot's shard is ``slot //
epd``). A search routes on the host, gives each shard only its own entries
(padded to nothing: there is no SPMD shape to share) and scores them there.
The dense combine sends every shard's updates to every device, each adds
those of its own column shard into a (B, NT / ndev) accumulator over its
CLS slice, and per-shard tile maxima pick the top tiles (the JAX program's,
:meth:`_combine_dense`), so the accumulator and the CLS plane split ndev
ways; the sorted combine runs on the first device. Nothing between the
launches waits on a device (no ``.item()``, ``nonzero`` or boolean index):
the host only queues work, uploads from pinned memory before the first
launch, and fetches once at the end. Tensors move with ``Tensor.to(device,
non_blocking=True)``: one process drives every device.

Where JAX's scatter ``mode="drop"`` silently dropped pad entries (row B)
and pure-pad runs (the trash column num_docs), torch would raise or
device-assert: both combines keep those updates off the accumulator, and
the streamed layout's pad slot is clamped for the ``run_id`` / ``run_doc``
gathers (its scores are 0).
"""
from __future__ import annotations

import collections
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.ops import gather_score

BUCKET_SIZES = (128, 512, 2048, 8192, 32768, 131072)


def _bucket_for(n: int) -> int:
    for b in BUCKET_SIZES:
        if n <= b:
            return b
    return BUCKET_SIZES[-1]


# The scorer decision, kept equal to the JAX package's so both pick the same
# scorer per bucket (constants and helpers as in
# dpr_scale_tpu/index/inverted_device.py:51-173, where their TPU
# measurements are recorded): entries per stream window / target bytes per
# streamed posting block
STREAM_M = 32
STREAM_CHUNK = 2 * 1024 * 1024

# "auto" picks PER BUCKET per search by the byte model; "on" streams every
# bucket; "off" never streams
STREAM_MODE = "auto"
STREAM_BW_RATIO = 2.2
STREAM_MIN_GROUP = 8


def _stream_group_target(L: int, D: int, itemsize: int) -> int:
    """Experts per posting-group so one (G, L, D) block is ~STREAM_CHUNK
    bytes (1 when a single expert's postings already exceed the chunk).
    ``from_host_index`` pads each bucket's expert axis to a multiple of
    this, as the JAX package does."""
    if L * D * itemsize >= STREAM_CHUNK:
        return 1
    return max(1, STREAM_CHUNK // (L * D * itemsize))


def _stream_cfg(n_exp: int, L: int, D: int, itemsize: int) -> Tuple[int, int]:
    """(G, TL): experts per posting-group and L-tile of the byte model."""
    if L * D * itemsize >= STREAM_CHUNK:
        target = max(8, STREAM_CHUNK // (D * itemsize))
        TL = 1 << (target.bit_length() - 1)
        while L % TL:
            TL //= 2
        assert TL >= 8 and L % TL == 0, (L, D, itemsize, TL)
        return 1, TL
    G = min(_stream_group_target(L, D, itemsize), n_exp)
    while n_exp % G:
        G -= 1
    return G, L


def _pad_2bit(n: int, minimum: int = 1, multiple: int = 1) -> int:
    """Round ``n`` up to a two-significant-bit value (m * 2^e, m in
    {2, 3}), at least ``minimum``, then to a multiple of ``multiple``."""
    n = max(n, minimum, 1)
    e = max((n - 1).bit_length() - 2, 0)
    g = 1 << e
    v = -(-n // g) * g
    return -(-v // multiple) * multiple


def _stream_shape_ok(n_exp: int, bsize: int, D: int, itemsize: int) -> bool:
    """Shape gate for STREAM_MODE="auto": only shapes where >=
    STREAM_MIN_GROUP experts pack into one streamed block."""
    G, _ = _stream_cfg(n_exp, bsize, D, itemsize)
    return G >= STREAM_MIN_GROUP


def _stream_auto_wins(
    steps_b, G: int, TL: int, bsize: int, D: int, itemsize: int, n: int
) -> bool:
    """Per-bucket byte model for STREAM_MODE="auto": stream when the
    distinct posting groups' bytes are under STREAM_BW_RATIO x the padded
    per-entry gather's bytes. ``steps_b[:, 0]`` is the posting-group
    sequence the streamed scorer walks."""
    pg = steps_b[:, 0]
    distinct = int(1 + (pg[1:] != pg[:-1]).sum()) * (bsize // TL)
    stream_bytes = distinct * G * TL * D * itemsize
    gather_bytes = _pad_2bit(n, minimum=8) * bsize * D * itemsize
    return stream_bytes <= STREAM_BW_RATIO * gather_bytes


def _choose_stream(slots_b: np.ndarray, n_exp: int, bsize: int, D: int, itemsize: int,
                   capable: bool) -> bool:
    """The JAX package's per-bucket choice (inverted_device.py:1183-1203).

    Its byte model counts the transitions of the posting-group column of
    the TPU step table built from the slot-sorted entries; that column is
    the entries' posting groups, non-decreasing, with empty and pad steps
    repeating the last one, so its transitions are those of the distinct
    groups: the table itself is not built."""
    if not capable or STREAM_MODE == "off":
        return False
    if STREAM_MODE != "auto":
        return True
    if not _stream_shape_ok(n_exp, bsize, D, itemsize):
        return False
    G, TL = _stream_cfg(n_exp, bsize, D, itemsize)
    groups = np.unique(np.asarray(slots_b) // G)[:, None]
    return _stream_auto_wins(groups, G, TL, bsize, D, itemsize, len(slots_b))


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TILE = 2048  # accumulator columns per tile of the tiled exact top-k


def _tiled_topk(accs, k: int, device):
    """Exact per-row top-k of an accumulator cut into column shards:
    ``accs[i]`` is device i's (B, nt_l, TILE) block, the columns ``[i *
    nt_l * TILE, (i + 1) * nt_l * TILE)``. Per-tile maxima, one top-k over
    the (B, nt) maxima on ``device`` (a tile holding a top-k element has a
    max at least as large), each chosen tile's columns from the shard that
    owns it, then the top-k of those (the JAX package's tiled top-k,
    inverted_device.py:815-856 and 994-1027). One streaming read of the
    accumulator plus a (B, k * TILE) gather; (scores, columns) on
    ``device``."""
    batch, nt_l, _ = accs[0].shape
    tmax = torch.cat([a.amax(dim=2).to(device, non_blocking=True) for a in accs], dim=1)
    tidx = torch.topk(tmax, min(k, tmax.shape[1]), dim=1).indices  # (B, kt)
    owner = tidx // nt_l
    cand = None
    for i, acc in enumerate(accs):
        local = torch.where(owner == i, tidx % nt_l, 0).to(acc.device, non_blocking=True)
        got = acc.gather(1, local[:, :, None].expand(-1, -1, TILE)).to(device, non_blocking=True)
        cand = got if cand is None else torch.where((owner == i)[:, :, None], got, cand)
    cols = tidx[:, :, None] * TILE + torch.arange(TILE, device=device)
    s, within = torch.topk(cand.reshape(batch, -1), k, dim=1)
    return s, cols.reshape(batch, -1).gather(1, within)


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to a card from pinned memory without
    waiting (a pageable copy may wait on the device's queue)."""
    t = torch.from_numpy(x)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class DeviceExpertIndex:
    """Built via :meth:`from_host_index` (or :meth:`add_bucket` and
    :meth:`set_cls`); search via :meth:`search`, which returns what
    ``InvertedExpertIndex.search`` returns, computed on ``device``, or
    expert-parallel over the devices of ``mesh`` (a list of devices; module
    docstring). One device is a mesh of one: its shard holds the whole
    bucket, and its column shard the whole accumulator."""

    # num_docs at or above this use the sort-based combine when there is no
    # dense CLS term. Below it, a row can touch fewer than k docs and the
    # dense accumulator's implicit all-zeros baseline changes the returned
    # top-k set; tests lower it to force the sorted path.
    sorted_combine_min_docs = 65536

    def __init__(self, num_docs: int, dtype=torch.bfloat16, device=None, mesh=None):
        self.num_docs = num_docs
        self.dtype = _DTYPES.get(dtype, dtype)
        # the devices the index shards over; the first combines
        self.devices = [torch.device(d) for d in mesh] if mesh else [resolve_device(device)]
        self.ndev = len(self.devices)
        self.device = self.devices[0]
        self.buckets: Dict[int, dict] = {}
        # each device's (NT / ndev, dim) rows of the CLS plane (:meth:`set_cls`)
        self.cls = None
        self._route_bsize = np.zeros(1, np.int64)
        self._route_slot = np.zeros(1, np.int64)
        # the host index's accounting dict (reference latency dict,
        # citadel_retrieval_task.py:45,111-113): routing_time is host-side
        # (shard_split_time the part of it that splits the entries by
        # shard), search_time covers upload, device work and the fetch
        self.latency: Dict[str, float] = collections.defaultdict(float)
        # (bucket size, entries, scorer, shard) of the last search
        self.last_plan: List[Tuple[int, int, str, int]] = []

    def _tiles(self) -> Tuple[int, int]:
        """(nt, NT) of the accumulator: TILE-column tiles (a multiple of
        ndev, past num_docs + 1 columns, as in JAX) and columns."""
        nt = max(1, -(-(self.num_docs + 1) // TILE))
        nt = -(-nt // self.ndev) * self.ndev
        return nt, nt * TILE

    # ------------------------------------------------------------- #

    def add_bucket(self, bsize: int, experts, vecs, run_id, run_doc, start_pos,
                   max_run_len: int) -> None:
        """One length bucket, laid out as :meth:`from_host_index` lays it out:
        ``experts[s]`` is the expert id of slot s (pad slots past it);
        tensors go to the index's devices (``vecs`` in its dtype). Over
        several devices the expert axis is padded to a multiple of ndev x
        the streamed group (pad experts score 0 and own no runs) and device
        ``i`` takes slots ``[i * epd, (i + 1) * epd)``; one device takes the
        tensors as they are (no copy if they are there already). The bucket
        keeps each device's tensors under ``"shards"``."""
        vecs = torch.as_tensor(vecs)
        n_exp = vecs.shape[0]
        g = 1
        if self.ndev > 1:
            itemsize = torch.empty((), dtype=self.dtype).element_size()
            g = _stream_group_target(bsize, vecs.shape[2], itemsize)
        epd = -(-n_exp // (self.ndev * g)) * g

        def place(src, i, dtype, fill):
            """Device i's slots of ``src``, padded to ``epd`` with ``fill``."""
            part = torch.as_tensor(src)[i * epd : (i + 1) * epd].to(self.devices[i], dtype)
            if part.shape[0] < epd:
                part = torch.cat([part, part.new_full((epd - part.shape[0], *part.shape[1:]),
                                                      fill)])
            return part.contiguous()

        shards = [{"vecs": place(vecs, i, self.dtype, 0),
                   "run_id": place(run_id, i, torch.int32, 0),
                   "run_doc": place(run_doc, i, torch.int64, -1),
                   "start_pos": place(start_pos, i, torch.int64, 0),
                   "max_run_len": int(max_run_len)} for i in range(self.ndev)]
        self.buckets[bsize] = {"shards": shards, "epd": epd, "max_run_len": int(max_run_len),
                               "experts": np.asarray(experts, np.int64)}
        # dense expert -> (bucket, slot) routing tables: the host routing is
        # vectorized numpy
        max_e = max(int(b["experts"].max(initial=-1)) for b in self.buckets.values())
        self._route_bsize = np.zeros(max_e + 2, np.int64)
        self._route_slot = np.zeros(max_e + 2, np.int64)
        for size, b in self.buckets.items():
            self._route_bsize[b["experts"]] = size
            self._route_slot[b["experts"]] = np.arange(len(b["experts"]))

    @classmethod
    def from_host_index(cls, host_index, dtype=torch.bfloat16, device=None,
                        mesh=None) -> "DeviceExpertIndex":
        """The bucket and run-compact layout of the JAX package
        (inverted_device.py:254-361), built and uploaded bucket by bucket so
        host memory holds one bucket at a time."""
        self = cls(host_index.num_docs, dtype, device, mesh)
        by_bucket: Dict[int, List[Tuple[int, object]]] = collections.defaultdict(list)
        for e, posts in host_index.experts.items():
            # oversized lists are truncated to their highest-weight postings
            by_bucket[_bucket_for(len(posts.doc_ids))].append((e, posts))

        itemsize = torch.empty((), dtype=self.dtype).element_size()
        n_truncated = 0
        for bsize, entries in by_bucket.items():
            dim = entries[0][1].vecs.shape[1]
            # pad the expert axis as the JAX package does (its streamed
            # blocks tile it); pad experts score 0 and own no runs
            g = _stream_group_target(bsize, dim, itemsize)
            n_exp = -(-len(entries) // g) * g
            vecs = np.zeros((n_exp, bsize, dim), np.float32)
            run_id = np.zeros((n_exp, bsize), np.int32)
            starts_all = np.zeros((n_exp, bsize), bool)
            docs_all = np.full((n_exp, bsize), -1, np.int64)
            nruns = np.zeros(n_exp, np.int32)
            max_run_len = 1
            for slot, (e, posts) in enumerate(entries):
                order = posts.sort_order
                v = posts.dense_vecs()[order]
                docs = posts.doc_ids[order]
                n = min(len(docs), bsize)
                if len(docs) > bsize:  # truncate by weight, keep doc sort
                    keep = np.sort(np.argsort(-posts.weights[order])[:bsize])
                    v, docs = v[keep], docs[keep]
                    n_truncated += 1
                vecs[slot, :n] = v[:n]
                # run segmentation: consecutive equal docs share a run id
                starts = np.concatenate([[True], docs[1:n] != docs[: n - 1]])
                rid = np.cumsum(starts) - 1
                run_id[slot, :n] = rid
                starts_all[slot, :n] = starts
                docs_all[slot, :n] = docs[:n]
                nruns[slot] = rid[-1] + 1 if n else 0
                if n:
                    lens = np.diff(np.append(np.flatnonzero(starts), n))
                    max_run_len = max(max_run_len, int(lens.max()))
                # pad positions point at the last run (their scores are 0
                # and the zero floor keeps them harmless)
                if n < bsize:
                    run_id[slot, n:] = rid[-1] if n else 0
            R_pad = min(_pad_2bit(int(nruns.max(initial=1)), minimum=8), bsize)
            run_doc = np.full((n_exp, R_pad), -1, np.int64)
            start_pos = np.zeros((n_exp, R_pad), np.int64)
            for slot in range(len(entries)):
                sp = np.flatnonzero(starts_all[slot])
                nr = min(len(sp), R_pad)
                start_pos[slot, :nr] = sp[:nr]
                run_doc[slot, :nr] = docs_all[slot, sp[:nr]]
            self.add_bucket(bsize, [e for e, _p in entries], torch.from_numpy(vecs), run_id,
                            run_doc, start_pos, max_run_len)
            del vecs, run_id, starts_all, docs_all
        if n_truncated:
            print(
                f"WARNING: {n_truncated} experts exceeded {BUCKET_SIZES[-1]} "
                "postings and were truncated to their highest-weight postings — "
                "device search diverges from host search for the dropped docs"
            )
        if host_index.cls is not None:
            self.set_cls(torch.from_numpy(host_index.cls))
        return self

    def set_cls(self, cls: torch.Tensor) -> None:
        """The (num_docs, dim) CLS plane in the index dtype, padded with zero
        rows to the accumulator's NT columns and cut by doc rows, device
        ``i`` holding rows ``[i * NT / ndev, (i + 1) * NT / ndev)`` (JAX
        inverted_device.py:339-349)."""
        ncols = self._tiles()[1] // self.ndev
        self.cls = []
        for i, dev in enumerate(self.devices):
            rows = cls[i * ncols : (i + 1) * ncols].to(dev, self.dtype)
            self.cls.append(F.pad(rows, (0, 0, 0, ncols - rows.shape[0])))

    # ------------------------------------------------------------- #

    def _score_bucket(self, bucket, scorer, slots, qvecs, qrows, pieces=None):
        """One bucket's flat (rows, docs, vals) updates: one per RUN (unique
        doc within the expert), the run's max score with the zero floor.

        The MaxSim inner max is a doubling suffix-max over the doc-sorted
        posting rows (``ceil(log2(max_run_len))`` shifted-max passes), as
        in the JAX package."""
        vecs, run_id = bucket["vecs"], bucket["run_id"]
        n_exp = vecs.shape[0]
        if scorer == "streamed":
            scores = gather_score.gather_score_streamed(vecs, qvecs, slots, pieces)
        elif scorer == "pipelined":
            scores = gather_score.gather_score_pipelined(vecs, slots, qvecs)
        else:
            scores = gather_score.gather_score_serial(vecs, slots, qvecs)
        # the streamed layout's pad slot n_exp is out of range for the
        # gathers (JAX clamps silently); its entries' rows are pad rows
        gslots = slots.long().clamp(max=n_exp - 1)
        rid = run_id[gslots]  # (E, L)
        rdoc = bucket["run_doc"][gslots]  # (E, R)
        spos = bucket["start_pos"][gslots]  # (E, R)
        d = 1
        while d < bucket["max_run_len"]:
            sh_s = F.pad(scores[:, d:], (0, d), value=float("-inf"))
            sh_r = F.pad(rid[:, d:], (0, d), value=-1)
            scores = torch.where(sh_r == rid, torch.maximum(scores, sh_s), scores)
            d *= 2
        seg = scores.gather(1, spos).clamp_min_(0.0)  # (E, R) run maxima
        rows = qrows.long()[:, None].expand_as(rdoc)
        return rows.reshape(-1), rdoc.reshape(-1), seg.reshape(-1)

    def _cls_scores(self, q, cls):
        """(B, rows) fp32 CLS scores of the queries ``q`` (on the device, in
        the index dtype) against ``cls``: products summed in fp32 (a bf16
        GEMM with an fp32 result on the card)."""
        if q.is_cuda and self.dtype == torch.bfloat16:
            return torch.mm(q, cls.T, out_dtype=torch.float32)
        return torch.matmul(q.float(), cls.float().T)

    def _combine_updates_sorted(self, rows, docs, vals, batch, k):
        """Sort-based combine: cost scales with UPDATES, not B x num_docs.
        Updates sorted by the int64 key row * (num_docs + 2) + doc; equal
        keys summed; then two stable sorts order (row, -total), so each
        row's top-k is a contiguous slice. Exact for the docs with updates;
        rows touching fewer than k docs get placeholder docs -1 with score
        0 (a repeated doc id would corrupt TREC runs)."""
        nd = self.num_docs
        keep = (rows < batch) & (docs >= 0) & (docs < nd)
        rows, docs, vals = rows[keep], docs[keep], vals[keep]
        dev = vals.device
        key = rows.long() * (nd + 2) + docs.long()
        skey, order = torch.sort(key, stable=True)
        ukey, inv = torch.unique_consecutive(skey, return_inverse=True)
        tot = torch.zeros(ukey.shape[0], dtype=torch.float32, device=dev)
        tot.index_add_(0, inv, vals[order])
        o1 = torch.argsort(-tot, stable=True)
        o2 = torch.argsort(ukey[o1] // (nd + 2), stable=True)
        perm = o1[o2]
        r2, t2, d2 = ukey[perm] // (nd + 2), tot[perm], ukey[perm] % (nd + 2)
        U = r2.shape[0]
        s = torch.zeros((batch, k), dtype=torch.float32, device=dev)
        doc = torch.full((batch, k), -1, dtype=torch.int64, device=dev)
        if U == 0:
            return s, doc
        bounds = torch.arange(batch + 1, device=dev)
        row_starts = torch.searchsorted(r2, bounds[:-1])
        row_ends = torch.searchsorted(r2, bounds[1:])
        idx = row_starts[:, None] + torch.arange(k, device=dev)[None, :]
        valid = idx < row_ends[:, None]
        idx_c = idx.clamp(max=U - 1)
        s = torch.where(valid, t2[idx_c], s)
        doc = torch.where(valid, d2[idx_c], doc)
        return s, doc

    def _combine_dense(self, parts, batch, k, q_cls=None):
        """The dense combine over the devices' column shards (the JAX
        program's, inverted_device.py:994-1027). ``parts`` holds each
        shard's (rows, docs, vals) updates on its device, ``q_cls`` the CLS
        queries on each device (or None). Every update reaches every device,
        and device ``i`` adds those of its columns ``[i * ncols, (i + 1) *
        ncols)`` into a (B, ncols) fp32 accumulator that its CLS slice
        writes (or zeros); the others, with those of pad rows (row B) and
        pure-pad runs (doc -1), add 0 at a column of their row (a boolean
        index would wait on the device). The columns past num_docs become
        -inf; then the tiled exact top-k."""
        nd = self.num_docs
        ncols = self._tiles()[1] // self.ndev
        accs = []
        for i, dev in enumerate(self.devices):
            rows, docs, vals = (torch.cat([p[j].to(dev, non_blocking=True) for p in parts])
                                for j in range(3))
            col = docs - i * ncols
            keep = (rows < batch) & (col >= 0) & (col < ncols) & (docs < nd)
            flat = torch.where(keep, rows * ncols + col,
                               rows.clamp(0, batch - 1) * ncols + docs.remainder(ncols))
            if q_cls is not None:
                acc = self._cls_scores(q_cls[i], self.cls[i])
            else:
                acc = torch.zeros((batch, ncols), dtype=torch.float32, device=dev)
            acc.view(-1).index_add_(0, flat, torch.where(keep, vals, torch.zeros_like(vals)))
            acc[:, max(0, nd - i * ncols):] = float("-inf")
            accs.append(acc.view(batch, -1, TILE))
        return _tiled_topk(accs, k, self.device)

    def _route(self, query_out):
        """Host routing, vectorized: dense expert -> (bucket, slot) table
        lookups over the flattened (B, T, K) routing grid. Returns (B, D,
        {bucket size: (rows, global slots, weighted query vectors)})."""
        expert_ids = np.asarray(query_out["expert_ids"])
        expert_repr = np.asarray(query_out["expert_repr"], dtype=np.float32)
        attn = np.asarray(query_out["attention_mask"])
        weights = query_out.get("expert_weights")
        weights = None if weights is None else np.asarray(weights, np.float32)
        citadel = expert_ids.ndim == 3
        eid = expert_ids if citadel else expert_ids[..., None]
        if weights is None:
            w = np.ones(eid.shape, np.float32)
        else:
            w = weights if citadel else weights[..., None]
        valid = (attn[..., None] > 0) & (eid >= 0) & (w > 0)
        eid_c = np.clip(eid, 0, len(self._route_bsize) - 1)
        bs = np.where(valid & (eid == eid_c), self._route_bsize[eid_c], 0)
        b_idx, t_idx, k_idx = np.nonzero(bs)
        bsizes_sel = bs[b_idx, t_idx, k_idx]
        slots_sel = self._route_slot[eid[b_idx, t_idx, k_idx]]
        vecs_sel = (w[b_idx, t_idx, k_idx, None] * expert_repr[b_idx, t_idx]).astype(np.float32)
        per_bucket = {}
        for bsize in np.unique(bsizes_sel):
            m = bsizes_sel == bsize
            per_bucket[int(bsize)] = (b_idx[m], slots_sel[m], vecs_sel[m])
        return expert_repr.shape[0], expert_repr.shape[-1], per_bucket

    def _plan(self, entries, D, dev):
        """One device's buckets: ``entries`` is a list of (bucket size, its
        tensors on ``dev``, rows, slots into them, query vectors). Picks
        each bucket's scorer and packs its arrays; returns (plan, int
        arrays, query arrays), the plan (bucket size, tensors, entries,
        streamed pieces)."""
        capable = STREAM_MODE == "on" or dev.type == "cuda"
        plan, ints, qs = [], [], []
        for bsize, bucket, rows_b, slots_b, vecs_b in entries:
            if not len(rows_b):
                continue
            n_exp = bucket["vecs"].shape[0]
            itemsize = bucket["vecs"].element_size()
            pieces = []
            if _choose_stream(slots_b, n_exp, bsize, D, itemsize, capable):
                # slot-sorted entries: one posting tile serves each run
                order = np.argsort(slots_b, kind="stable")
                rows_b, slots_b, vecs_b = rows_b[order], slots_b[order], vecs_b[order]
                pieces = [gather_score.stream_pieces(slots_b)]
            plan.append((bsize, bucket, len(rows_b), len(pieces[0]) if pieces else 0))
            ints += [slots_b.astype(np.int32), rows_b.astype(np.int32), *pieces]
            qs.append(vecs_b)
        return plan, ints, qs

    def search(
        self, query_out: Dict[str, np.ndarray], topk: int = 100, as_numpy: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Same contract as InvertedExpertIndex.search, computed on the
        device (or devices). ``as_numpy=False`` returns device tensors
        (scores, indices) on the first device without the fetch."""
        tic = time.perf_counter()
        B, D, per_bucket = self._route(query_out)
        by_device = [[] for _ in self.devices]
        t_split = time.perf_counter()
        for bsize, (rows_b, slots_b, vecs_b) in per_bucket.items():
            bucket = self.buckets[bsize]
            epd = bucket["epd"]
            shard = slots_b // epd
            for i, tensors in enumerate(bucket["shards"]):
                m = shard == i
                by_device[i].append((bsize, tensors, rows_b[m], slots_b[m] - i * epd, vecs_b[m]))
        self.latency["shard_split_time"] += time.perf_counter() - t_split
        plans = [self._plan(entries, D, dev) for entries, dev in zip(by_device, self.devices)]
        self.latency["routing_time"] += time.perf_counter() - tic

        tic = time.perf_counter()
        # TWO uploads a device for the whole search (three with CLS), all
        # before any launch: every int array packed into one vector, every
        # query vector into one matrix
        packed = [(_upload(np.concatenate(ints) if ints else np.zeros(1, np.int32), dev),
                   _upload(np.concatenate(qs) if qs else np.zeros((1, D), np.float32), dev)
                   .to(self.dtype))
                  for (_plan, ints, qs), dev in zip(plans, self.devices)]
        k = min(topk, self.num_docs)
        has_cls = self.cls is not None and "cls_repr" in query_out
        q_cls = None
        if has_cls:
            q_cls = [_upload(np.array(query_out["cls_repr"], np.float32), dev).to(self.dtype)
                     for dev in self.devices]
        # the gather scorer of the buckets that do not stream (the JAX
        # package's switch, read at trace time there)
        gather = "pipelined" if os.environ.get("DPR_GATHER_KERNEL") == "pipelined" else "serial"
        self.last_plan = []
        parts = []
        for i, ((plan, _i, _q), (packed_i, packed_q), dev) in enumerate(
                zip(plans, packed, self.devices)):
            out, oi, oq = [], 0, 0
            for bsize, bucket, n, n_pieces in plan:
                slots = packed_i[oi : oi + n]
                qrows = packed_i[oi + n : oi + 2 * n]
                oi += 2 * n
                pieces = None
                if n_pieces:
                    pieces = packed_i[oi : oi + n_pieces]
                    oi += n_pieces
                qvecs = packed_q[oq : oq + n]
                oq += n
                scorer = "streamed" if n_pieces else gather
                out.append(self._score_bucket(bucket, scorer, slots, qvecs, qrows, pieces))
                self.last_plan.append((bsize, n, scorer, i))
            if out:
                parts.append(tuple(torch.cat([p[j] for p in out]) for j in range(3)))
            else:
                empty = torch.zeros(0, dtype=torch.int64, device=dev)
                parts.append((empty, empty, torch.zeros(0, dtype=torch.float32, device=dev)))
        if not has_cls and self.num_docs >= self.sorted_combine_min_docs:
            rows, docs, vals = (torch.cat([p[j].to(self.device, non_blocking=True)
                                           for p in parts]) for j in range(3))
            s, idx = self._combine_updates_sorted(rows, docs, vals, B, k)
        else:
            s, idx = self._combine_dense(parts, B, k, q_cls)
        if not as_numpy:
            self.latency["search_time"] += time.perf_counter() - tic
            return s, idx
        out = s.cpu().numpy(), idx.cpu().numpy()
        self.latency["search_time"] += time.perf_counter() - tic
        return out
