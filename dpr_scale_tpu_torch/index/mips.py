"""Exact MIPS engine: verified-exact top-k over embedding blocks on one device.

Counterpart of :class:`dpr_scale_tpu.index.mips.MipsIndex` with its five
unquantised methods: ``"fused"`` (the default), ``"groupmax"``, ``"auto"``,
``"approx"`` and ``"exact_sort"``. The fused pipeline per block:

  1. pass 1: the exact top-``kc`` rows of each query
     (``ops.mips_kernels.topk_candidates``). The JAX pass is a dot fused into
     ``lax.approx_max_k`` (a TPU primitive, no Pallas kernel), approximate;
     this one is exact, so verification passes more often and the output is
     the same exact top-k. On the card it is the hand-written kernel: a
     tile-max sweep sets a per-query threshold, an emit sweep on the count
     kernel's loop (wgmma for a bf16 block of even D, the score tile for
     fp32 or odd D) writes every score above it as a candidate and
     ``torch.topk`` keeps the best kc, so the B x N scores never reach
     memory and the candidates' scores are pass 2's bits;
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
exact, so its recall is 1.0. ``"exact_sort"`` is pass 1 at depth k, and so
is the exact fallback of every verified method.

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
tier (:meth:`MipsIndex.set_rerank`).

Host-resident blocks (``host_resident=True``, :meth:`MipsIndex.add_host_quantized`,
:meth:`MipsIndex.add_host_packed4`) stay in host memory and stream through
the device at each search, for corpora larger than the card: the next host
block is staged (a memmap's pages through a reused pinned buffer) and
uploaded by ``non_blocking`` copies on a side stream while the current block
is searched, ordered by an event, so that at most two streamed blocks are on
the device at once. They search as device blocks do, with the same kernels
and the same exact fallback. Device and host blocks mix in one index (the
hybrid layout of ``index.store.load_int8_store``).

Blocks are searched one after another and merged on the host
(``merge_topk_batched``); global row ids follow insertion order, and masked
(pad) rows surface as index ``-1``.

Exactness caveat, as in the JAX package: scores are fp32 accumulations of
bf16 inputs, so rows whose scores differ by under ~1 ulp may swap ranks; the
verification is written so such near-ties only add rescue work.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
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
    NEG_INF,
    count_above,
    count_above_groups,
    groupmax,
    merge_chunk_topk,
    topk_candidates,
)

CHUNK_ROWS = 131072  # block padding above one chunk; a quantised block's exact-scan chunk
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
GMAX_ROWS_TIER2 = GMAX_ROWS * GMAX_TIER2  # 128: the row multiple of an added block
INV7 = float(np.float32(1.0 / 7.0))  # XLA's product for a division by 7.0


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


QUANT_CHUNK = 65536  # rows a host-quantisation task takes


def _chunked(n: int, fn) -> None:
    """``fn(lo, hi)`` over QUANT_CHUNK-row chunks of [0, n), on a thread a
    core (numpy releases the GIL in its loops)."""
    spans = [(lo, min(lo + QUANT_CHUNK, n)) for lo in range(0, n, QUANT_CHUNK)]
    if len(spans) <= 1:
        for lo, hi in spans:
            fn(lo, hi)
        return
    with ThreadPoolExecutor(min(len(spans), os.cpu_count() or 1)) as pool:
        list(pool.map(lambda span: fn(*span), spans))


def quantize_host(emb: np.ndarray, packed: bool):
    """The JAX index's host quantisers (``_quantize_int8_host``,
    ``_quantize_int4_host``), bit for bit, chunk by chunk on threads: the
    column maxima, then each row's scale ``max |x| / qmax`` (0 -> 1) and
    ``clip(rint(x / scale))`` of ``x = emb / col``, with qmax 127, or 7 and
    nibble packing (byte j: dim j low, dim j + D/2 high). Returns (rows,
    row scales, column scales)."""
    n, d = emb.shape
    if packed and d % 2:
        raise ValueError(f"int4 packing needs an even embedding dim, got {d}")
    qmax = 7.0 if packed else 127.0
    parts = np.zeros((-(-n // QUANT_CHUNK) or 1, d), emb.dtype)

    def col_max(lo, hi):
        parts[lo // QUANT_CHUNK] = np.abs(emb[lo:hi]).max(axis=0)

    _chunked(n, col_max)
    col = parts.max(axis=0)
    col[col == 0.0] = 1.0
    rows = np.empty((n, d // 2 if packed else d), np.int8)
    sc = np.empty((n,), np.float32)

    def quantise(lo, hi):
        x = emb[lo:hi] / col[None, :]
        s = np.abs(x).max(axis=1) / qmax
        s[s == 0.0] = 1.0
        q = np.clip(np.rint(x / s[:, None]), -qmax, qmax).astype(np.int8)
        if packed:
            low = q[:, : d // 2].view(np.uint8) & 0xF
            high = q[:, d // 2 :].view(np.uint8) & 0xF
            q = ((high << 4) | low).view(np.int8)
        rows[lo:hi] = q
        sc[lo:hi] = s

    _chunked(n, quantise)
    return rows, sc, col.astype(np.float32)


@dataclasses.dataclass
class HostBlock:
    """A host-resident block: ``rows`` a pinned (or, on the CPU, plain) tensor
    of a dense block, or the numpy int8 rows of a quantised one (int4
    nibbles with ``packed``; a read-only memmap stays one); ``row_scales``
    and ``col_scales`` numpy fp32 for a quantised block, else None."""

    rows: object
    row_scales: Optional[np.ndarray] = None
    col_scales: Optional[np.ndarray] = None
    packed: bool = False


def _host_arrays(block: HostBlock):
    """(name, host array) of each part a block uploads."""
    parts = [("rows", block.rows)]
    if block.row_scales is not None:
        parts += [("row_scales", block.row_scales), ("col_scales", block.col_scales)]
    return parts


def _device_form(block: HostBlock, parts: dict):
    """The device block searched for ``block``, from its uploaded parts."""
    if block.row_scales is None:
        return parts["rows"]
    return QuantBlock(parts["rows"], parts["row_scales"], parts["col_scales"], block.packed)


UPLOAD_CHUNK_BYTES = 64 << 20  # a pinned staging slot
STAGING_SLOTS = 4  # slots in the staging ring: one filling while others copy
COPY_THREADS = 4  # threads filling a slot (a host memcpy: 8 were slower on 8 cores)
_TORCH_DTYPES = {"i1": torch.int8, "f4": torch.float32, "u1": torch.uint8}


class _Done:
    """A finished result with the interface of a Future."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class HostStream:
    """Uploads host blocks to ``device`` ahead of their search.

    On a GPU, :meth:`start` hands the block to one worker thread. A part
    that is a pinned tensor is copied ``non_blocking`` on a side stream. A
    numpy part (a read-only memmap of a store too) goes through a ring of
    STAGING_SLOTS pinned slots of UPLOAD_CHUNK_BYTES: COPY_THREADS threads
    fill a slot from the array (the memmap's pages are read there, never
    copied whole elsewhere) while the side stream copies the slots filled
    before; a slot is refilled once its copy's event has passed. Pageable
    sources would make the copies synchronous, which is why every byte is
    pinned first. Each upload ends with an event; :meth:`take` makes the
    current stream wait for it and marks the tensors as used there, so the
    caching allocator does not hand their memory to the next upload before
    the search is done. On the CPU the parts are the block's own arrays,
    copied."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._pool: Optional[ThreadPoolExecutor] = None
        self._copiers: Optional[ThreadPoolExecutor] = None
        self._stream = None
        self._ring: List[Optional[torch.Tensor]] = [None] * STAGING_SLOTS
        self._ring_events: List[Optional[object]] = [None] * STAGING_SLOTS
        self._slot = 0

    def start(self, block: HostBlock):
        if not self._cuda:  # the device block is a copy the index owns
            return _Done(({k: a.clone() if isinstance(a, torch.Tensor)
                           else torch.from_numpy(np.array(a)) for k, a in _host_arrays(block)},
                          None))
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="mips-upload")
            self._copiers = ThreadPoolExecutor(COPY_THREADS, thread_name_prefix="mips-stage")
            self._stream = torch.cuda.Stream(self.device)
        return self._pool.submit(self._upload, block)

    def _fill(self, dst: np.ndarray, src: np.ndarray) -> None:
        step = -(-src.size // COPY_THREADS)
        spans = [(lo, min(lo + step, src.size)) for lo in range(0, src.size, step)]
        list(self._copiers.map(lambda sp: np.copyto(dst[sp[0]:sp[1]], src[sp[0]:sp[1]]), spans))

    def _staged(self, array: np.ndarray) -> torch.Tensor:
        """``array`` on the device through the staging ring (side stream)."""
        src = array.reshape(-1).view(np.uint8)
        dst = torch.empty(src.size, dtype=torch.uint8, device=self.device)
        for lo in range(0, src.size, UPLOAD_CHUNK_BYTES):
            n = min(UPLOAD_CHUNK_BYTES, src.size - lo)
            slot, self._slot = self._slot, (self._slot + 1) % STAGING_SLOTS
            if self._ring_events[slot] is not None:
                self._ring_events[slot].synchronize()  # the slot's last copy has landed
            if self._ring[slot] is None:
                self._ring[slot] = torch.empty(UPLOAD_CHUNK_BYTES, dtype=torch.uint8,
                                               pin_memory=True)
            buf = self._ring[slot][:n]
            self._fill(buf.numpy(), src[lo : lo + n])
            dst[lo : lo + n].copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
            self._ring_events[slot] = event
        return dst.view(_TORCH_DTYPES[array.dtype.str[1:]]).view(array.shape)

    def _upload(self, block: HostBlock):
        out = {}
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for key, a in _host_arrays(block):
                if isinstance(a, torch.Tensor):
                    src = a if a.is_pinned() else a.pin_memory()
                    out[key] = src.to(self.device, non_blocking=True)
                else:
                    out[key] = self._staged(np.ascontiguousarray(a))
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def take(self, future, block: HostBlock):
        """The device block of a :meth:`start`, ready for the current stream."""
        parts, event = future.result()
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in parts.values():
                t.record_stream(stream)
        return _device_form(block, parts)


class MipsIndex:
    """Inner-product top-k over one or more embedding blocks on ``device``.

    ``add(embeddings)`` appends a block (rows indexed globally in insertion
    order); ``search(queries, k)`` returns global (scores, indices) as numpy.
    ``last_repair`` counts, per search, the (query, block) verification
    failures routed to the exact fallback and the distinct queries repaired
    (methods fused, groupmax, auto, int8 and int4). ``host_resident=True``
    keeps the blocks of ``add`` in host memory and streams them through the
    device at each search (module docstring); the ``add_device*`` and
    ``add_host*`` builders take blocks already on the device, or already
    quantised on the host.
    """

    # 2 = int16-precision queries of the quantised tiers as two int8 planes
    # (the corpus is unchanged), as the JAX index's attribute
    int8_query_planes = 1

    def __init__(
        self, device, dtype=torch.bfloat16, method: str = "fused", host_resident: bool = False
    ):
        if method not in METHODS:
            raise ValueError(f"unknown MipsIndex method {method!r} (one of {METHODS})")
        self.device = torch.device(device)
        self.dtype = dtype
        self.method = method
        self.host_resident = bool(host_resident)
        # (block, n_valid, offset): a device tensor, a QuantBlock or a HostBlock
        self._blocks: List[Tuple[object, int, int]] = []
        self._stream = HostStream(self.device)
        self._total_rows = 0
        self._dim: Optional[int] = None
        self.last_repair = {"block_fail_events": 0, "queries_repaired": 0}
        self._repaired_queries: set = set()
        self._rerank_rows = None  # the host exact-rerank tier (set_rerank)
        self.rerank_oversample = 4

    @staticmethod
    def _quantize_int8_host(emb: np.ndarray):
        """Column-equalised per-row symmetric int8: (q8, row_sc, col_sc)."""
        return quantize_host(emb, packed=False)

    @staticmethod
    def _quantize_int4_host(emb: np.ndarray):
        """Column-equalised per-row symmetric 4-bit, nibble-packed: (packed
        (N, D/2) int8, row_sc, col_sc). Byte j holds dim j in its low nibble
        and dim j + D/2 in its high nibble; values clip to [-7, 7]."""
        return quantize_host(emb, packed=True)

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

    def _check_dim(self, d: int) -> None:
        if self._dim is None:
            self._dim = d
        if d != self._dim:
            raise ValueError(f"embedding dim {d} != the index's {self._dim}")

    def _append(self, block, n_valid: int) -> None:
        self._blocks.append((block, int(n_valid), self._total_rows))
        self._total_rows += int(n_valid)

    def add(self, embeddings) -> None:
        """Append a (n, D) block (numpy or tensor); pad rows are zero (the
        quantised tiers: quantised on the host, pad rows of scale 1). A
        host-resident index keeps it in host memory (pinned for a GPU)."""
        n, d = embeddings.shape
        self._check_dim(d)
        if self.method in QUANTISED:
            block = self._quantize_block(embeddings, self._pad_rows(n))
        else:
            if not isinstance(embeddings, torch.Tensor):  # torch needs writable arrays
                embeddings = torch.from_numpy(np.require(embeddings, requirements="W"))
            if self.host_resident:
                block = torch.zeros((self._pad_rows(n), d), dtype=self.dtype,
                                    pin_memory=self.device.type == "cuda")
                block[:n] = embeddings.to("cpu", self.dtype)
                block = HostBlock(block)
            else:
                block = torch.zeros((self._pad_rows(n), d), dtype=self.dtype, device=self.device)
                block[:n] = embeddings.to(self.device, self.dtype)
        self._append(block, n)

    def _quantize_block(self, embeddings, n_pad: int):
        """The JAX ``add``'s host quantisation of the zero-padded fp32 block
        (several fp32 copies of it at once, as there): a QuantBlock on the
        device, or a HostBlock for a host-resident index."""
        if isinstance(embeddings, torch.Tensor):
            embeddings = embeddings.detach().float().cpu().numpy()
        emb = np.zeros((n_pad, embeddings.shape[1]), np.float32)
        emb[: embeddings.shape[0]] = embeddings
        packed = self.method == "int4"
        quant = self._quantize_int4_host if packed else self._quantize_int8_host
        rows, row_sc, col_sc = quant(emb)
        if self.host_resident:
            return HostBlock(rows, row_sc, col_sc, packed)
        return QuantBlock(*(torch.from_numpy(a).to(self.device) for a in (rows, row_sc, col_sc)),
                          packed)

    def _check_quantized(self, method: str, rows, scales, n_valid, col_scales, packed: bool):
        """The checks of the JAX ``add_*_quantized`` / ``add_*_packed4``
        builders; returns (n_pad, D, n_valid)."""
        if self.method != method:
            raise ValueError(f"this builder takes a {method} block; the index is {self.method!r}")
        n_pad, w = rows.shape
        d = 2 * w if packed else w
        if str(rows.dtype) not in ("int8", "torch.int8") or tuple(scales.shape) != (n_pad,):
            raise ValueError(f"expected int8 rows (n_pad, {w}) and scales ({n_pad},), got "
                             f"{rows.dtype} {tuple(rows.shape)} and {tuple(scales.shape)}")
        if n_pad % GMAX_ROWS_TIER2 != 0:  # ndev * 128 rows in JAX, one device here
            raise ValueError(f"a quantised block holds a multiple of {GMAX_ROWS_TIER2} rows, "
                             f"not {n_pad}")
        if col_scales is not None and tuple(col_scales.shape) != (d,):
            raise ValueError(f"col_scales {tuple(col_scales.shape)} != ({d},)")
        self._check_dim(d)
        return n_pad, d, n_pad if n_valid is None else int(n_valid)

    def add_device(self, emb_dev: torch.Tensor, n_valid: Optional[int] = None) -> None:
        """Append a block already on the device, (n_pad, D) with n_pad a
        multiple of 128 (rows past ``n_valid`` ignored): the pad rows are
        zeroed (the pad-count corrections rely on pad scores of exactly 0);
        an int8 / int4 index quantises it on the device with the JAX
        ``add_device``'s arithmetic (the divisions by the constants 127 and
        7 as products with their fp32 reciprocals, as XLA compiles them)."""
        n_pad, d = emb_dev.shape
        if n_pad % GMAX_ROWS_TIER2 != 0:
            raise ValueError(f"add_device takes a multiple of {GMAX_ROWS_TIER2} rows, not {n_pad}")
        self._check_dim(d)
        n = n_pad if n_valid is None else int(n_valid)
        emb = emb_dev.to(self.device)
        if n < n_pad:
            emb = torch.cat([emb[:n], torch.zeros_like(emb[n:])])
        if self.method in QUANTISED:
            int4 = self.method == "int4"
            ef = emb.float()
            col = ef.abs().amax(dim=0)
            col = torch.where(col == 0.0, torch.ones_like(col), col)
            x = ef / col[None, :]
            sc = x.abs().amax(dim=1) * (INV7 if int4 else INV127)
            sc = torch.where(sc == 0.0, torch.ones_like(sc), sc)
            qmax = 7.0 if int4 else 127.0
            q8 = torch.round(x / sc[:, None]).clamp(-qmax, qmax).to(torch.int8)
            if int4:  # nibbles, column-block layout (_quantize_int4_host)
                half = d // 2
                q8 = (q8[:, half:] << 4) | (q8[:, :half] & 0xF)
            self._append(QuantBlock(q8.contiguous(), sc, col, int4), n)
            return
        emb = emb.to(self.dtype)
        if n_pad % GROUP_ROWS:  # the fused search's rescue groups
            emb = torch.cat([emb, emb.new_zeros(GROUP_ROWS - n_pad % GROUP_ROWS, d)])
        self._append(emb.contiguous(), n)

    def _add_quantized(self, method, rows, scales, n_valid, col_scales, host: bool) -> None:
        packed = method == "int4"
        _n_pad, d, n = self._check_quantized(method, rows, scales, n_valid, col_scales, packed)
        if host:
            col = (np.ones((d,), np.float32) if col_scales is None
                   else np.asarray(col_scales, np.float32))
            block = HostBlock(np.ascontiguousarray(rows), np.asarray(scales, np.float32), col,
                              packed)
        else:
            col = (torch.ones((d,), dtype=torch.float32, device=self.device) if col_scales is None
                   else torch.as_tensor(col_scales, dtype=torch.float32).to(self.device))
            block = QuantBlock(rows.to(self.device), scales.to(self.device, torch.float32), col,
                               packed)
        self._append(block, n)

    def add_device_quantized(self, q8_dev, scales_dev, n_valid: Optional[int] = None,
                             col_scales=None) -> None:
        """int8 only: append a block quantised already, on the device: (n_pad,
        D) int8 rows of per-row scales ``scales_dev`` (n_pad,) as :meth:`add`
        makes them, and the column equalisation ``col_scales`` (D,), all
        ones by default. For corpora quantised in chunks (``index.store``)."""
        self._add_quantized("int8", q8_dev, scales_dev, n_valid, col_scales, host=False)

    def add_host_quantized(self, q8, scales, n_valid: Optional[int] = None,
                           col_scales=None) -> None:
        """int8 only: :meth:`add_device_quantized`'s block as numpy arrays in
        host memory (a memmap stays one), streamed through the device at
        each search; device and host blocks mix in one index."""
        self._add_quantized("int8", q8, scales, n_valid, col_scales, host=True)

    def add_device_packed4(self, packed_dev, scales_dev, n_valid: Optional[int] = None,
                           col_scales=None) -> None:
        """int4 only: append a block packed already, on the device: (n_pad,
        D / 2) int8 nibbles in :meth:`_quantize_int4_host`'s layout and its
        per-row scales."""
        self._add_quantized("int4", packed_dev, scales_dev, n_valid, col_scales, host=False)

    def add_host_packed4(self, packed, scales, n_valid: Optional[int] = None,
                         col_scales=None) -> None:
        """int4 only: :meth:`add_device_packed4`'s block in host memory,
        streamed through the device at each search."""
        self._add_quantized("int4", packed, scales, n_valid, col_scales, host=True)

    @property
    def num_rows(self) -> int:
        return self._total_rows

    # ------------------------------------------------------------------ #

    def _quant_score_chunks(self, q, emb: QuantBlock):
        """(lo, hi, fp32 scores (B, hi - lo)) of a quantised block's rows,
        CHUNK_ROWS at a time: the dequantised scores (the arithmetic of the
        int kernels' plain versions)."""
        planes = int(self.int8_query_planes)
        q8, qsc = self._quantize_queries(q, emb.col_scales, planes)
        for lo in range(0, emb.shape[0], CHUNK_ROWS):
            hi = min(lo + CHUNK_ROWS, emb.shape[0])
            yield lo, hi, int_scores(q8, emb.rows[lo:hi], emb.row_scales[lo:hi], qsc,
                                     packed=emb.packed, planes=planes)

    def _topk_rows(self, q, emb, k, n_valid):
        """Exact top-k (scores, rows) per query over one block; rows >=
        n_valid (pads) never return: missing entries score NEG_INF, row -1.
        A dense block takes ``topk_candidates`` (fp32 sums of the products of
        the queries cast to the block dtype: on the card, the count kernels'
        bits), a quantised block its dequantised scores chunk by chunk."""
        if isinstance(emb, QuantBlock):
            return merge_chunk_topk(self._quant_score_chunks(q, emb), n_valid, k)
        return topk_candidates(q.to(self.dtype), emb, n_valid, k)

    def _exact_topk(self, emb, n_valid, q, k):
        """Exact top-k of one block; masked rows surface as -1."""
        return self._topk_rows(q, emb, k, n_valid)

    def _candidates(self, qd, emb, kc, n_valid):
        """Pass 1 of the fused, auto and approx searches: the exact top-kc
        rows of each query (``topk_candidates``: on the card the kernel,
        whose scores are pass 2's bits). The TPU's pass,
        ``lax.approx_max_k``, is approximate."""
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
        gid = cand_i.clamp_min(0) // group  # (B, kc); a missing (-1) candidate credits nothing
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
        if isinstance(emb, HostBlock):  # timed as a resident block
            emb = self._stream.take(self._stream.start(emb), emb)
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

    def _next_host(self, after: int):
        """The first host block past position ``after``, with its upload
        started; (None, None) when there is none."""
        for bi in range(after + 1, len(self._blocks)):
            block = self._blocks[bi][0]
            if isinstance(block, HostBlock):
                return bi, self._stream.start(block)
        return None, None

    def _per_block_host_merge(self, q, k_eff):
        per_block_s, per_block_i = [], []
        # host blocks: the next one uploads while the current block is
        # searched; the one before is freed first (at most two on the device)
        next_bi, upload = self._next_host(-1)
        for bi, (block, n_valid, offset) in enumerate(self._blocks):
            emb = block
            if bi == next_bi:
                emb = self._stream.take(upload, block)
                next_bi, upload = self._next_host(bi)
            k_block = min(k_eff, emb.shape[0])
            s, i = self._search_block(emb, n_valid, q, k_block)
            del emb
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
