"""Posting gather-score: the bucket scorers of the CITADEL / COIL device search.

Counterparts of the three Pallas scorers of
:class:`dpr_scale_tpu.index.inverted_device.DeviceExpertIndex`. For posting
blocks ``vecs (n_exp, L, D)`` (bf16 or fp32), entry slots ``slots (E,)`` and
entry query vectors ``q (E, D)``, each returns ``(E, L)`` fp32

    out[e, l] = sum_d vecs[slots[e], l, d] * q'[e, d]

where ``q'`` is ``q`` rounded to the postings' dtype and the products and the
sum are taken in fp32 (what ``dpr_scale_tpu/index/inverted_device.py:409-412``
and the MXU dot at ``:517-523`` compute). An entry whose slot lies outside
``[0, n_exp)`` scores 0: the streamed layout's pad slot ``n_exp``
(``:597-625``).

* :func:`gather_score_plain` — plain PyTorch (gather, then an fp32 batched
  product), the CPU path and the oracle of all three kernels;
* :func:`gather_score_serial_kernel` (replaces ``_scores_pallas_serial``,
  ``pallas_call`` at ``:431``), :func:`gather_score_pipelined_kernel`
  (``_scores_pallas``, ``:550``) and :func:`gather_score_streamed_kernel`
  (``_scores_streamed``, ``:648``) — ``csrc/gather_score.cu``, any D up to
  the limits in :func:`_check_kernel`; the pipelined kernel gives the
  serial kernel's bits, through a ring of bulk copies where a row is a
  multiple of 16 bytes (:data:`PIPE_ROUTES`);
* :func:`gather_score_serial`, :func:`gather_score_pipelined`,
  :func:`gather_score_streamed` — dispatch: a CPU tensor takes the plain
  version, a CUDA tensor launches the kernel or raises.

The streamed kernel takes ``pieces``: offsets of runs of equal slot, each at
most :data:`STREAM_PIECE` entries, computed on the host by
:func:`stream_pieces` (entries sorted by slot make the runs long).
"""
from __future__ import annotations

import numpy as np
import torch

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
SERIAL_TILE = 2048  # rows of one entry a serial block scores
PIPE_BULK_STAGE_BYTES = 16384  # posting bytes of one stage of the bulk-copy ring
PIPE_STAGE_BYTES = 16384  # posting bytes of one stage of the element-copy kernel
# the pipelined kernel's routes (dst_gather_pipelined_route's 0 and 1): rows
# of 16-byte multiples take one bulk copy per (entry, L-tile), other rows
# element copies
PIPE_ROUTES = ("element_copy", "bulk_copy")
STREAM_TILE_BYTES = 32768  # posting bytes of one streamed block's tile
STREAM_PIECE = 64  # entries a streamed block scores against its tile
PLAIN_CHUNK_BYTES = 1 << 28  # fp32 posting bytes the plain version gathers at once


def _check_shapes(vecs, slots, q, what):
    if vecs.dim() != 3 or slots.dim() != 1 or q.dim() != 2:
        raise ValueError(
            f"{what}: vecs (n_exp, L, D), slots (E,) and q (E, D), got "
            f"{tuple(vecs.shape)}, {tuple(slots.shape)}, {tuple(q.shape)}"
        )
    if q.shape != (slots.shape[0], vecs.shape[2]):
        raise ValueError(
            f"{what}: q {tuple(q.shape)} must be (E, D) = "
            f"({slots.shape[0]}, {vecs.shape[2]})"
        )


def gather_score_plain(vecs, slots, q):
    _check_shapes(vecs, slots, q, "gather_score")
    n_exp, L, D = vecs.shape
    E = slots.shape[0]
    out = torch.empty((E, L), dtype=torch.float32, device=vecs.device)
    slots = slots.to(vecs.device).long()
    valid = (slots >= 0) & (slots < n_exp)
    idx = torch.where(valid, slots, torch.zeros_like(slots))
    qf = q.to(vecs.device).to(vecs.dtype).float()
    step = max(1, PLAIN_CHUNK_BYTES // max(1, L * D * 4))
    for lo in range(0, E, step):
        pv = vecs[idx[lo : lo + step]].float()  # (e, L, D)
        out[lo : lo + step] = torch.bmm(pv, qf[lo : lo + step, :, None])[..., 0]
    return torch.where(valid[:, None], out, torch.zeros((), device=out.device))


def _check_kernel(vecs, slots, q, what):
    """The kernels' inputs as they take them: contiguous int32 slots, q in
    the postings' dtype, and an fp32 output."""
    _check_shapes(vecs, slots, q, what)
    if not vecs.is_cuda:
        raise ValueError(f"{what} kernel takes CUDA tensors, got {vecs.device}")
    if vecs.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} kernel takes bf16 or fp32 postings, got {vecs.dtype}")
    if slots.device != vecs.device or q.device != vecs.device:
        raise ValueError(f"{what} kernel: all tensors must be on one CUDA device")
    if not vecs.is_contiguous():
        raise ValueError(f"{what} kernel: the postings must be contiguous")
    n_exp, L, D = vecs.shape
    wide = 16 // vecs.element_size()
    limit = 256 * wide if D % wide == 0 else 256
    if D > limit:
        raise ValueError(f"{what} kernel: D={D} above its limit {limit} for {vecs.dtype}")
    return (
        slots.to(torch.int32).contiguous(),
        q.to(vecs.dtype).contiguous(),
        torch.empty((slots.shape[0], L), dtype=torch.float32, device=vecs.device),
    )


def _pow2_rows(budget_bytes, row_bytes, L):
    """The largest power of two of rows within ``budget_bytes``, at most L."""
    rows = max(1, budget_bytes // row_bytes)
    return min(1 << (rows.bit_length() - 1), L)


def gather_score_serial_kernel(vecs, slots, q):
    """Launch the serial kernel of ``csrc/gather_score.cu``."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    slots, q, out = _check_kernel(vecs, slots, q, "gather_score_serial")
    n_exp, L, D = vecs.shape
    if slots.shape[0] == 0:
        return out
    with torch.cuda.device(vecs.device):
        rc = cuda_lib.library().dst_gather_serial(
            vecs.data_ptr(), slots.data_ptr(), q.data_ptr(), out.data_ptr(),
            slots.shape[0], n_exp, L, D, min(L, SERIAL_TILE), _KERNEL_DTYPES[vecs.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "gather_score_serial")
    gather_score_serial_kernel.launches += 1
    return out


def pipelined_tiling(route, row_bytes, L, E):
    """(tile, group) of a pipelined launch: rows per work item and entries
    per item. The bulk-copy ring takes one entry's tile of at most
    PIPE_BULK_STAGE_BYTES a stage; the element-copy kernel up to 8 entries'
    tiles in PIPE_STAGE_BYTES."""
    if route == "bulk_copy":
        return _pow2_rows(PIPE_BULK_STAGE_BYTES, row_bytes, L), 1
    tile = _pow2_rows(PIPE_STAGE_BYTES // 2, row_bytes, L)
    return tile, max(1, min(8, E, PIPE_STAGE_BYTES // (tile * row_bytes)))


def gather_score_pipelined_kernel(vecs, slots, q):
    """Launch the pipelined kernel of ``csrc/gather_score.cu``: the
    bulk-copy ring where the rows allow it, else the element-copy kernel
    (``launches_by_route`` counts each)."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    slots, q, out = _check_kernel(vecs, slots, q, "gather_score_pipelined")
    n_exp, L, D = vecs.shape
    E = slots.shape[0]
    if E == 0:
        return out
    dtype = _KERNEL_DTYPES[vecs.dtype]
    with torch.cuda.device(vecs.device):
        lib = cuda_lib.library()
        route = PIPE_ROUTES[lib.dst_gather_pipelined_route(vecs.data_ptr(), q.data_ptr(), D,
                                                           dtype)]
        tile, group = pipelined_tiling(route, D * vecs.element_size(), L, E)
        rc = lib.dst_gather_pipelined(
            vecs.data_ptr(), slots.data_ptr(), q.data_ptr(), out.data_ptr(),
            E, n_exp, L, D, tile, group, dtype, torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "gather_score_pipelined")
    gather_score_pipelined_kernel.launches += 1
    gather_score_pipelined_kernel.launches_by_route[route] += 1
    return out


def stream_pieces(slots: np.ndarray, cap: int = STREAM_PIECE) -> np.ndarray:
    """int32 offsets ``(n_pieces + 1,)`` cutting the entries into runs of
    equal consecutive slot, each at most ``cap`` entries long."""
    slots = np.asarray(slots)
    n = len(slots)
    if n == 0:
        return np.zeros(1, np.int32)
    starts = np.flatnonzero(np.concatenate([[True], slots[1:] != slots[:-1]]))
    lens = np.diff(np.append(starts, n))
    per_run = -(-lens // cap)
    first = np.repeat(np.cumsum(per_run) - per_run, per_run)
    piece_starts = np.repeat(starts, per_run) + cap * (np.arange(per_run.sum()) - first)
    return np.append(piece_starts, n).astype(np.int32)


def gather_score_streamed_kernel(vecs, q, slots, pieces=None):
    """Launch the streamed kernel of ``csrc/gather_score.cu``. ``pieces``
    (from :func:`stream_pieces`, host or device) is computed here from the
    slots when not given."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    slots, q, out = _check_kernel(vecs, slots, q, "gather_score_streamed")
    n_exp, L, D = vecs.shape
    if slots.shape[0] == 0:
        return out
    if pieces is None:
        pieces = stream_pieces(slots.cpu().numpy())
    pieces = torch.as_tensor(pieces, dtype=torch.int32).to(vecs.device).contiguous()
    tile = _pow2_rows(STREAM_TILE_BYTES, D * vecs.element_size(), L)
    with torch.cuda.device(vecs.device):
        rc = cuda_lib.library().dst_gather_streamed(
            vecs.data_ptr(), slots.data_ptr(), q.data_ptr(), out.data_ptr(),
            pieces.data_ptr(), pieces.shape[0] - 1, n_exp, L, D, tile,
            _KERNEL_DTYPES[vecs.dtype], torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "gather_score_streamed")
    gather_score_streamed_kernel.launches += 1
    return out


gather_score_serial_kernel.launches = 0
gather_score_pipelined_kernel.launches = 0
gather_score_pipelined_kernel.launches_by_route = dict.fromkeys(PIPE_ROUTES, 0)
gather_score_streamed_kernel.launches = 0


def _dispatch(t, kernel, plain):
    if t.is_cuda:
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"gather_score: unsupported device {t.device}")


def gather_score_serial(vecs, slots, q):
    return _dispatch(vecs, gather_score_serial_kernel, gather_score_plain)(vecs, slots, q)


def gather_score_pipelined(vecs, slots, q):
    return _dispatch(vecs, gather_score_pipelined_kernel, gather_score_plain)(vecs, slots, q)


def gather_score_streamed(vecs, q, slots, pieces=None):
    kernel = _dispatch(vecs, gather_score_streamed_kernel, None)
    if kernel is None:
        return gather_score_plain(vecs, slots, q)
    return kernel(vecs, q, slots, pieces)
