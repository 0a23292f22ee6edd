"""One-sweep reductions of integer inner-product scores: the sweeps of the
quantised MIPS tiers (``MipsIndex`` ``method="int8"`` / ``"int4"``).

Counterparts of the two Pallas kernels of ``tools/microbench_int4_kernel.py``
(``csrc/int_scan.cu``). Queries come quantised, ``q8 (planes * B, D)`` int8
(plane 2, when present, is rows ``B ..`` as the JAX search concatenates
them); the corpus is int8 ``(N, D)`` or, ``packed``, int4 nibbles ``(N, D/2)``
in the column-block layout of ``MipsIndex._quantize_int4_host`` (byte j
holds dim j in its low nibble and dim j + D/2 in its high nibble):

* :func:`int_groupmax` ``(vals (N // 8, B) fp32, rows (N // 8, B) int32 |
  None)`` — per 8-row group, the max of the dequantised scores and its row
  (the first on ties, as ``jnp.argmax``), N % 128 == 0. With ``packed`` and
  one plane it is ``i4_groupmax`` (``:160``); the dequantised score is the
  JAX search's ``float32(int32 dot) * row_scale * q_scale`` in that order,
  with two planes ``(s_hi + s_lo * float32(1/127)) * row_scale * q_scale``.
  ``want_rows=False`` skips the argmax (the search rescores whole groups).
  Widths TMA can address take the wgmma kernel, the rest the older int8
  tile (``int_groupmax_kernel.launches_by_route`` counts each);
* :func:`int8_tile_max` ``(N // tile, B)`` int32 — the max integer dot of
  each ``tile``-row tile, N % tile == 0: ``pallas_dot`` (``:111``), the
  tool's int8 baseline (no caller in either package). Widths TMA can
  address in tiles of a multiple of 256 rows take the wgmma kernel, the
  rest the int8 tile (``int8_tile_max_kernel.launches_by_route``).

Each comes as ``<name>_plain`` (plain PyTorch: the CPU path and the oracle;
the integer dot is a float64 matmul, exact since |sum| <= D * 128 * 128 <
2**53, chunk by chunk), ``<name>_kernel`` (the hand-written CUDA kernel;
``.launches`` counts its launches) and ``<name>`` (dispatch: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises).
"""
from __future__ import annotations

import numpy as np
import torch

GMAX_ROWS = 8  # corpus rows per group of int_groupmax
SPAN_ROWS = 128  # int_groupmax needs whole 128-row score tiles
TILE_ROWS = 2048  # rows per int8_tile_max tile (the tool's TN)
PLAIN_CHUNK_ROWS = 131072  # rows the plain versions score at once
# float32(1/127): the weight of the second query plane, as the JAX search's
# ``sf[B:] * (1.0 / 127.0)`` rounds it
INV127 = float(np.float32(1.0 / 127.0))


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., D/2) int8 nibbles -> (..., D) int8 in [-8, 7], the tool's
    formula on int32: ``((p & 0xF) ^ 8) - 8`` for the low nibble (the first
    D/2 dims), the arithmetic ``p >> 4`` for the high one."""
    p = packed.to(torch.int32)
    return torch.cat([((p & 0xF) ^ 8) - 8, p >> 4], dim=-1).to(torch.int8)


def _combine(s: torch.Tensor, planes: int, B: int) -> torch.Tensor:
    """fp32 scores of the planes' exact integer dots along dim 0: the second
    plane adds at INV127, a product and a sum rounded apart."""
    s = s.float()
    if planes == 2:
        return s[:B] + s[B:] * INV127
    return s


def int_scores(q8, corpus, row_scales, q_scales, *, packed: bool, planes: int = 1):
    """(B, n) fp32 dequantised scores of the ``n`` corpus rows, the kernels'
    arithmetic: the exact integer dot (float64), the planes combined, then
    ``* row_scale * q_scale``."""
    x = unpack_int4(corpus) if packed else corpus
    s = torch.matmul(q8.double(), x.double().T)  # (planes * B, n), exact integers
    return _combine(s, planes, q_scales.shape[0]) * row_scales[None, :] * q_scales[:, None]


def int_rescore(q8, rows, row_scales, q_scales, *, packed: bool, planes: int = 1):
    """The same arithmetic on rows of each query's own: ``rows (B, R, W)``,
    ``row_scales (B, R)`` -> (B, R) fp32."""
    B = q_scales.shape[0]
    x = unpack_int4(rows) if packed else rows
    qp = q8.view(planes, B, -1).permute(1, 2, 0).double()  # (B, D, planes)
    s = torch.bmm(x.double(), qp).permute(2, 0, 1).reshape(planes * B, -1)
    return _combine(s, planes, B).view(B, -1) * row_scales * q_scales[:, None]


def _check(what, q8, corpus, *, packed: bool, planes: int, divisor: int):
    if q8.dtype != torch.int8 or corpus.dtype != torch.int8:
        raise ValueError(f"{what}: int8 queries and corpus, got {q8.dtype} and {corpus.dtype}")
    if planes not in (1, 2):
        raise ValueError(f"{what}: planes must be 1 or 2, got {planes}")
    width = q8.shape[1] // 2 if packed else q8.shape[1]
    if (q8.dim() != 2 or corpus.dim() != 2 or q8.shape[0] % planes
            or corpus.shape[1] != width or (packed and q8.shape[1] % 2)):
        raise ValueError(
            f"{what}: queries {tuple(q8.shape)} ({planes} planes) and "
            f"{'packed ' if packed else ''}corpus {tuple(corpus.shape)} do not agree"
        )
    if divisor < 1 or corpus.shape[0] % divisor:
        raise ValueError(f"{what}: {divisor} must divide the corpus rows {corpus.shape[0]}")


def _check_scales(what, q8, corpus, row_scales, q_scales, planes):
    B = q8.shape[0] // planes
    if row_scales.shape != (corpus.shape[0],) or q_scales.shape != (B,):
        raise ValueError(
            f"{what}: row scales {tuple(row_scales.shape)} and query scales "
            f"{tuple(q_scales.shape)} do not match {corpus.shape[0]} rows and {B} queries"
        )


def _kernel_inputs(what, *tensors):
    """Refuse what the CUDA kernels cannot take."""
    dev = tensors[0].device
    if not tensors[0].is_cuda:
        raise ValueError(f"{what} kernel takes CUDA tensors, got {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what} kernel: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel: the tensors must be contiguous")


def _dispatch(what, corpus, kernel, plain, *args, **kwargs):
    if corpus.is_cuda:
        return kernel(*args, **kwargs)
    if corpus.device.type == "cpu":
        return plain(*args, **kwargs)
    raise ValueError(f"{what}: unsupported device {corpus.device}")


# --------------------------------------------------------------------- #
# per-group max and argmax (the sweep of method="int8" / "int4")


def int_groupmax_plain(q8, corpus, row_scales, q_scales, *, packed: bool, planes: int = 1,
                       want_rows: bool = True):
    _check("int_groupmax", q8, corpus, packed=packed, planes=planes, divisor=SPAN_ROWS)
    _check_scales("int_groupmax", q8, corpus, row_scales, q_scales, planes)
    B, N = q_scales.shape[0], corpus.shape[0]
    vals = torch.empty((N // GMAX_ROWS, B), dtype=torch.float32, device=corpus.device)
    rows = torch.empty_like(vals, dtype=torch.int32) if want_rows else None
    pos = torch.arange(GMAX_ROWS, device=corpus.device)[None, :, None]
    for lo in range(0, N, PLAIN_CHUNK_ROWS):
        hi = min(lo + PLAIN_CHUNK_ROWS, N)
        s = int_scores(q8, corpus[lo:hi], row_scales[lo:hi], q_scales,
                       packed=packed, planes=planes)
        t = s.T.reshape(-1, GMAX_ROWS, B)  # (groups, 8, B)
        m = t.amax(dim=1)
        vals[lo // GMAX_ROWS : hi // GMAX_ROWS] = m
        if want_rows:  # the first row holding the max, as jnp.argmax
            first = torch.where(t == m[:, None, :], pos, GMAX_ROWS).amin(dim=1)
            base = torch.arange(lo, hi, GMAX_ROWS, device=corpus.device)[:, None]
            rows[lo // GMAX_ROWS : hi // GMAX_ROWS] = (base + first).to(torch.int32)
    return vals, rows


def int_groupmax_kernel(q8, corpus, row_scales, q_scales, *, packed: bool, planes: int = 1,
                        want_rows: bool = True):
    """Launch ``csrc/int_scan.cu``'s group max on the current CUDA stream."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    _check("int_groupmax", q8, corpus, packed=packed, planes=planes, divisor=SPAN_ROWS)
    _check_scales("int_groupmax", q8, corpus, row_scales, q_scales, planes)
    if row_scales.dtype != torch.float32 or q_scales.dtype != torch.float32:
        raise ValueError("int_groupmax kernel takes fp32 scales")
    _kernel_inputs("int_groupmax", corpus, q8, row_scales, q_scales)
    B, N, D = q_scales.shape[0], corpus.shape[0], q8.shape[1]
    if N >= 2**31:
        raise ValueError(f"int_groupmax kernel: {N} rows do not fit its int32 row ids")
    vals = torch.empty((N // GMAX_ROWS, B), dtype=torch.float32, device=corpus.device)
    rows = torch.empty_like(vals, dtype=torch.int32) if want_rows else None
    with torch.cuda.device(corpus.device):
        lib = cuda_lib.library()
        route = ROUTES[lib.dst_int_groupmax_route(q8.data_ptr(), corpus.data_ptr(), D,
                                                  int(packed))]
        rc = lib.dst_int_groupmax(
            q8.data_ptr(), corpus.data_ptr(), row_scales.data_ptr(), q_scales.data_ptr(),
            vals.data_ptr(), rows.data_ptr() if want_rows else None,
            B, N, D, int(packed), planes, INV127,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "int_groupmax")
    int_groupmax_kernel.launches += 1
    int_groupmax_kernel.launches_by_route[route] += 1
    return vals, rows


# 0 and 1 of dst_int_groupmax_route and dst_int8_tile_max_route
ROUTES = ("int_tile", "wgmma")
int_groupmax_kernel.launches = 0
int_groupmax_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def int_groupmax(q8, corpus, row_scales, q_scales, *, packed: bool, planes: int = 1,
                 want_rows: bool = True):
    return _dispatch(
        "int_groupmax", corpus, int_groupmax_kernel, int_groupmax_plain,
        q8, corpus, row_scales, q_scales, packed=packed, planes=planes, want_rows=want_rows,
    )


# --------------------------------------------------------------------- #
# per-tile integer maxima (the tool's int8 baseline, no caller)


def int8_tile_max_plain(q8, corpus, tile: int = TILE_ROWS):
    _check("int8_tile_max", q8, corpus, packed=False, planes=1, divisor=tile)
    B, N = q8.shape[0], corpus.shape[0]
    out = torch.empty((N // tile, B), dtype=torch.int32, device=corpus.device)
    chunk = max(tile, PLAIN_CHUNK_ROWS // tile * tile)
    qd = q8.double()
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        s = torch.matmul(corpus[lo:hi].double(), qd.T)  # (rows, B), exact integers
        out[lo // tile : hi // tile] = s.view(-1, tile, B).amax(dim=1).to(torch.int32)
    return out


def int8_tile_max_kernel(q8, corpus, tile: int = TILE_ROWS):
    """Launch ``csrc/int_scan.cu``'s tile max on the current CUDA stream."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    _check("int8_tile_max", q8, corpus, packed=False, planes=1, divisor=tile)
    _kernel_inputs("int8_tile_max", corpus, q8)
    B, N, D = q8.shape[0], corpus.shape[0], q8.shape[1]
    out = torch.empty((N // tile, B), dtype=torch.int32, device=corpus.device)
    with torch.cuda.device(corpus.device):
        lib = cuda_lib.library()
        route = ROUTES[lib.dst_int8_tile_max_route(q8.data_ptr(), corpus.data_ptr(), N, D, tile)]
        rc = lib.dst_int8_tile_max(
            q8.data_ptr(), corpus.data_ptr(), out.data_ptr(), B, N, D, tile,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "int8_tile_max")
    int8_tile_max_kernel.launches += 1
    int8_tile_max_kernel.launches_by_route[route] += 1
    return out


int8_tile_max_kernel.launches = 0
int8_tile_max_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def int8_tile_max(q8, corpus, tile: int = TILE_ROWS):
    return _dispatch("int8_tile_max", corpus, int8_tile_max_kernel, int8_tile_max_plain,
                     q8, corpus, tile)
