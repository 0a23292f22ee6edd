"""The MIPS sweep kernels' CUDA sources, run on the CPU under an emulation.

``dpr_scale_tpu_torch/csrc/mips_scan.cu``, ``count_groups.cu`` and
``int_scan.cu`` need the card; here g++ builds the same sources against
``tests/cuda_emu``, which defines the CUDA features they use on the host and
puts the PTX ISA's definitions of TMA (bf16 and byte tensor maps, the
128-byte swizzle, zero fill), 4-byte cp.async with zero fill and
their ``.noinc`` mbarrier arrivals, mbarriers, wgmma from K-major descriptors
(bf16 and s8), mma.sync m16n8k32 and wmma in place of
``csrc/hopper_ptx.cuh`` and ``<mma.h>``. The entry points then run on CPU
tensors: ``dst_groupmax`` / ``dst_int_groupmax`` are held against
``groupmax_plain`` (within MAX_REL of max |ref|, the card's tolerance) and
``int_groupmax_plain`` (values and rows exactly equal): both block layouts
(64 and 128 queries), ragged spans and query tiles, one and two planes, int8
and packed int4, ties between duplicate rows, and the shape-routed older
kernels (D = 100 on the bf16 sweeps' cp.async route, D = 101 on the score
tile). ``dst_count_above_groups`` / ``dst_count_above`` are held exactly
equal to ``count_above_groups_plain`` / ``count_above_plain`` on
integer-valued inputs (every summation order gives the same fp32 score),
with thresholds equal to some scores (the comparison is strict), negative
thresholds where rows past N would score 0, both layouts, ragged spans,
tiles and query tiles, group widths on both routes. ``dst_tile_max`` is
held against ``tile_max_scores_plain`` (within MAX_REL): both layouts,
ragged query tiles, 256-row tiles (a block holds several, its last span
ragged), 768- and 4,096-row tiles, tiles on the older kernel, and maxima
that lie in each tile's last row. ``dst_int8_tile_max`` is held exactly
equal to ``int8_tile_max_plain``: both layouts, ragged query tiles, tiles
of 256 to 4,096 rows, D of 16 to 768, all-negative maxima, maxima in each
tile's last row, and the older kernel's shapes. The four bf16 sweeps on
the cp.async route (rows TMA cannot address) are held exactly equal to
plain on integer inputs: D = 100 from 16- and 4-byte aligned bases, D =
102 on both block layouts, spans cut to fill the emulated
card, and the 2-byte aligned bases that leave it for the score tile. Lone
K-major wgmmas
are held against ``torch.mm`` and an exact integer product first, so that a
slip in the emulation itself fails on its own. Skips where no g++ is found.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.ops import int_kernels as ik
from dpr_scale_tpu_torch.ops import mips_kernels as mk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "dpr_scale_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
SOURCES = ("mips_scan.cu", "count_groups.cu", "int_scan.cu", "score_tile.cuh", "int_tile.cuh",
           "gmax_sweep.cuh")
MAX_REL = 2e-5  # chip_smoke.MAX_REL: fp32 sums of the same products in another order


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels' C entry points and the wgmma self-tests, built against
    the emulation."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' sources for the host")
    src = tmp_path_factory.mktemp("mips_emulated")
    for name in SOURCES:
        shutil.copy(os.path.join(CSRC, name), src / name)
    shutil.copy(os.path.join(EMU, "hopper_ptx.cuh"), src / "hopper_ptx.cuh")
    lib = src / "libmips_emulated.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{EMU}", "-x", "c++",
         str(src / "mips_scan.cu"), str(src / "count_groups.cu"), str(src / "int_scan.cu"),
         os.path.join(EMU, "wgmma_selftest.cpp"), os.path.join(EMU, "emu.cpp"), "-o", str(lib)],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(str(lib))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    dll.dst_count_above_groups.argtypes = [p, p, p, p, i, ll, i, ll, i, p]
    dll.dst_count_above_groups.restype = i
    dll.dst_count_above_groups_route.argtypes = [p, p, ll, i, ll, i]
    dll.dst_count_above_groups_route.restype = i
    dll.dst_count_above.argtypes = [p, p, p, p, i, ll, i, i, p]
    dll.dst_count_above.restype = i
    dll.dst_count_above_route.argtypes = [p, p, ll, i, i]
    dll.dst_count_above_route.restype = i
    dll.dst_groupmax.argtypes = [p, p, p, p, i, ll, i, i, p]
    dll.dst_groupmax.restype = i
    dll.dst_groupmax_route.argtypes = [p, p, ll, i, i]
    dll.dst_groupmax_route.restype = i
    dll.dst_tile_max.argtypes = [p, p, p, i, ll, i, ll, i, p]
    dll.dst_tile_max.restype = i
    dll.dst_tile_max_route.argtypes = [p, p, ll, i, ll, i]
    dll.dst_tile_max_route.restype = i
    dll.dst_bf16_sweep_span.argtypes = [ll, i, i]
    dll.dst_bf16_sweep_span.restype = ll
    dll.dst_int_groupmax.argtypes = [p] * 6 + [i, ll, i, i, i, f, p]
    dll.dst_int_groupmax.restype = i
    dll.dst_int_groupmax_route.argtypes = [p, p, i, i]
    dll.dst_int_groupmax_route.restype = i
    dll.dst_int8_tile_max.argtypes = [p, p, p, i, ll, i, ll, p]
    dll.dst_int8_tile_max.restype = i
    dll.dst_int8_tile_max_route.argtypes = [p, p, ll, i, ll]
    dll.dst_int8_tile_max_route.restype = i
    dll.emu_wgmma_tn_selftest.argtypes = [p, p, p, i, i, i]
    dll.emu_wgmma_tn_selftest.restype = i
    return dll


@pytest.mark.parametrize("by_tma", [False, True])
@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("kind", ["bf16", "s8"])
def test_emulated_kmajor_wgmma_matches_mm(emulated, kind, n, by_tma):
    """Four k-steps of wgmma with both operands K-major from swizzled shared
    memory (laid out by hand, or by the emulated TMA): bf16 against torch.mm
    in fp32, s8 exactly against an int64 product."""
    rng = np.random.default_rng(n + by_tma + (kind == "s8"))
    if kind == "bf16":
        a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).bfloat16()
        b = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32)).bfloat16()
        d = torch.full((64, n), float("nan"))
        want = a.float() @ b.float().T
    else:
        a = torch.from_numpy(rng.integers(-128, 128, (64, 128), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-128, 128, (n, 128), dtype=np.int8))
        d = torch.full((64, n), -1, dtype=torch.int32)
        want = (a.long() @ b.long().T).int()
    rc = emulated.emu_wgmma_tn_selftest(a.data_ptr(), b.data_ptr(), d.data_ptr(), n,
                                        int(kind == "s8"), by_tma)
    assert rc == 0
    if kind == "bf16":
        torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-4)
    else:
        assert torch.equal(d, want)


def _groupmax(emulated, q, c):
    B, N, D = q.shape[0], c.shape[0], c.shape[1]
    t1 = torch.full((N // 8, B), float("nan"))
    t2 = torch.full((N // 128, B), float("nan"))
    dtype = {torch.bfloat16: 0, torch.float32: 1}[c.dtype]
    assert emulated.dst_groupmax(q.data_ptr(), c.data_ptr(), t1.data_ptr(), t2.data_ptr(), B, N,
                                 D, dtype, None) == 0
    route = emulated.dst_groupmax_route(q.data_ptr(), c.data_ptr(), N, D, dtype)
    return t1, t2, route


# (B, N, D, dtype, route): 64-query blocks with a ragged last span (2,048 +
# 384 rows: its last 256-row tile half filled), two k-slices, one query, and
# 128-query blocks whose second query tile is ragged over a D that ends
# mid-slice; D = 100 on the cp.async route; then the older kernel at D =
# 101 (bf16) and for fp32
GROUPMAX_CASES = [
    (7, 2432, 64, torch.bfloat16, 1),
    (64, 640, 128, torch.bfloat16, 1),
    (1, 384, 16, torch.bfloat16, 1),
    (130, 2432, 48, torch.bfloat16, 1),
    (7, 384, 100, torch.bfloat16, 2),
    (7, 384, 101, torch.bfloat16, 0),
    (5, 256, 64, torch.float32, 0),
]


@pytest.mark.parametrize("B,N,D,dtype,route", GROUPMAX_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-{str(c[3])[6:]}" for c in GROUPMAX_CASES])
def test_emulated_groupmax_matches_plain(emulated, B, N, D, dtype, route):
    """dst_groupmax: t1 and t2 within MAX_REL of max |ref|, every entry
    written, on the route its shape selects."""
    rng = np.random.default_rng(B * N + D)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dtype)
    c = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(dtype)
    t1, t2, got_route = _groupmax(emulated, q, c)
    assert got_route == route
    for got, want in zip((t1, t2), mk.groupmax_plain(q, c)):
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= MAX_REL * want.abs().max().item()


def _count_inputs(B, N, D, dtype, negative, seed):
    """Queries and rows of small integers (exact in bf16; every product and
    every sum of them exact in fp32, in any order) and, per query, a
    threshold equal to the score of one of its rows: a negative score where
    ``negative`` (so the rows past N, which score 0, lie above it), else one
    near the top. Returns q, c, tau and the exact scores."""
    rng = np.random.default_rng(seed)
    q, c = (torch.from_numpy(rng.integers(-3, 4, size=shape).astype(np.float32))
            for shape in ((B, D), (N, D)))
    s = q.double() @ c.double().T
    ranked = torch.sort(s, dim=1).values
    pick = int(0.25 * N) if negative else int(0.97 * N)
    tau = ranked[:, pick].float()
    return q.to(dtype), c.to(dtype), tau.contiguous(), s


def _assert_count_inputs_test_the_traps(s, tau, negative):
    assert (s == tau[:, None].double()).any(1).all()  # rows at tau: > is strict
    if negative:
        assert (tau < 0).all()  # a zero-filled row past N would count


def _dtype_code(dtype):
    return {torch.bfloat16: 0, torch.float32: 1}[dtype]


# (B, N, D, dtype, group, negative tau, route): 64-query blocks over a ragged
# span of 128-row groups whose last 256-row tile is half past N; over a
# ragged span of 256-row groups (two warpgroups' halves a group); 128-query
# blocks with queries past B, two k-slices; four query tiles, 512-row
# groups over a D that ends mid-slice; 384-row groups across tiles and
# spans; one 1,152-row group at D = 100 (the cp.async route); then the
# older kernel: the same at D = 101, fp32, and a 192-row group
COUNT_GROUPS_CASES = [
    (1, 2432, 64, torch.bfloat16, 128, True, 1),
    (64, 2816, 64, torch.bfloat16, 256, False, 1),
    (70, 2048, 128, torch.bfloat16, 256, True, 1),
    (512, 2048, 32, torch.bfloat16, 512, False, 1),
    (70, 4608, 64, torch.bfloat16, 384, True, 1),
    (5, 1152, 100, torch.bfloat16, 1152, True, 2),
    (5, 1152, 101, torch.bfloat16, 1152, True, 0),
    (5, 512, 64, torch.float32, 256, False, 0),
    (7, 768, 64, torch.bfloat16, 192, True, 0),
]


@pytest.mark.parametrize(
    "B,N,D,dtype,group,negative,route", COUNT_GROUPS_CASES,
    ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-{str(c[3])[6:]}-g{c[4]}{'-neg' if c[5] else ''}"
         for c in COUNT_GROUPS_CASES])
def test_emulated_count_above_groups_equals_plain(emulated, B, N, D, dtype, group, negative,
                                                  route):
    """dst_count_above_groups: every count exactly equal to
    count_above_groups_plain (every entry written over a garbage-filled
    output), on the route its shape selects."""
    q, c, tau, s = _count_inputs(B, N, D, dtype, negative, B + N + D + group)
    _assert_count_inputs_test_the_traps(s, tau, negative)
    out = torch.full((B, N // group), -7, dtype=torch.int32)
    code = _dtype_code(dtype)
    assert emulated.dst_count_above_groups(q.data_ptr(), c.data_ptr(), tau.data_ptr(),
                                           out.data_ptr(), B, N, D, group, code, None) == 0
    assert emulated.dst_count_above_groups_route(q.data_ptr(), c.data_ptr(), N, D, group,
                                                 code) == route
    assert torch.equal(out, mk.count_above_groups_plain(q, c, tau, group))


# (B, N, D, dtype, negative tau, route): one span + 77 rows (a ragged last
# tile, half of its first unit past N) on 64-query blocks; two spans + 77 on
# 128-query blocks with queries past B; four query tiles over 16 columns;
# D = 100 on the cp.async route; then the older kernel at D = 101 and for
# fp32
COUNT_ABOVE_CASES = [
    (1, 2048 + 77, 64, torch.bfloat16, True, 1),
    (64, 2048 + 77, 64, torch.bfloat16, False, 1),
    (70, 2 * 2048 + 77, 128, torch.bfloat16, True, 1),
    (512, 2048 + 77, 16, torch.bfloat16, False, 1),
    (7, 2048 + 77, 100, torch.bfloat16, True, 2),
    (7, 2048 + 77, 101, torch.bfloat16, True, 0),
    (5, 2048 + 77, 64, torch.float32, True, 0),
]


@pytest.mark.parametrize(
    "B,N,D,dtype,negative,route", COUNT_ABOVE_CASES,
    ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-{str(c[3])[6:]}{'-neg' if c[4] else ''}"
         for c in COUNT_ABOVE_CASES])
def test_emulated_count_above_equals_plain(emulated, B, N, D, dtype, negative, route):
    """dst_count_above: every count exactly equal to count_above_plain, on
    the route its shape selects."""
    q, c, tau, s = _count_inputs(B, N, D, dtype, negative, B + N + D)
    _assert_count_inputs_test_the_traps(s, tau, negative)
    out = torch.zeros(B, dtype=torch.int32)  # the entry point's contract: blocks add into it
    code = _dtype_code(dtype)
    assert emulated.dst_count_above(q.data_ptr(), c.data_ptr(), tau.data_ptr(), out.data_ptr(),
                                    B, N, D, code, None) == 0
    assert emulated.dst_count_above_route(q.data_ptr(), c.data_ptr(), N, D, code) == route
    assert torch.equal(out, mk.count_above_plain(q, c, tau))


def _sweep(emulated, name, q, c, tau, size):
    """One bf16 sweep's entry point on q, c: (its output, its plain
    version's, the route it took). ``size``: the group (counts per group)
    or the tile (tile maxima); groupmax returns t1 and t2 as one vector."""
    B, N, D = q.shape[0], c.shape[0], c.shape[1]
    qp, cp = q.data_ptr(), c.data_ptr()
    if name == "groupmax":
        t1, t2, route = _groupmax(emulated, q, c)
        return (torch.cat([t1.flatten(), t2.flatten()]),
                torch.cat([w.flatten() for w in mk.groupmax_plain(q, c)]), route)
    if name == "count_above_groups":
        out = torch.full((B, N // size), -7, dtype=torch.int32)
        rc = emulated.dst_count_above_groups(qp, cp, tau.data_ptr(), out.data_ptr(), B, N, D,
                                             size, 0, None)
        route = emulated.dst_count_above_groups_route(qp, cp, N, D, size, 0)
        want = mk.count_above_groups_plain(q, c, tau, size)
    elif name == "count_above":
        out = torch.zeros(B, dtype=torch.int32)  # the entry point's contract: blocks add into it
        rc = emulated.dst_count_above(qp, cp, tau.data_ptr(), out.data_ptr(), B, N, D, 0, None)
        route = emulated.dst_count_above_route(qp, cp, N, D, 0)
        want = mk.count_above_plain(q, c, tau)
    else:
        out = torch.full((B, N // size), float("nan"))
        rc = emulated.dst_tile_max(qp, cp, out.data_ptr(), B, N, D, size, 0, None)
        route = emulated.dst_tile_max_route(qp, cp, N, D, size, 0)
        want = mk.tile_max_scores_plain(q, c, size)
    assert rc == 0
    return out, want, route


def _offset(t, elems):
    """t's values in a tensor whose storage starts ``elems`` elements into
    its buffer (bf16: bases aligned to 2 x elems bytes, not 64)."""
    view = torch.empty(t.numel() + elems, dtype=t.dtype)[elems:].view(t.shape)
    view.copy_(t)
    return view


# (B, N, D, base offset in elements, span, route): D % 4 == 0 over two
# spans (two blocks fill the emulated card's 2 SMs), the second ragged;
# the same D from 4-byte aligned bases over 1,280 rows under one query
# tile, whose span fill_span cuts from 2,048 to 768 rows (two blocks of
# three tiles, one wave); D = 102 on 128-query blocks with a ragged query
# tile, and under one 64-query tile; 2-byte aligned bases, which the score
# tile takes
CP_ASYNC_CASES = [
    (7, 2048 + 512, 100, 0, 2048, 2),
    (9, 1280, 100, 2, 768, 2),
    (70, 768, 102, 0, 512, 2),
    (9, 1280, 102, 0, 768, 2),
    (5, 512, 102, 1, 256, 0),
]


@pytest.mark.parametrize("B,N,D,offset,span,route", CP_ASYNC_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-off{c[3]}" for c in CP_ASYNC_CASES])
@pytest.mark.parametrize("name", ["count_above_groups", "count_above", "groupmax", "tile_max"])
def test_emulated_cp_async_route_equals_plain(emulated, name, B, N, D, offset, span, route):
    """The bf16 sweeps over rows TMA cannot address: each output exactly
    equal to plain on integer-valued inputs (thresholds at some scores, the
    rows past N above the negative ones), 256-row groups and tiles, on the
    route the shape and the bases select; groupmax and the counts over the
    span fill_span gives them."""
    q, c, tau, s = _count_inputs(B, N, D, torch.bfloat16, True, B + N + D + offset)
    _assert_count_inputs_test_the_traps(s, tau, True)
    q, c = _offset(q, offset), _offset(c, offset)
    assert emulated.dst_bf16_sweep_span(N, B, D) == span
    out, want, got_route = _sweep(emulated, name, q, c, tau, 256)
    assert got_route == route
    assert torch.equal(out, want)


def _int_inputs(B, N, D, packed, planes, seed, dup=False):
    """Random query planes and corpus bytes (every nibble), row scales
    U(0.5, 1.5), query scales U(0.01, 0.1); with ``dup`` every 8-row group
    repeats three of its rows (bytes and scale), so the maxima tie."""
    rng = np.random.default_rng(seed)
    W = D // 2 if packed else D
    q8 = rng.integers(-127, 128, size=(planes * B, D), dtype=np.int8)
    c = rng.integers(-128, 128, size=(N, W), dtype=np.int8)
    sc = rng.uniform(0.5, 1.5, size=N).astype(np.float32)
    if dup:
        src = (np.arange(N) // 8) * 8 + np.arange(N) % 8 % 3
        c, sc = c[src], sc[src]
    qsc = rng.uniform(0.01, 0.1, size=B).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (q8, c, sc, qsc))


def _int_groupmax(emulated, q8, c, sc, qsc, packed, planes, want_rows):
    B, N, D = qsc.shape[0], c.shape[0], q8.shape[1]
    vals = torch.full((N // 8, B), float("nan"))
    rows = torch.full((N // 8, B), -1, dtype=torch.int32) if want_rows else None
    assert emulated.dst_int_groupmax(
        q8.data_ptr(), c.data_ptr(), sc.data_ptr(), qsc.data_ptr(), vals.data_ptr(),
        rows.data_ptr() if want_rows else None, B, N, D, int(packed), planes, ik.INV127,
        None) == 0
    return vals, rows, emulated.dst_int_groupmax_route(q8.data_ptr(), c.data_ptr(), D,
                                                       int(packed))


# (B, N, D, packed, planes, dup, route): int8 on 64-query blocks over a
# ragged span, on 128-query blocks with two query tiles, two planes over two
# k-slices; packed on one query, over a ragged span, two planes over three
# query tiles; duplicate rows in each form; then the older kernel (int8 at
# D = 100, packed at D / 2 = 24)
INT_CASES = [
    (7, 2432, 128, False, 1, False, 1),
    (130, 640, 128, False, 1, False, 1),
    (64, 640, 256, False, 2, False, 1),
    (1, 384, 64, True, 1, False, 1),
    (7, 2432, 256, True, 1, False, 1),
    (130, 384, 512, True, 2, False, 1),
    (9, 640, 128, False, 1, True, 1),
    (70, 384, 128, False, 1, True, 1),
    (9, 640, 128, True, 2, True, 1),
    (7, 384, 100, False, 1, False, 0),
    (7, 384, 48, True, 2, True, 0),
]


@pytest.mark.parametrize(
    "B,N,D,packed,planes,dup,route", INT_CASES,
    ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-{'int4' if c[3] else 'int8'}-p{c[4]}{'-dup' if c[5] else ''}"
         for c in INT_CASES])
def test_emulated_int_groupmax_equals_plain(emulated, B, N, D, packed, planes, dup, route):
    """dst_int_groupmax: values and rows exactly equal to int_groupmax_plain
    (ties to the first row), and without rows the same values, on the route
    its shape selects."""
    q8, c, sc, qsc = _int_inputs(B, N, D, packed, planes, B + N + D + planes, dup)
    vals, rows, got_route = _int_groupmax(emulated, q8, c, sc, qsc, packed, planes, True)
    assert got_route == route
    want_v, want_r = ik.int_groupmax_plain(q8, c, sc, qsc, packed=packed, planes=planes)
    assert torch.equal(vals, want_v)
    assert torch.equal(rows, want_r)
    if dup:
        assert (want_r % 8 < 3).all()  # the ties were there, and went to the first row
    bare, _none, _route = _int_groupmax(emulated, q8, c, sc, qsc, packed, planes, False)
    assert torch.equal(bare, want_v)


def _tile_max_inputs(B, N, D, tile, last_row, seed):
    """Random queries and rows; with ``last_row`` the queries are positive
    and each tile's last row is all 3, so every maximum lies there."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    c = rng.standard_normal((N, D)).astype(np.float32)
    if last_row:
        q = np.abs(q) + 0.1
        c[tile - 1 :: tile] = 3.0
    return torch.from_numpy(q), torch.from_numpy(c)


# (B, N, D, dtype, tile, last row, route): 64-query blocks over two
# 4,096-row tiles; 128-query blocks, three query tiles (the last ragged)
# over a D that ends mid-slice; 256-row tiles, eight a block, the last span
# of three; 768-row tiles (two a block) over two k-slices; the maxima in
# each tile's last row, in both layouts; D = 100 on the cp.async route;
# then the older kernel: a 300-row tile, D = 101, fp32
TILE_MAX_CASES = [
    (7, 2 * 4096, 64, torch.bfloat16, 4096, False, 1),
    (130, 4096, 48, torch.bfloat16, 4096, False, 1),
    (64, 11 * 256, 64, torch.bfloat16, 256, False, 1),
    (70, 3 * 768, 128, torch.bfloat16, 768, False, 1),
    (9, 2 * 4096, 64, torch.bfloat16, 4096, True, 1),
    (130, 4 * 256, 32, torch.bfloat16, 256, True, 1),
    (5, 3 * 300, 64, torch.bfloat16, 300, True, 0),
    (7, 2 * 256, 100, torch.bfloat16, 256, False, 2),
    (7, 2 * 256, 101, torch.bfloat16, 256, False, 0),
    (5, 2 * 256, 64, torch.float32, 256, False, 0),
]


@pytest.mark.parametrize(
    "B,N,D,dtype,tile,last_row,route", TILE_MAX_CASES,
    ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-{str(c[3])[6:]}-t{c[4]}{'-last' if c[5] else ''}"
         for c in TILE_MAX_CASES])
def test_emulated_tile_max_matches_plain(emulated, B, N, D, dtype, tile, last_row, route):
    """dst_tile_max: every tile's maximum within MAX_REL of max |ref| of
    tile_max_scores_plain, every entry written, on the route its shape
    selects."""
    q, c = (t.to(dtype) for t in _tile_max_inputs(B, N, D, tile, last_row, B + N + D))
    out = torch.full((B, N // tile), float("nan"))
    code = _dtype_code(dtype)
    assert emulated.dst_tile_max(q.data_ptr(), c.data_ptr(), out.data_ptr(), B, N, D, tile, code,
                                 None) == 0
    assert emulated.dst_tile_max_route(q.data_ptr(), c.data_ptr(), N, D, tile, code) == route
    want = mk.tile_max_scores_plain(q, c, tile)
    if last_row:  # the trap is live: each maximum is the last row's score
        last = q.float() @ c[tile - 1 :: tile].float().T
        assert torch.equal(want, last)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() <= MAX_REL * want.abs().max().item()


def _int8_tile_max_inputs(B, N, D, tile, kind, seed):
    """Random int8 queries and rows; ``neg``: positive queries against
    negative rows, so every dot (and maximum) is negative; ``last``: positive
    queries and each tile's last row all 127, so every maximum lies there."""
    rng = np.random.default_rng(seed)
    q8 = rng.integers(1 if kind != "rand" else -127, 128, size=(B, D), dtype=np.int8)
    c = rng.integers(-128, 0 if kind == "neg" else 128, size=(N, D), dtype=np.int8)
    if kind == "last":
        c[tile - 1 :: tile] = 127
    return torch.from_numpy(q8), torch.from_numpy(c)


# (B, N, D, tile, kind, route): 64-query blocks over one 4,096-row tile (a
# block walks 16 units, two spans' worth) with each maximum in its last row;
# 256-row tiles, eight a block, the last span of three; 128-query blocks
# over one ragged query tile, 768-row tiles (two a block, the last span of
# one) over a D that ends mid-slice; the tool's 2,048-row tile over D = 768
# (six k-slices); all-negative maxima in both layouts over ragged query
# tiles; maxima in each 256-row tile's last row on 128-query blocks; two
# 4,096-row tiles over two query tiles; the tool's tile at D = 768 with the
# maxima in each last row on 128-query blocks; then the older kernel: a
# 300-row tile, D = 100
INT8_TILE_MAX_CASES = [
    (7, 4096, 16, 4096, "last", 1),
    (64, 11 * 256, 64, 256, "rand", 1),
    (100, 3 * 768, 96, 768, "rand", 1),
    (9, 2048, 768, 2048, "rand", 1),
    (9, 5 * 256, 128, 256, "neg", 1),
    (130, 2 * 256, 128, 256, "neg", 1),
    (100, 4 * 256, 32, 256, "last", 1),
    (130, 2 * 4096, 64, 4096, "rand", 1),
    (70, 2 * 2048, 768, 2048, "last", 1),
    (5, 3 * 300, 64, 300, "rand", 0),
    (7, 2 * 256, 100, 256, "rand", 0),
]


@pytest.mark.parametrize("B,N,D,tile,kind,route", INT8_TILE_MAX_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-t{c[3]}-{c[4]}"
                              for c in INT8_TILE_MAX_CASES])
def test_emulated_int8_tile_max_equals_plain(emulated, B, N, D, tile, kind, route):
    """dst_int8_tile_max: every tile's maximum exactly equal to
    int8_tile_max_plain (every entry written over a garbage-filled output),
    on the route its shape selects."""
    q8, c = _int8_tile_max_inputs(B, N, D, tile, kind, B + N + D + tile)
    out = torch.full((N // tile, B), 12345, dtype=torch.int32)
    assert emulated.dst_int8_tile_max(q8.data_ptr(), c.data_ptr(), out.data_ptr(), B, N, D, tile,
                                      None) == 0
    assert emulated.dst_int8_tile_max_route(q8.data_ptr(), c.data_ptr(), N, D, tile) == route
    want = ik.int8_tile_max_plain(q8, c, tile)
    if kind == "neg":  # the trap is live: 0 (zero-filled queries, a 0 start) is above every max
        assert (want < 0).all()
    if kind == "last":  # the trap is live: each maximum is the last row's dot, and only its
        dots = (c.long() @ q8.long().T).view(N // tile, tile, B)
        assert torch.equal(want.long(), dots[:, -1]) and (dots[:, :-1] < dots[:, -1:]).all()
    assert torch.equal(out, want)
