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
tiles and query tiles, group widths on both routes. Pass 1 as the
wrapper drives it (``_topk``: ``mips_kernels.topk_select`` over
``dst_topk_select`` on the wgmma routes, ``mips_kernels._topk_sweeps`` over
``dst_tile_max`` and ``dst_topk_emit`` on the score tile) is held exactly
against ``topk_candidates_plain`` on integer-valued inputs (the same
scores, the same rows strictly above each query's kc-th score, ties to the
smaller row): both layouts, ragged n_valid and query tiles, all-negative
scores (the rows past n_valid score 0), ties at the kc-th score, fewer
than kc whole tiles, and D = 100 on the cp.async route, one select launch
a call whose every part's list holds its rows of the top kc, sorted
(``tests/test_torch_topk_select_emulated.py`` has the rest); on the score
tile (route 0) fp32 rows, D = 101 and a 2-byte aligned bf16 base, with
overflow reruns there; its candidate scores are the count kernel's bits
(``dst_count_above`` at the j-th candidate counts j rows above it);
arguments out of range are refused. ``dst_tile_max`` is
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

import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.ops import int_kernels as ik
from dpr_scale_tpu_torch.ops import mips_kernels as mk

import emulated_lib
import torch_threads  # noqa: F401  (one intra-op thread a worker)

SOURCES = ("mips_scan.cu", "count_groups.cu", "int_scan.cu", "topk_sweep.cu", "score_tile.cuh",
           "int_tile.cuh", "gmax_sweep.cuh")
MAX_REL = 2e-5  # chip_smoke.MAX_REL: fp32 sums of the same products in another order


@pytest.fixture(scope="module")
def emulated():
    """The kernels' C entry points and the wgmma self-tests, built against
    the emulation."""
    dll = emulated_lib.build("mips_emulated", SOURCES,
                             ("mips_scan.cu", "count_groups.cu", "int_scan.cu",
                              "topk_sweep.cu"),
                             emu_units=("wgmma_selftest.cpp",))
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
    dll.dst_topk_emit.argtypes = [p] * 5 + [i, ll, ll, i, i, i, p]
    dll.dst_topk_emit.restype = i
    dll.dst_topk_select.argtypes = [p] * 4 + [i, ll, ll, i, i, i, p]
    dll.dst_topk_select.restype = i
    dll.dst_topk_select_width.argtypes = [ll, ll, i, i, i]
    dll.dst_topk_select_width.restype = ll
    dll.dst_topk_route.argtypes = [p, p, ll, i, i]
    dll.dst_topk_route.restype = i
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


def _topk(emulated, q, c, n_valid, kc):
    """Pass 1 on the emulated kernels, driven as ``topk_candidates_kernel``
    drives them: on the wgmma routes ``mips_kernels.topk_select`` over
    ``dst_topk_select``, on the score tile ``mips_kernels._topk_sweeps`` over
    ``dst_tile_max`` and ``dst_topk_emit``: (scores, rows, overflow reruns,
    each launch's (B, key slots a query), the select sweep's keys or
    None)."""
    (B, D), N, launches, dtype = q.shape, c.shape[0], [], mk._KERNEL_DTYPES[c.dtype]
    selected = []
    if emulated.dst_topk_route(q.data_ptr(), c.data_ptr(), N, D, dtype):
        def select(qs):
            width = emulated.dst_topk_select_width(N, n_valid, B, D, kc)
            keys = torch.full((B, width), 12345, dtype=torch.int64)  # the kernel fills them
            pub = torch.full((B, 32), -7, dtype=torch.int64)  # the entry point zeroes it
            assert emulated.dst_topk_select(qs.data_ptr(), c.data_ptr(), keys.data_ptr(),
                                            pub.data_ptr(), B, N, n_valid, D, kc, 0, None) == 0
            launches.append((B, width))
            selected.append(keys)
            return keys

        return (*mk.topk_select(q, kc, select), 0, launches, selected[0])

    def tile_max(qs, rows, tile):
        out = torch.full((qs.shape[0], rows.shape[0] // tile), float("nan"))
        assert emulated.dst_tile_max(qs.data_ptr(), rows.data_ptr(), out.data_ptr(), qs.shape[0],
                                     rows.shape[0], D, tile, dtype, None) == 0
        return out

    def emit(qs, theta, cap):
        count = torch.full((qs.shape[0],), -7, dtype=torch.int32)  # the entry point zeroes it
        keys = torch.full((qs.shape[0], cap), mk._KEY_EMPTY, dtype=torch.int64)
        assert emulated.dst_topk_emit(qs.data_ptr(), c.data_ptr(), theta.data_ptr(),
                                      count.data_ptr(), keys.data_ptr(), qs.shape[0],
                                      N, n_valid, D, cap, dtype, None) == 0
        launches.append((qs.shape[0], cap))
        return count, keys

    return (*mk._topk_sweeps(q, c, n_valid, kc, tile_max, emit), launches, None)


EMU_SMS = 2  # tests/cuda_emu/cuda_emu.h: the emulated card's multiprocessors


def select_parts(B, N, D, n_valid, kc):
    """([(first row, row past the last, warpgroup half or None) of each
    part, in the order of its keys], key slots a query) of a select launch
    on the emulated card: spans of whole 256-row tiles, about one block an
    SM a query tile; in the 64-query layout each warpgroup's half of each
    tile of its span."""
    qm = 128 if B > 64 and D <= 1536 else 64
    rows = min(N, -(-n_valid // 256) * 256)
    tiles, nqt = -(-rows // 256), -(-B // qm)
    span = -(-tiles // max(1, EMU_SMS // nqt)) * 256
    parts = []
    for lo in range(0, rows, span):
        hi = min(lo + span, rows)
        parts += [(lo, hi, None)] if qm == 128 else [(lo, hi, 0), (lo, hi, 1)]
    return parts, kc * len(parts)


def assert_parts_hold_the_top(keys, q, c, n_valid, kc):
    """Each part's kc keys of the select sweep are rows of its own below
    n_valid with their exact scores, sorted (ties to the smaller row), no
    row twice, empty slots last, and hold every row of the part in the
    query's exact top kc (rows below a filter another part raised may
    be missing: no such row is in the top kc)."""
    B, D = q.shape
    parts, width = select_parts(B, c.shape[0], D, n_valid, kc)
    assert keys.shape == (B, width)
    s = q.double() @ c.double().T
    top_s, top_i = _want_topk(q, c, n_valid, kc)
    for p, (lo, hi, half) in enumerate(parts):
        got_s, got_i = mk._decode_keys(keys[:, p * kc:(p + 1) * kc])
        for b in range(B):
            rows, full = got_i[b][got_i[b] >= 0], top_i[b][top_i[b] >= 0]
            assert (got_i[b][len(rows):] == -1).all()
            assert ((rows >= lo) & (rows < min(hi, n_valid))).all()
            assert len(set(rows.tolist())) == len(rows)
            if half is not None:  # this warpgroup's 128 rows of each 256-row tile
                assert ((rows % 256) // 128 == half).all()
            assert torch.equal(got_s[b][: len(rows)].double(), s[b, rows])
            order = np.lexsort((rows.numpy(), -s[b, rows].numpy()))
            assert (order == np.arange(len(rows))).all()
            mine = full[(full >= lo) & (full < hi)]
            if half is not None:
                mine = mine[(mine % 256) // 128 == half]
            assert set(mine.tolist()) <= set(rows.tolist()), (p, b)


def _topk_inputs(B, N, D, n_valid, kind, seed, dtype=torch.bfloat16):
    """Integer-valued queries and rows (every score exact in fp32, in any
    order; ties abound); ``neg``: positive queries against negative rows,
    so every score lies below the 0 of the ring's zero fill; ``padtop``:
    positive queries, the rows past n_valid all 3, above every valid row;
    ``dup``: every row repeated in 16 neighbours, so each score ties 16
    times; ``same``: one row everywhere, every score a tie."""
    rng = np.random.default_rng(seed)
    lo, hi = (1, 4) if kind in ("neg", "padtop") else (-3, 4)
    q = rng.integers(lo, hi, size=(B, D)).astype(np.float32)
    c = rng.integers(-3, 4 if kind != "neg" else 0, size=(N, D)).astype(np.float32)
    if kind == "padtop":
        c[n_valid:] = 3.0
    if kind == "dup":
        c = c[np.arange(N) // 16 * 16]
    if kind == "same":
        c = c[np.zeros(N, dtype=np.int64)]
    return torch.from_numpy(q).to(dtype), torch.from_numpy(np.ascontiguousarray(c)).to(dtype)


def _want_topk(q, c, n_valid, kc):
    """The exact top-kc (scores, rows) of the valid rows, ties to the
    smaller row, NEG_INF / -1 past n_valid: fp64 scores of the integer
    inputs."""
    s = (q.double() @ c[:n_valid].double().T).numpy()
    order = np.lexsort((np.broadcast_to(np.arange(n_valid), s.shape), -s), axis=1)[:, :kc]
    scores = np.take_along_axis(s, order, axis=1)
    if n_valid < kc:
        pad = ((0, 0), (0, kc - n_valid))
        scores = np.pad(scores, pad, constant_values=mk.NEG_INF)
        order = np.pad(order, pad, constant_values=-1)
    return torch.from_numpy(scores.astype(np.float32)), torch.from_numpy(order.astype(np.int64))


# (B, N rows, D, n_valid, kc, kind, route): 64-query blocks over rows that
# end inside a tile (the ring's zero fill) with every score negative;
# 128-query blocks with a ragged query tile and kc = the tiles; pad rows
# past n_valid that would top every query (the sweep takes them, whole
# tiles, and masks them); 16-fold ties at the kc-th score; every row the
# same (every key ties on its score); fewer than kc whole tiles; D = 100
# on the cp.async route
TOPK_CASES = [
    (7, 2700, 64, 2700, 8, "neg", 1),
    (70, 2560, 48, 2560, 10, "rand", 1),
    (9, 2048, 32, 2000, 4, "padtop", 1),
    (70, 2048, 32, 2048, 6, "dup", 1),
    (9, 1280, 32, 1280, 4, "same", 1),
    (5, 1280, 32, 1200, 8, "rand", 1),
    (9, 1280, 100, 1280, 4, "rand", 2),
]


@pytest.mark.parametrize("B,N,D,n_valid,kc,kind,route", TOPK_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-v{c[3]}-kc{c[4]}-{c[5]}"
                              for c in TOPK_CASES])
def test_emulated_topk_candidates_equal_plain(emulated, B, N, D, n_valid, kc, kind, route):
    """The select sweep's candidates exactly equal the plain version's
    scores and rows strictly above each query's kc-th score, and the exact
    top-kc with ties to the smaller row; no pad row returns; one launch a
    call, no rerun; each part's list holds its rows of the top kc, with
    their exact scores, sorted."""
    q, c = _topk_inputs(B, N, D, n_valid, kind, B + N + D + kc)
    assert emulated.dst_topk_route(q.data_ptr(), c.data_ptr(), n_valid, D, 0) == route
    scores, rows, over, launches, keys = _topk(emulated, q, c, n_valid, kc)
    want_s, want_i = _want_topk(q, c, n_valid, kc)
    assert torch.equal(scores, want_s) and torch.equal(rows, want_i)
    plain_s, plain_i = mk.topk_candidates_plain(q, c, n_valid, kc)
    assert torch.equal(scores, plain_s)
    for b in range(B):  # the rows strictly above the kc-th: no tie to break
        above = scores[b] > scores[b, -1]
        assert set(rows[b][above].tolist()) == set(plain_i[b][plain_s[b] > plain_s[b, -1]].tolist())
    assert (rows < n_valid).all()
    if kind == "neg":  # the trap is live: the zero-filled rows would beat every score
        assert (scores < 0).all() and N % 256
    if kind == "padtop":  # the trap is live: every pad row beats every valid row
        assert (q.double() @ c[n_valid:].double().T).min() > scores.max()
    if kind == "dup":  # ties at the kc-th: some query's kc-th score is also its (kc+1)-th
        assert (want_s[:, -1] == _want_topk(q, c, n_valid, kc + 1)[0][:, -1]).any()
    assert over == 0 and launches == [(B, select_parts(B, N, D, n_valid, kc)[1])]
    assert_parts_hold_the_top(keys, q, c, n_valid, kc)


# (B, N rows, D, n_valid, kc, kind, dtype, base offset in elements,
# overflow) on the score tile (route 0): fp32 rows whose 16-fold ties at
# theta overflow every query (the rerun: fewer queries, other places in the
# 64-query tile); an odd D with pad rows past n_valid that would top every
# query; bf16 rows of even D from a 2-byte aligned base (neither wgmma
# route can address it) with every score negative, whose ties overflow
# some queries too; fp32 with fewer than kc whole tiles
TILE_TOPK_CASES = [
    (70, 2048, 48, 2048, 6, "dup", torch.float32, 0, True),
    (9, 2048, 101, 2000, 4, "padtop", torch.bfloat16, 0, False),
    (7, 1500, 64, 1500, 5, "neg", torch.bfloat16, 1, True),
    (5, 1280, 24, 1200, 8, "rand", torch.float32, 0, False),
]


@pytest.mark.parametrize("B,N,D,n_valid,kc,kind,dtype,offset,overflow", TILE_TOPK_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-v{c[3]}-kc{c[4]}-{c[5]}-{str(c[6])[6:]}"
                              f"-at{c[7]}" for c in TILE_TOPK_CASES])
def test_emulated_topk_candidates_on_the_score_tile_equal_plain(
        emulated, B, N, D, n_valid, kc, kind, dtype, offset, overflow):
    """fp32 rows, odd D and bases the wgmma routes cannot address take the
    emit sweep on score_tile.cuh's tile with the tile maxima on the same
    tile: the exact top-kc with ties to the smaller row, plain's scores, no
    pad row, and a rerun of the overflowing queries counts as the first
    sweep did (the sums do not depend on a query's place in the tile)."""
    q, c = _topk_inputs(B, N, D, n_valid, kind, B + N + D + kc, dtype)
    if offset:  # the same rows, `offset` elements into a buffer
        buf = torch.zeros(N * D + offset, dtype=dtype)
        buf[offset:] = c.flatten()
        c = buf[offset:].view(N, D)
        assert c.data_ptr() % 4 == 2
    assert emulated.dst_topk_route(q.data_ptr(), c.data_ptr(), n_valid, D,
                                   mk._KERNEL_DTYPES[dtype]) == 0
    scores, rows, over, launches, _keys = _topk(emulated, q, c, n_valid, kc)
    want_s, want_i = _want_topk(q, c, n_valid, kc)
    assert torch.equal(scores, want_s) and torch.equal(rows, want_i)
    assert torch.equal(scores, mk.topk_candidates_plain(q, c, n_valid, kc)[0])
    if kind == "padtop":  # the trap is live: every pad row beats every valid row
        assert (q.double() @ c[n_valid:].double().T).min() > scores.max()
    if kind == "neg":
        assert (scores < 0).all()
    assert (over > 0) == overflow
    if over:
        assert launches[1][0] == over and launches[1][1] > launches[0][1]
    if n_valid // 256 < kc:
        assert launches == [(B, n_valid)]


def test_emulated_topk_emit_refuses_bad_arguments(emulated):
    """dst_topk_emit returns cudaErrorInvalidValue (1) on arguments out of
    range and launches nothing: a dtype other than bf16 / fp32, n_valid
    past N, cap 0, n_valid 0, and a bf16 shape of the wgmma routes (the
    select sweep's)."""
    q, c = _topk_inputs(3, 512, 16, 512, "rand", 1, torch.float32)
    qb, cb = q.bfloat16(), c.bfloat16()
    theta = torch.zeros(3)
    count, keys = torch.full((3,), -7, dtype=torch.int32), torch.zeros((3, 8), dtype=torch.int64)
    for (x, y), n_valid, cap, dtype in (((q, c), 512, 8, 2), ((q, c), 513, 8, 1),
                                        ((q, c), 512, 0, 1), ((q, c), 0, 8, 1),
                                        ((qb, cb), 512, 8, 0)):
        assert emulated.dst_topk_emit(x.data_ptr(), y.data_ptr(), theta.data_ptr(),
                                      count.data_ptr(), keys.data_ptr(), 3, 512, n_valid, 16,
                                      cap, dtype, None) == 1
    assert (count == -7).all() and (keys == 0).all()


def test_emulated_topk_candidate_scores_are_the_count_kernels_bits(emulated):
    """Random normal bf16 inputs (no ties): at the j-th candidate's score
    as tau, dst_count_above counts exactly j rows above it, for every j <
    kc: the select sweep's sums are the count kernel's bits."""
    B, N, D, kc = 9, 1536, 64, 4
    rng = np.random.default_rng(31)
    q, c = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
            for shape in ((B, D), (N, D)))
    s = q.double() @ c.double().T
    assert (torch.sort(s, dim=1).values.diff(dim=1) > 0).all()  # no ties
    scores, rows, over, _launches, _keys = _topk(emulated, q, c, N, kc)
    assert over == 0
    for j in range(kc):
        out = torch.zeros(B, dtype=torch.int32)
        tau = scores[:, j].contiguous()
        assert emulated.dst_count_above(q.data_ptr(), c.data_ptr(), tau.data_ptr(),
                                        out.data_ptr(), B, N, D, 0, None) == 0
        assert torch.equal(out, torch.full((B,), j, dtype=torch.int32))
    assert torch.equal(rows, torch.topk(s, kc, dim=1).indices)
