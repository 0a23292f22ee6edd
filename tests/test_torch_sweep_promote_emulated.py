"""The bf16 wgmma sweeps past ``PROMOTE_D`` (gmax_sweep.cuh), on the host.

Past 1,536 columns ``bf16_sweep`` sums each 64-column stage from zero on the
tensor cores and adds it into the running scores with fp32 adds, in the
QM = 64 layout at every batch (two accumulator sets do not fit beside 128
queries). These cases build the kernels' sources against the emulation of
tests/cuda_emu (``test_torch_mips_emulated.py``'s library) and hold that
path's counts, group maxima and tile maxima to the plain versions: small
integer inputs, whose every sum is exact in fp32 in any order, so counts
and maxima must be equal. The emulation sums exactly, so it cannot show the
drift the promotion repairs; ``test_torch_kernels_cuda.py`` holds the card
to plain at D = 30,528 and 30,522. Batches above 64 run two or three
64-query tiles here, where the same batch at D <= 1,536 takes the 128-query
layout. D = 1,546 (even, not a multiple of 4) runs the same loop fed by
4-byte cp.async copies, the route of SPLADE's D = 30,522.
"""
import numpy as np
import pytest
import torch
from test_torch_mips_emulated import _count_inputs, _groupmax, _sweep, emulated  # noqa: F401

from dpr_scale_tpu_torch.ops import mips_kernels as mk

PROMOTE_D = 1536  # gmax_sweep.cuh


def _ints(shape, rng, lo=-3, hi=4):
    return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.float32))


# (B, N, D): a ragged span on 64-query blocks over a D that ends mid-slice;
# two query tiles (B > 64) over 25 whole k-slices
@pytest.mark.parametrize("B,N,D", [(7, 2048 + 77, PROMOTE_D + 8), (70, 1024 + 77, 1600)])
@pytest.mark.parametrize("negative", [False, True])
def test_promoted_count_above_equals_plain(emulated, B, N, D, negative):  # noqa: F811
    q, c, tau, s = _count_inputs(B, N, D, torch.bfloat16, negative, B + N + D)
    out = torch.zeros(B, dtype=torch.int32)
    assert emulated.dst_count_above(q.data_ptr(), c.data_ptr(), tau.data_ptr(), out.data_ptr(),
                                    B, N, D, 0, None) == 0
    assert emulated.dst_count_above_route(q.data_ptr(), c.data_ptr(), N, D, 0) == 1
    assert torch.equal(out, mk.count_above_plain(q, c, tau))


@pytest.mark.parametrize("B,N,D,group", [(130, 768, 1600, 256), (9, 1024, PROMOTE_D + 64, 128)])
def test_promoted_count_above_groups_equals_plain(emulated, B, N, D, group):  # noqa: F811
    q, c, tau, _s = _count_inputs(B, N, D, torch.bfloat16, True, B + N + D + group)
    out = torch.full((B, N // group), -7, dtype=torch.int32)
    assert emulated.dst_count_above_groups(q.data_ptr(), c.data_ptr(), tau.data_ptr(),
                                           out.data_ptr(), B, N, D, group, 0, None) == 0
    assert torch.equal(out, mk.count_above_groups_plain(q, c, tau, group))


def test_promoted_groupmax_equals_plain(emulated):  # noqa: F811
    rng = np.random.default_rng(11)
    B, N, D = 70, 640, PROMOTE_D + 8
    q, c = _ints((B, D), rng).bfloat16(), _ints((N, D), rng).bfloat16()
    t1, t2, route = _groupmax(emulated, q, c)
    assert route == 1
    for got, want in zip((t1, t2), mk.groupmax_plain(q, c)):
        assert torch.equal(got, want)


def test_promoted_tile_max_equals_plain(emulated):  # noqa: F811
    """Tiles of 512 rows, each maximum in the tile's last row, over two
    query tiles."""
    rng = np.random.default_rng(12)
    B, N, D, tile = 70, 2 * 512, 1600, 512
    q = _ints((B, D), rng, 0, 3)
    c = _ints((N, D), rng, -2, 2)
    c[tile - 1 :: tile] = 3.0
    q, c = q.bfloat16(), c.bfloat16()
    out = torch.full((B, N // tile), float("nan"))
    assert emulated.dst_tile_max(q.data_ptr(), c.data_ptr(), out.data_ptr(), B, N, D, tile, 0,
                                 None) == 0
    want = mk.tile_max_scores_plain(q, c, tile)
    assert torch.equal(want, q.float() @ c[tile - 1 :: tile].float().T)
    assert torch.equal(out, want)


@pytest.mark.parametrize("name", ["count_above_groups", "count_above", "groupmax", "tile_max"])
def test_promoted_cp_async_equals_plain(emulated, name):  # noqa: F811
    """D = 1,546 past PROMOTE_D on the cp.async route (4-byte copies), two
    64-query tiles, 256-row groups and tiles: exactly plain."""
    B, N, D = 70, 768, PROMOTE_D + 10
    q, c, tau, _s = _count_inputs(B, N, D, torch.bfloat16, True, B + N + D)
    out, want, route = _sweep(emulated, name, q, c, tau, 256)
    assert route == 2
    assert torch.equal(out, want)
