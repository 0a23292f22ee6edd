"""The gather-score kernels' CUDA source, run on the CPU under an emulation.

``dpr_scale_tpu_torch/csrc/gather_score.cu`` needs the card; here g++ builds
the same source against ``tests/cuda_emu``, which defines the CUDA features
it uses on the host (warp shuffles, the device queries of a persistent grid)
and puts the PTX ISA's definitions of mbarriers and 1-D bulk copies in
place of ``csrc/hopper_ptx.cuh``. The three C entry points then run on CPU
tensors and are held against ``gather_score_plain`` (within GATHER_REL of
max |ref|, the card's tolerance), every score written over a NaN-filled
output: bf16 rows of D = 32 and 128 and fp32 rows, ragged entry counts,
entries spread over the experts, all on one expert and with pad slots,
buckets of one stage up to several stages an entry (with a ragged last
tile), on both routes of the pipelined kernel (the bulk-copy ring, and
element copies where a row is not a multiple of 16 bytes). The pipelined
kernel must give the serial kernel's bits. The emulated card has two
multiprocessors, so each persistent block walks many work items and its
ring wraps. A lone emulated bulk copy is checked first, so that a slip in
the emulation itself fails on its own. Skips where no g++ is found.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.ops import gather_score as gs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "dpr_scale_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
GATHER_REL = 1e-4  # chip_smoke.GATHER_REL: fp32 sums of the same products in another order
DTYPES = {torch.bfloat16: 0, torch.float32: 1}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """gather_score.cu's C entry points and the bulk-copy self-test, built
    against the emulation."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' source for the host")
    src = tmp_path_factory.mktemp("gather_emulated")
    shutil.copy(os.path.join(CSRC, "gather_score.cu"), src / "gather_score.cu")
    shutil.copy(os.path.join(EMU, "hopper_ptx.cuh"), src / "hopper_ptx.cuh")
    lib = src / "libgather_emulated.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{EMU}", "-x", "c++",
         str(src / "gather_score.cu"), os.path.join(EMU, "bulk_selftest.cpp"),
         os.path.join(EMU, "emu.cpp"), "-o", str(lib)],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.dst_gather_serial.argtypes = [p] * 4 + [i, ll, i, i, i, i, p]
    dll.dst_gather_pipelined.argtypes = [p] * 4 + [i, ll, i, i, i, i, i, p]
    dll.dst_gather_pipelined_route.argtypes = [p, p, i, i]
    dll.dst_gather_streamed.argtypes = [p] * 5 + [i, ll, i, i, i, i, p]
    dll.emu_bulk_selftest.argtypes = [p, p, i, i]
    return dll


def test_emulated_bulk_copy_lands_its_bytes(emulated):
    """Two bulk copies into shared memory at an offset, on one mbarrier
    armed for both: the barrier's phase stays open until the last byte, and
    the bytes land where they were sent."""
    src = torch.from_numpy(np.random.default_rng(0).integers(0, 256, 4192, dtype=np.uint8))
    dst = torch.zeros_like(src)
    assert emulated.emu_bulk_selftest(src.data_ptr(), dst.data_ptr(), src.numel(), 1040) == 0
    assert torch.equal(dst, src)


def _inputs(n_exp, L, D, E, dtype, case, seed):
    """Postings, slot-sorted int32 slots and queries (in the postings'
    dtype) of one bucket: entries spread over the experts, all on one, or
    every third on the pad slot n_exp."""
    rng = np.random.default_rng(seed)
    vecs = torch.from_numpy((rng.standard_normal((n_exp, L, D)) * 0.3).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((E, D)).astype(np.float32)).to(dtype)
    if case == "one_slot":
        slots = np.full(E, n_exp // 2)
    else:
        slots = rng.integers(0, n_exp, E)
        if case == "pad":
            slots[::3] = n_exp
    slots = torch.from_numpy(np.sort(slots).astype(np.int32))
    return vecs.to(dtype).contiguous(), slots, q.contiguous()


def _run(emulated, kind, vecs, slots, q):
    """One C entry point with the tiling its wrapper gives it, over a
    NaN-filled output; returns the scores and, for the pipelined kernel,
    its route."""
    n_exp, L, D = vecs.shape
    E, dtype, row_bytes = slots.shape[0], DTYPES[vecs.dtype], D * vecs.element_size()
    out = torch.full((E, L), float("nan"))
    args = (vecs.data_ptr(), slots.data_ptr(), q.data_ptr(), out.data_ptr())
    route = None
    if kind == "serial":
        rc = emulated.dst_gather_serial(*args, E, n_exp, L, D, min(L, gs.SERIAL_TILE), dtype,
                                        None)
    elif kind == "pipelined":
        route = gs.PIPE_ROUTES[emulated.dst_gather_pipelined_route(vecs.data_ptr(), q.data_ptr(),
                                                                   D, dtype)]
        tile, group = gs.pipelined_tiling(route, row_bytes, L, E)
        rc = emulated.dst_gather_pipelined(*args, E, n_exp, L, D, tile, group, dtype, None)
    else:
        pieces = torch.from_numpy(gs.stream_pieces(slots.numpy()))
        tile = gs._pow2_rows(gs.STREAM_TILE_BYTES, row_bytes, L)
        rc = emulated.dst_gather_streamed(*args, pieces.data_ptr(), pieces.numel() - 1, n_exp, L,
                                          D, tile, dtype, None)
    assert rc == 0, kind
    return out, route


# (n_exp, L, D, E, dtype, case, route): D = 32 bf16 over a one-stage bucket,
# the smallest bucket, four stages an entry (the ring wraps within each
# block) with pad slots; D = 128 bf16 with a ragged last tile; fp32 rows of
# 128 bytes with pad slots and a ragged tile; then the element-copy route:
# D = 100 bf16 (200-byte rows) and D = 7 fp32
GATHER_CASES = [
    (6, 512, 32, 13, torch.bfloat16, "spread", "bulk_copy"),
    (5, 128, 32, 9, torch.bfloat16, "one_slot", "bulk_copy"),
    (4, 2048, 32, 9, torch.bfloat16, "pad", "bulk_copy"),
    (4, 600, 128, 7, torch.bfloat16, "spread", "bulk_copy"),
    (3, 300, 32, 11, torch.float32, "pad", "bulk_copy"),
    (3, 200, 100, 5, torch.bfloat16, "spread", "element_copy"),
    (3, 96, 7, 4, torch.float32, "one_slot", "element_copy"),
]


@pytest.mark.parametrize(
    "n_exp,L,D,E,dtype,case,route", GATHER_CASES,
    ids=[f"L{c[1]}-D{c[2]}-E{c[3]}-{str(c[4])[6:]}-{c[5]}" for c in GATHER_CASES])
def test_emulated_gather_kernels_match_plain(emulated, n_exp, L, D, E, dtype, case, route):
    """Serial, pipelined and streamed within GATHER_REL of the plain
    version, every score written; the pipelined kernel on the route its rows
    select, bit for bit the serial kernel's scores."""
    vecs, slots, q = _inputs(n_exp, L, D, E, dtype, case, L + D + E)
    want = gs.gather_score_plain(vecs, slots, q)
    scale = want.abs().max().item()
    got = {kind: _run(emulated, kind, vecs, slots, q) for kind in
           ("serial", "pipelined", "streamed")}
    assert got["pipelined"][1] == route
    for kind, (out, _route) in got.items():
        assert torch.isfinite(out).all(), kind
        assert (out - want).abs().max().item() <= GATHER_REL * scale, kind
    assert torch.equal(got["pipelined"][0], got["serial"][0])
    if case == "pad":
        assert (got["pipelined"][0][slots == n_exp] == 0).all()
