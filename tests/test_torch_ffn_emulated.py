"""The FFN kernels' CUDA source, run on the CPU under an emulation.

``dpr_scale_tpu_torch/csrc/ffn_fwd.cu`` needs the card; here g++ builds the
same source against ``tests/cuda_emu``, which defines the CUDA features it
uses on the host (one std::thread per CUDA thread, barriers, named barriers)
and puts the PTX ISA's definitions of TMA loads with the 128-byte swizzle,
mbarriers, wgmma from shared-memory descriptors and setmaxnreg in place of
``csrc/hopper_ptx.cuh``. The entry points ``dst_ffn_fwd`` / ``dst_ffn_ln_fwd``
then run on CPU tensors and are held against ``ffn_fwd_plain`` /
``ffn_ln_fwd_plain`` with the card's tolerance (``chip_smoke.FFN_REL``):
the kernel's ring, descriptors, fragment layout, row masks, both tile
widths and the dropout bits, checked on every run of the suite. A lone
wgmma is held against ``torch.mm`` first, so that a slip in the emulation
itself fails on its own. Skips where no g++ is found.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.ops import ffn
from dpr_scale_tpu_torch.ops.attention import _dropout_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "dpr_scale_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
FFN_REL = 1e-2  # chip_smoke.FFN_REL: max |err| over max |ref| of each output


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's C entry points and the wgmma self-test, built against
    the emulation."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    src = tmp_path_factory.mktemp("ffn_emulated")
    for name in ("ffn_fwd.cu", "dropout_bits.cuh"):
        shutil.copy(os.path.join(CSRC, name), src / name)
    shutil.copy(os.path.join(EMU, "hopper_ptx.cuh"), src / "hopper_ptx.cuh")
    lib = src / "libffn_emulated.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{EMU}", "-x", "c++",
         str(src / "ffn_fwd.cu"), os.path.join(EMU, "wgmma_selftest.cpp"),
         os.path.join(EMU, "emu.cpp"), "-o", str(lib)],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(str(lib))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    dll.dst_ffn_fwd.argtypes = [p] * 8 + [i, i, i, u, u, f, p]
    dll.dst_ffn_fwd.restype = i
    dll.dst_ffn_ln_fwd.argtypes = [p] * 14 + [i, i, i, f, u, u, f, p]
    dll.dst_ffn_ln_fwd.restype = i
    dll.dst_ffn_gemm.argtypes = [p] * 5 + [i, i, i, i, u, u, f, p]
    dll.dst_ffn_gemm.restype = i
    dll.dst_ffn_ln_rows.argtypes = [p] * 5 + [i, i, f, p]
    dll.dst_ffn_ln_rows.restype = i
    dll.emu_wgmma_selftest.argtypes = [p, p, p, i, i]
    dll.emu_wgmma_selftest.restype = i
    return dll


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("by_tma", [False, True])
@pytest.mark.parametrize("n", [128, 256])
def test_emulated_wgmma_matches_mm(emulated, n, by_tma):
    """Four k-steps of wgmma m64nNk16 from swizzled shared memory (laid out
    by hand, or by the emulated TMA) against torch.mm in fp32."""
    rng = np.random.default_rng(n + by_tma)
    a, b = _bf16(rng, 64, 64), _bf16(rng, 64, n)
    d = torch.full((64, n), float("nan"))
    assert emulated.emu_wgmma_selftest(a.data_ptr(), b.data_ptr(), d.data_ptr(), n, by_tma) == 0
    torch.testing.assert_close(d, a.float() @ b.float(), rtol=1e-5, atol=1e-4)


def _weights(N, H, F, seed):
    """x and bf16 weights at the model's scales (std 0.05), from numpy."""
    rng = np.random.default_rng(seed)
    return (_bf16(rng, N, H), _bf16(rng, H, F, scale=0.05), _bf16(rng, F, scale=0.05),
            _bf16(rng, F, H, scale=0.05), _bf16(rng, H, scale=0.05))


def _ln_params(H, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(H) * 0.1 + m).astype(np.float32))
            for m in (1.0, 0.0, 1.0, 0.0)]


def _assert_rel_close(name, got, want):
    assert torch.isfinite(got.float()).all(), name
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= FFN_REL * scale, f"{name}: max err {err} vs max |ref| {scale}"


def _nan(*shape):
    return torch.full(shape, float("nan"), dtype=torch.bfloat16)


# (H, F): GEMM1 on 256-column tiles and GEMM2 on 128 (H = 128), both on 256
SHAPES = [(128, 256), (256, 512)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("H,F", SHAPES)
@pytest.mark.parametrize("N", [1, 200, 257])
def test_emulated_ffn_matches_plain(emulated, N, H, F, rate):
    """dst_ffn_fwd: y and pre within FFN_REL of max |ref|, every row written,
    and at rate 0.1 the same kept entries as the plain version."""
    x, w1, b1, w2, b2 = _weights(N, H, F, 7 * N + H)
    y, pre, h = _nan(N, H), _nan(N, F), _nan(N, F)
    rc = emulated.dst_ffn_fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                              b2.data_ptr(), y.data_ptr(), pre.data_ptr(), h.data_ptr(), N, H, F,
                              *_dropout_args(4321, rate), None)
    assert rc == 0
    ref_y, ref_pre = ffn.ffn_fwd_plain(x, w1, b1, w2, b2, 4321, rate)
    _assert_rel_close("y", y, ref_y)
    _assert_rel_close("pre", pre, ref_pre)
    if rate:
        assert torch.equal(y != 0, ref_y != 0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("H,F", SHAPES)
@pytest.mark.parametrize("N", [1, 200, 257])
def test_emulated_ffn_ln_matches_plain(emulated, N, H, F, rate):
    """dst_ffn_ln_fwd: out, x1, pre and z within FFN_REL of max |ref|, and
    at rate 0.1 the same kept entries of z."""
    r, w1, b1, w2, b2 = _weights(N, H, F, 5 * N + F)
    lnp = _ln_params(H, N)
    out, x1, z, pre, h = _nan(N, H), _nan(N, H), _nan(N, H), _nan(N, F), _nan(N, F)
    rc = emulated.dst_ffn_ln_fwd(
        r.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        *(t.data_ptr() for t in lnp), out.data_ptr(), x1.data_ptr(), pre.data_ptr(),
        z.data_ptr(), h.data_ptr(), N, H, F, 1e-12, *_dropout_args(99, rate), None)
    assert rc == 0
    want = ffn.ffn_ln_fwd_plain(r, w1, b1, w2, b2, *lnp, 99, rate, 1e-12)
    for name, a, b in zip(("out", "x1", "pre", "z"), (out, x1, pre, z), want):
        _assert_rel_close(name, a, b)
    if rate:
        assert torch.equal(z != 0, want[3] != 0)


def test_emulated_pieces_compose_the_entry_points(emulated):
    """The timing entry points run the same launches: GEMM1 (bias + GELU),
    GEMM2 (bias + dropout) and the LayerNorm pass give the bits of
    dst_ffn_ln_fwd's pre, z and out."""
    N, H, F = 130, 128, 384  # GEMM1 on 128-column tiles
    r, w1, b1, w2, b2 = _weights(N, H, F, 3)
    lnp = _ln_params(H, 4)
    seed, thr, inv_keep = _dropout_args(8, 0.1)
    out, x1, z, pre, h = _nan(N, H), _nan(N, H), _nan(N, H), _nan(N, F), _nan(N, F)
    assert emulated.dst_ffn_ln_fwd(
        r.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        *(t.data_ptr() for t in lnp), out.data_ptr(), x1.data_ptr(), pre.data_ptr(),
        z.data_ptr(), h.data_ptr(), N, H, F, 1e-12, seed, thr, inv_keep, None) == 0
    p_x1, p_pre, p_h, p_z, p_out = _nan(N, H), _nan(N, F), _nan(N, F), _nan(N, H), _nan(N, H)
    assert emulated.dst_ffn_ln_rows(r.data_ptr(), None, lnp[0].data_ptr(), lnp[1].data_ptr(),
                                    p_x1.data_ptr(), N, H, 1e-12, None) == 0
    assert emulated.dst_ffn_gemm(p_x1.data_ptr(), w1.data_ptr(), b1.data_ptr(), p_pre.data_ptr(),
                                 p_h.data_ptr(), N, F, H, 0, 0, 0, 1.0, None) == 0
    assert emulated.dst_ffn_gemm(p_h.data_ptr(), w2.data_ptr(), b2.data_ptr(), p_z.data_ptr(),
                                 None, N, H, F, 2, seed, thr, inv_keep, None) == 0
    assert emulated.dst_ffn_ln_rows(p_x1.data_ptr(), p_z.data_ptr(), lnp[2].data_ptr(),
                                    lnp[3].data_ptr(), p_out.data_ptr(), N, H, 1e-12, None) == 0
    for a, b in ((p_x1, x1), (p_pre, pre), (p_z, z), (p_out, out)):
        assert torch.equal(a, b)
    assert emulated.dst_ffn_gemm(p_h.data_ptr(), w2.data_ptr(), b2.data_ptr(), p_z.data_ptr(),
                                 None, N, H, F, 3, 0, 0, 1.0, None) != 0  # no epilogue 3


def test_emulated_ffn_refuses_what_it_cannot_run(emulated):
    """The entry points' own checks: N < 1 and H or F off the 128 grid."""
    t = torch.zeros(256, 256, dtype=torch.bfloat16)
    for N, H, F in ((0, 128, 256), (8, 64, 256), (8, 128, 192)):
        args = (t.data_ptr(),) * 8 + (N, H, F, 0, 0, 1.0, None)
        assert emulated.dst_ffn_fwd(*args) != 0
