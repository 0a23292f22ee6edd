"""The attention kernels' CUDA sources, run on the CPU under an emulation.

``dpr_scale_tpu_torch/csrc/attention_{fwd,bwd}.cu`` need the card; here
g++ builds the same sources against ``tests/cuda_emu``, which defines the
CUDA features they use on the host (one std::thread per CUDA thread,
barriers for ``__syncthreads`` and the warp's collectives) and puts the PTX
ISA's definitions of cp.async, ldmatrix and mma.sync m16n8k16 in place of
``csrc/attention_ptx.cuh``. The entry points ``dst_attention_fwd`` /
``dst_attention_bwd`` then run on CPU tensors and are held against
``attention_plain`` / ``attention_bwd_plain`` with the card tests'
tolerances: the kernels' tiling, fragment layouts, tail masks, pipelining
and dropout bits, checked on every run of the suite. Skips where no g++ is
found.
"""
import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from dpr_scale_tpu_torch.ops import attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "dpr_scale_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tests", "cuda_emu")
SOURCES = ("attention_fwd.cu", "attention_bwd.cu", "attention_tiles.cuh", "dropout_bits.cuh")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels' C entry points, built against the emulation."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' sources for the host")
    src = tmp_path_factory.mktemp("attention_emulated")
    for name in SOURCES:
        shutil.copy(os.path.join(CSRC, name), src / name)
    shutil.copy(os.path.join(EMU, "attention_ptx.cuh"), src / "attention_ptx.cuh")
    lib = src / "libattention_emulated.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{EMU}", "-x", "c++",
         str(src / "attention_fwd.cu"), str(src / "attention_bwd.cu"),
         os.path.join(EMU, "emu.cpp"), "-o", str(lib)],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(str(lib))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    dll.dst_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, u, u, f, p]
    dll.dst_attention_fwd.restype = i
    dll.dst_attention_bwd.argtypes = [p] * 9 + [i, i, i, i, u, u, f, p]
    dll.dst_attention_bwd.restype = i
    return dll


def _inputs(B, nh, L, hd, seed):
    """bf16 q, k, v, g and ragged key masks; with B > 1 the last sequence
    has every key masked."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, go = (torch.randn(B, nh, L, hd, generator=g).bfloat16() for _ in range(4))
    lens = torch.randint(1, L + 1, (B,), generator=g)
    lens[0] = L
    bias = (torch.arange(L)[None, :] >= lens[:, None]).float() * -1e9
    if B > 1:
        bias[-1] = -1e9
    return q, k, v, bias[:, None, :].contiguous(), go


def _forward(dll, q, k, v, bias, seed, rate):
    B, nh, L, hd = q.shape
    out = torch.full_like(q, float("nan"))
    rc = dll.dst_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                               out.data_ptr(), B, nh, L, hd,
                               *attention._dropout_args(seed, rate), None)
    assert rc == 0
    return out


def _backward(dll, q, k, v, bias, go, seed, rate):
    B, nh, L, hd = q.shape
    dq, dk, dv = (torch.full_like(q, float("nan")) for _ in range(3))
    stats = torch.empty(3 * B * nh * L)
    rc = dll.dst_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                               go.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               stats.data_ptr(), B, nh, L, hd,
                               *attention._dropout_args(seed, rate), None)
    assert rc == 0
    return dq, dk, dv


# (B, nh, L, hd, rate): each register width (hd <= 32, <= 64, <= 128), hd
# below its width (48, 96), tails of one key past a tile or short of one, a
# single-tile and an eight-tile sequence, both rates
CASES = [(2, 1, 15, 16, 0.1), (2, 1, 63, 32, 0.0), (1, 2, 129, 64, 0.1), (2, 1, 130, 48, 0.0),
         (1, 1, 256, 64, 0.1), (2, 1, 257, 128, 0.1), (1, 1, 512, 32, 0.1), (3, 2, 40, 96, 0.1)]


@pytest.mark.parametrize("B,nh,L,hd,rate", CASES)
def test_emulated_kernels_match_plain(emulated, B, nh, L, hd, rate):
    """Forward within 1e-2 + 1e-2 |ref|, each gradient within 2e-2 of its
    max |ref| (the card tests' tolerances); every output written."""
    q, k, v, bias, go = _inputs(B, nh, L, hd, 31 * L + hd)
    out = _forward(emulated, q, k, v, bias, 1234, rate)
    ref = attention.attention_plain(q, k, v, bias, 1234, rate)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    got = _backward(emulated, q, k, v, bias, go, 1234, rate)
    want = attention.attention_bwd_plain(q, k, v, bias, go, 1234, rate)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        err, scale = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
        assert err <= 2e-2 * scale + 1e-6, f"{name}: max err {err} vs max |ref| {scale}"


def test_emulated_kernels_refuse_what_they_cannot_run(emulated):
    """The entry points' own checks: L > 512 and head dims off the grid."""
    q = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16)
    bias = torch.zeros(1, 1, 8)
    for L, hd in ((513, 64), (8, 24), (8, 144)):
        args = (q.data_ptr(),) * 3 + (bias.data_ptr(), q.data_ptr(), 1, 1, L, hd, 0, 0, 1.0, None)
        assert emulated.dst_attention_fwd(*args) != 0
