"""Fused multi-head attention with in-kernel dropout, forward and backward.

Counterpart of :mod:`dpr_scale_tpu.ops.attention`. Same public layout:
q, k, v are ``(B, nh, L, hd)``; bias is the ``(B, 1, L)`` additive fp32 key
mask (0 keep / -1e9 drop); the result is ``(B, nh, L, hd)`` in the input
dtype. Semantics follow the TPU kernels: fp32 ``softmax(q.k^T/sqrt(hd) +
bias)``, inverted dropout ``keep ? p/(1-rate) : 0`` on the fp32
probabilities, which are rounded to the input dtype before the product with
v; the backward recomputes the softmax and regenerates the keep bits.

The keep bits are counter-based (:func:`dropout_keep_mask`, the same
arithmetic as ``csrc/dropout_bits.cuh``): a pure function of the seed and of
(sequence, head, query row, key column). Their realisations differ from the
TPU's PRNG stream by design, as the JAX module's docstring allows.

* :func:`attention_plain`, :func:`attention_bwd_plain` — plain PyTorch, the
  CPU path and the oracles;
* :func:`attention_fwd_kernel`, :func:`attention_bwd_kernel` — the
  hand-written CUDA kernels (``csrc/attention_fwd.cu``,
  ``csrc/attention_bwd.cu``), bf16 only, L <= 512;
* ``torch.ops.dpr_scale_tpu_torch.attention_fwd`` — the forward as a
  ``torch.library`` custom op (with a fake kernel for tracing), so that
  ``torch.export`` keeps it in an exported encoder's graph: a ``ctypes``
  launch cannot be traced. CPU tensors take the plain version, CUDA tensors
  launch the kernel or raise;
* :func:`fused_attention` — differentiable dispatch
  (:class:`FusedAttention`, whose forward is that op): CPU tensors take the
  plain versions, CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import math

import torch

MAX_LEN = 512  # the kernels' limit (BERT's positions): a block stages the whole key bias row

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2^32 for an int64 tensor a in [0, 2^32): c is split into
    16-bit halves so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_threshold(rate: float) -> int:
    """Keep an entry when its 32 bits are >= this (the TPU kernel's rule)."""
    return min(int(round(rate * 2**32)), 2**32 - 1)


def dropout_keep_mask(seed: int, shape, rate: float, device=None):
    """Bool keep mask of a ``(B, nh, Lq, Lk)`` attention matrix at ``rate``:
    the uint32 bits of entry (b, h, i, j), computed in int64 exactly as the
    kernels draw them (``csrc/dropout_bits.cuh``), against the threshold."""
    B, nh, Lq, Lk = shape
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    bh = ar(B * nh).view(B, nh, 1, 1)
    key = _fmix32((int(seed) & _M32) ^ _mul32(bh + 1, 0x9E3779B9))
    row = _fmix32(key ^ _mul32(ar(Lq).view(1, 1, Lq, 1) + 1, 0x85EBCA6B))
    bits = _fmix32(row ^ _mul32(ar(Lk).view(1, 1, 1, Lk) + 1, 0xC2B2AE35))
    return bits >= dropout_threshold(rate)


def _probs(q, k, bias):
    """fp32 softmax(q.k^T / sqrt(hd) + bias), the kernels' arithmetic."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias.float()[:, :, None, :]  # (B, 1, 1, L) over heads and rows
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(dim=-1, keepdim=True)


def _dropped(x, seed, rate):
    """keep ? x / (1 - rate) : 0 for an fp32 (B, nh, Lq, Lk) tensor."""
    if rate == 0.0:
        return x
    keep = dropout_keep_mask(seed, x.shape, rate, x.device)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((), device=x.device))


def attention_plain(q, k, v, bias, seed: int = 0, rate: float = 0.0):
    """Plain PyTorch attention forward with the kernel's rounding points and
    dropout bits."""
    p = _dropped(_probs(q, k, bias), seed, rate)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def attention_bwd_plain(q, k, v, bias, g, seed: int = 0, rate: float = 0.0):
    """(dq, dk, dv) as the TPU's ``_bwd_kernel`` computes them: ``pd`` rounded
    to the input dtype for dv, the softmax VJP with the FULL p (dropped
    entries still get the ``-p * dsum`` term), ``ds * scale`` rounded to the
    input dtype for dq and dk. The bias gets no gradient."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    g = g.to(dt).float()
    p = _probs(q, k, bias)
    pd = _dropped(p, seed, rate)
    dv = torch.matmul(pd.to(dt).float().transpose(-1, -2), g).to(dt)
    dp = _dropped(torch.matmul(g, v.float().transpose(-1, -2)), seed, rate)
    dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = ((p * (dp - dsum)) * scale).to(dt).float()
    dq = torch.matmul(ds, k.float()).to(dt)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(dt)
    return dq, dk, dv


def _check_kernel_args(what, q, tensors, bias):
    if not q.is_cuda:
        raise ValueError(f"{what} kernel takes CUDA tensors, got {q.device}")
    B, nh, L, hd = q.shape
    for name, t in tensors:
        if t.dtype != torch.bfloat16 or t.shape != q.shape:
            raise ValueError(
                f"{what} kernel: {name} must be bf16 {tuple(q.shape)}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if bias.dtype != torch.float32 or bias.shape != (B, 1, L):
        raise ValueError(
            f"{what} kernel: bias must be fp32 {(B, 1, L)}, got {bias.dtype} "
            f"{tuple(bias.shape)}"
        )
    for name, t in tensors + (("bias", bias),):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{what} kernel: {name} must be a contiguous, 16-byte "
                f"aligned tensor on {q.device}"
            )
    if L > MAX_LEN or hd % 16 or not 16 <= hd <= 128:
        raise ValueError(
            f"{what} kernel takes L <= {MAX_LEN} and head_dim a multiple "
            f"of 16 in [16, 128]; got L={L}, head_dim={hd}"
        )


def _dropout_args(seed, rate):
    """(seed, threshold, 1/(1-rate)) for the C entry points; threshold 0
    selects the kernels' rate-0 branch."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0, 0, 1.0
    return int(seed) & _M32, dropout_threshold(rate), 1.0 / (1.0 - rate)


def attention_fwd_kernel(q, k, v, bias, seed: int = 0, rate: float = 0.0):
    """Launch ``csrc/attention_fwd.cu`` on the current CUDA stream."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    _check_kernel_args("attention", q, (("q", q), ("k", k), ("v", v)), bias)
    B, nh, L, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = cuda_lib.library().dst_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, nh, L, hd, *_dropout_args(seed, rate),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "attention_fwd")
    attention_fwd_kernel.launches += 1
    if rate > 0.0:
        attention_fwd_kernel.dropout_launches += 1
    return out


attention_fwd_kernel.launches = 0
attention_fwd_kernel.dropout_launches = 0  # those of the launches with rate > 0


def attention_bwd_kernel(q, k, v, bias, g, seed: int = 0, rate: float = 0.0):
    """Launch ``csrc/attention_bwd.cu`` (its dq kernel, which also writes
    the rows' softmax statistics into ``stats``, then its dk/dv kernel) on
    the current CUDA stream; returns (dq, dk, dv)."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    _check_kernel_args(
        "attention backward", q, (("q", q), ("k", k), ("v", v), ("g", g)), bias
    )
    B, nh, L, hd = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty(3 * B * nh * L, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = cuda_lib.library().dst_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            B, nh, L, hd, *_dropout_args(seed, rate),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "attention_bwd")
    attention_bwd_kernel.launches += 1
    return dq, dk, dv


attention_bwd_kernel.launches = 0


def _dispatch(q, kernel, plain):
    if q.is_cuda:
        return kernel
    if q.device.type == "cpu":
        return plain
    raise ValueError(f"fused_attention: unsupported device {q.device}")


@torch.library.custom_op("dpr_scale_tpu_torch::attention_fwd", mutates_args=())
def attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     seed: int, rate: float) -> torch.Tensor:
    """The forward: the kernel on CUDA tensors, the plain version on CPU
    ones."""
    return _dispatch(q, attention_fwd_kernel, attention_plain)(q, k, v, bias, seed, rate)


@attention_fwd_op.register_fake
def _attention_fwd_fake(q, k, v, bias, seed, rate):
    return torch.empty_like(q)


class FusedAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: saves only q, k, v, bias and the seed, and
    recomputes the softmax and the dropout bits in the backward. The bias
    gets no gradient (``dpr_scale_tpu/ops/attention.py:187-192``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate):
        ctx.save_for_backward(q, k, v, bias)
        ctx.seed, ctx.rate = seed, rate
        return attention_fwd_op(q, k, v, bias, seed, rate)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        bwd = _dispatch(q, attention_bwd_kernel, attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, bias, g.to(q.dtype).contiguous(), ctx.seed, ctx.rate)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, bias, seed: int = 0, rate: float = 0.0):
    """Attention with in-kernel dropout at ``rate`` keyed by the int
    ``seed``; differentiable in q, k and v. ``bias`` must not require a
    gradient: the kernels' VJP has no bias cotangent, so a learned bias fed
    through here would silently not learn."""
    if bias.requires_grad:
        raise ValueError(
            "fused_attention: bias gets no gradient from the kernels' VJP; "
            "pass a mask-derived bias that does not require grad"
        )
    return FusedAttention.apply(q, k, v, bias, int(seed), float(rate))
