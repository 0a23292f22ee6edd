"""Fused transformer FFN forward kernels (matmul + GELU + matmul + dropout, and
the LayerNorm-fused half-layer), with plain-PyTorch backwards.

Counterpart of :mod:`dpr_scale_tpu.ops.ffn`, with the same public functions:

* :func:`fused_ffn` — ``dropout(gelu(x @ w1 + b1) @ w2 + b2)``;
* :func:`fused_ffn_ln` — ``LN2(x1 + dropout(ffn(x1)))`` with ``x1 = LN1(r)``,
  the whole post-LN FFN half-layer.

Shapes: x, r ``(N, H)``; w1 ``(H, F)``; b1 ``(F,)``; w2 ``(F, H)``; b2, g1,
be1, g2, be2 ``(H,)``. Parameters may be fp32 (the model's master weights):
the matmul weights and the biases are cast to the activation dtype, the
LayerNorm scales and biases stay fp32. The rounding points are the TPU
kernels' (``dpr_scale_tpu/ops/ffn.py:113-139, 293-344``):

* ``pre = x @ w1 + b1`` accumulated in fp32 (b1 rounded to the activation
  dtype, then added in fp32) and saved in the activation dtype;
* ``h = gelu(pre)`` from the fp32 ``pre``, rounded to the activation dtype;
* ``y = h @ w2 + b2`` accumulated in fp32 over all of F; inverted dropout
  ``keep ? y / (1 - rate) : 0`` after the bias, then rounded;
* in the LN variant, ``x1`` is rounded and used for both the matmul and the
  residual, ``z`` (the dropped FFN output) is rounded before
  ``s = x1 + z`` in fp32, and LayerNorm uses the fast variance
  E[v^2] - E[v]^2 in fp32, clamped at 0 as the port's ``LayerNorm`` does
  (the JAX form does not clamp; it differs only where it would give NaN).

GELU is the exact (erf) form: ``torch.nn.functional.gelu`` (and its
``gelu_backward``) in the plain versions and ``erff`` in the kernel; the TPU
kernel carries Abramowitz-Stegun 7.1.26 (max error 1.5e-7) only because
Pallas has no erf.

Dropout keeps entry (i, j) when its counter hash of (seed, row i, column j)
is >= round(rate * 2^32): :func:`dropout_keep_mask` of
:mod:`dpr_scale_tpu_torch.ops.attention` on a ``(1, 1, N, H)`` matrix, which
``csrc/ffn_fwd.cu`` draws with ``csrc/dropout_bits.cuh``, so kernel and plain
version keep the same entries. The TPU's bits differ by design (its PRNG is
seeded per row tile).

The backwards are plain PyTorch, as the JAX ones are plain XLA
(``ops/ffn.py:200-261, 432-491``): fp32-accumulated products, the dropout
mask recovered from the zeros of the saved output, weight and bias
gradients in fp32.

* :func:`ffn_fwd_plain`, :func:`ffn_ln_fwd_plain` — the plain forwards, the
  CPU path and the oracles;
* :func:`ffn_fwd_kernel`, :func:`ffn_ln_fwd_kernel` — ``csrc/ffn_fwd.cu``,
  bf16 only, H and F multiples of 128;
* ``torch.ops.dpr_scale_tpu_torch.ffn_ln_fwd`` — the LN-fused forward as a
  ``torch.library`` custom op (with a fake kernel for tracing), so that
  ``torch.export`` keeps it in an exported encoder's graph;
* :func:`fused_ffn`, :func:`fused_ffn_ln` — differentiable dispatch: CPU
  tensors take the plain versions, CUDA tensors launch the kernel or raise
  (:class:`FusedFFNLN`'s forward is the op above).
"""
from __future__ import annotations

import torch
from torch.nn.functional import gelu

from dpr_scale_tpu_torch.ops.attention import _dropout_args, dropout_keep_mask


def _mm(a, b):
    """``a @ b`` as fp32, products summed in fp32 (JAX's
    ``preferred_element_type=float32``): on the card a bf16 tensor-core GEMM
    with an fp32 result, elsewhere an fp32 product."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _ln(v, g, b, eps):
    """fp32 LayerNorm over the last axis with the fast variance."""
    mu = v.mean(dim=-1, keepdim=True)
    var = ((v * v).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (v - mu) * torch.rsqrt(var + eps) * g + b


def _ln_bwd(v, g, dout, eps):
    """VJP of :func:`_ln` in (v, scale, bias), all fp32."""
    mu = v.mean(dim=-1, keepdim=True)
    var = ((v * v).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    n = (v - mu) * inv
    dn = dout * g
    dv = inv * (dn - dn.mean(dim=-1, keepdim=True) - n * (dn * n).mean(dim=-1, keepdim=True))
    return dv, (dout * n).sum(dim=0), dout.sum(dim=0)


def _dropped(y, seed, rate):
    """keep ? y / (1 - rate) : 0 for an fp32 (N, H) tensor."""
    if rate == 0.0:
        return y
    keep = dropout_keep_mask(seed, (1, 1) + tuple(y.shape), rate, y.device).view(y.shape)
    return torch.where(keep, y * (1.0 / (1.0 - rate)), torch.zeros((), device=y.device))


def ffn_fwd_plain(x, w1, b1, w2, b2, seed: int = 0, rate: float = 0.0):
    """Plain PyTorch forward with the kernel's rounding points and dropout
    bits; returns ``(y, pre)`` in x's dtype."""
    dt = x.dtype
    pre = _mm(x, w1.to(dt)) + b1.to(dt).float()
    h = gelu(pre).to(dt)  # exact (erf) GELU
    y = _dropped(_mm(h, w2.to(dt)) + b2.to(dt).float(), seed, rate)
    return y.to(dt), pre.to(dt)


def ffn_ln_fwd_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, seed: int = 0,
                     rate: float = 0.0, eps: float = 1e-12):
    """Plain PyTorch forward of the LN-fused half-layer; returns
    ``(out, x1, pre, z)`` in r's dtype."""
    dt = r.dtype
    x1 = _ln(r.float(), g1.float(), be1.float(), eps).to(dt)
    z, pre = ffn_fwd_plain(x1, w1, b1, w2, b2, seed, rate)
    out = _ln(x1.float() + z.float(), g2.float(), be2.float(), eps)
    return out.to(dt), x1, pre, z


def _check_kernel_args(what, x, bf16s, fp32s=()):
    if not x.is_cuda:
        raise ValueError(f"{what} kernel takes CUDA tensors, got {x.device}")
    N, H = x.shape
    F = bf16s[1][1].shape[1]
    shapes = {"x": (N, H), "r": (N, H), "w1": (H, F), "b1": (F,), "w2": (F, H), "b2": (H,)}
    for name, t in bf16s:
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{what} kernel: {name} must be bf16 {shapes[name]}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    for name, t in fp32s:
        if t.dtype != torch.float32 or tuple(t.shape) != (H,):
            raise ValueError(
                f"{what} kernel: {name} must be fp32 {(H,)}, got {t.dtype} {tuple(t.shape)}"
            )
    for name, t in tuple(bf16s) + tuple(fp32s):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{what} kernel: {name} must be a contiguous, 16-byte aligned tensor "
                f"on {x.device}"
            )
    if H % 128 or F % 128 or N < 1:
        raise ValueError(
            f"{what} kernel takes H and F multiples of 128 and N >= 1; got N={N}, "
            f"H={H}, F={F}"
        )
    return N, H, F


def ffn_fwd_kernel(x, w1, b1, w2, b2, seed: int = 0, rate: float = 0.0):
    """Launch ``csrc/ffn_fwd.cu`` on the current CUDA stream; returns
    ``(y, pre)``."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    N, H, F = _check_kernel_args(
        "ffn", x, (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)))
    y = torch.empty_like(x)
    pre, h = (torch.empty(N, F, dtype=x.dtype, device=x.device) for _ in range(2))
    with torch.cuda.device(x.device):
        rc = cuda_lib.library().dst_ffn_fwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            y.data_ptr(), pre.data_ptr(), h.data_ptr(), N, H, F,
            *_dropout_args(seed, rate), torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "ffn_fwd")
    ffn_fwd_kernel.launches += 1
    return y, pre


ffn_fwd_kernel.launches = 0


def ffn_ln_fwd_kernel(r, w1, b1, w2, b2, g1, be1, g2, be2, seed: int = 0,
                      rate: float = 0.0, eps: float = 1e-12):
    """Launch the LN-fused forward of ``csrc/ffn_fwd.cu`` on the current
    CUDA stream; returns ``(out, x1, pre, z)``."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    N, H, F = _check_kernel_args(
        "ffn_ln", r, (("r", r), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)),
        (("g1", g1), ("be1", be1), ("g2", g2), ("be2", be2)))
    out, x1, z = (torch.empty_like(r) for _ in range(3))
    pre, h = (torch.empty(N, F, dtype=r.dtype, device=r.device) for _ in range(2))
    with torch.cuda.device(r.device):
        rc = cuda_lib.library().dst_ffn_ln_fwd(
            r.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            g1.data_ptr(), be1.data_ptr(), g2.data_ptr(), be2.data_ptr(),
            out.data_ptr(), x1.data_ptr(), pre.data_ptr(), z.data_ptr(), h.data_ptr(),
            N, H, F, float(eps),
            *_dropout_args(seed, rate), torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(rc, "ffn_ln_fwd")
    ffn_ln_fwd_kernel.launches += 1
    return out, x1, pre, z


ffn_ln_fwd_kernel.launches = 0


def _dispatch(x, kernel, plain):
    if x.is_cuda:
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"fused_ffn: unsupported device {x.device}")


def _ffn_core_bwd(x, w1, w2, pre, dz):
    """(dx, dw1, dw2, db1), fp32, from the post-dropout output cotangent dz
    in the activation dtype (``dpr_scale_tpu/ops/ffn.py:200-225``)."""
    dt = x.dtype
    pre_f = pre.float()
    # dpre = dh * gelu'(pre) in fp32, one elementwise pass over (N, F)
    dpre = torch.ops.aten.gelu_backward(_mm(dz, w2.to(dt).t()), pre_f).to(dt)
    dx = _mm(dpre, w1.to(dt).t())
    dw1 = _mm(x.t(), dpre)
    dw2 = _mm(gelu(pre_f).to(dt).t(), dz)
    return dx, dw1, dw2, dpre.sum(dim=0, dtype=torch.float32)


class FusedFFN(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``fused_ffn``: saves x, the weights, pre and
    y; the backward recovers the dropout mask from y's zeros (a kept entry
    that is exactly zero has measure zero)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate):
        dt = x.dtype
        fwd = _dispatch(x, ffn_fwd_kernel, ffn_fwd_plain)
        y, pre = fwd(x.contiguous(), w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt), seed, rate)
        ctx.save_for_backward(x, w1, w2, pre, y)
        ctx.rate = rate
        return y

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, pre, y = ctx.saved_tensors
        rate, dt = ctx.rate, x.dtype
        if rate > 0.0:
            dz = torch.where(y != 0, g * (1.0 / (1.0 - rate)), torch.zeros((), dtype=g.dtype,
                                                                           device=g.device))
        else:
            dz = g
        dz = dz.to(dt)
        dx, dw1, dw2, db1 = _ffn_core_bwd(x, w1, w2, pre, dz)
        db2 = dz.sum(dim=0, dtype=torch.float32)
        return dx.to(dt), dw1, db1, dw2, db2, None, None


@torch.library.custom_op("dpr_scale_tpu_torch::ffn_ln_fwd", mutates_args=())
def ffn_ln_fwd_op(r: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, g1: torch.Tensor, be1: torch.Tensor, g2: torch.Tensor,
                  be2: torch.Tensor, seed: int, rate: float,
                  eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LN-fused forward, ``(out, x1, pre, z)``: the kernel on CUDA
    tensors, the plain version on CPU ones."""
    fwd = _dispatch(r, ffn_ln_fwd_kernel, ffn_ln_fwd_plain)
    return fwd(r, w1, b1, w2, b2, g1, be1, g2, be2, seed, rate, eps)


@ffn_ln_fwd_op.register_fake
def _ffn_ln_fwd_fake(r, w1, b1, w2, b2, g1, be1, g2, be2, seed, rate, eps):
    pre = r.new_empty((r.shape[0], w1.shape[1]))
    return torch.empty_like(r), torch.empty_like(r), pre, torch.empty_like(r)


class FusedFFNLN(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``fused_ffn_ln``: saves r, the weights, the
    LN scales, x1, pre and z; the backward runs LN2, dropout, the FFN and
    LN1 backwards in plain PyTorch and returns all nine cotangents."""

    @staticmethod
    def forward(ctx, r, w1, b1, w2, b2, g1, be1, g2, be2, seed, rate, eps):
        dt = r.dtype
        out, x1, pre, z = ffn_ln_fwd_op(
            r.contiguous(), w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt), g1.float(),
            be1.float(), g2.float(), be2.float(), seed, rate, eps,
        )
        ctx.save_for_backward(r, w1, w2, g1, g2, x1, pre, z)
        ctx.rate, ctx.eps = rate, eps
        return out

    @staticmethod
    def backward(ctx, g):
        r, w1, w2, g1, g2, x1, pre, z = ctx.saved_tensors
        rate, eps = ctx.rate, ctx.eps
        s = x1.float() + z.float()
        ds, dg2, dbe2 = _ln_bwd(s, g2.float(), g.float(), eps)
        dz = torch.where(z != 0, ds * (1.0 / (1.0 - rate)), torch.zeros((), device=ds.device)) \
            if rate > 0.0 else ds
        dx1_ffn, dw1, dw2, db1 = _ffn_core_bwd(x1, w1, w2, pre, dz.to(x1.dtype))
        db2 = dz.sum(dim=0)  # the fp32 dz, before its cast (as the JAX VJP)
        dr, dg1, dbe1 = _ln_bwd(r.float(), g1.float(), ds + dx1_ffn, eps)
        return dr.to(r.dtype), dw1, db1, dw2, db2, dg1, dbe1, dg2, dbe2, None, None, None


def fused_ffn(x, w1, b1, w2, b2, seed: int = 0, rate: float = 0.0):
    """``dropout(gelu(x @ w1 + b1) @ w2 + b2)`` with the dropout at ``rate``
    keyed by the int ``seed``; differentiable in x and the weights (weight
    and bias gradients in fp32)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_ffn: dropout rate must be in [0, 1), got {rate}")
    return FusedFFN.apply(x, w1, b1, w2, b2, int(seed), float(rate))


def fused_ffn_ln(r, w1, b1, w2, b2, g1, be1, g2, be2, seed: int = 0,
                 rate: float = 0.0, eps: float = 1e-12):
    """``LN2(x1 + dropout(gelu(x1 @ w1 + b1) @ w2 + b2))`` with
    ``x1 = LN1(r)``; differentiable in all nine tensors."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_ffn_ln: dropout rate must be in [0, 1), got {rate}")
    return FusedFFNLN.apply(r, w1, b1, w2, b2, g1, be1, g2, be2, int(seed), float(rate),
                            float(eps))
