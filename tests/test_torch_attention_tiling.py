"""The attention kernels' tiling, modelled in plain PyTorch, on the CPU.

``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` cannot run here, so
this file writes their algorithm out step for step at the kernels' tile
size and holds it against the plain versions (``attention_plain``,
``attention_bwd_plain``) and against the JAX Pallas kernel in interpret mode
(rate 0): 64-key tiles with zero rows past L and a mask on the tile's tail,
the forward's two sweeps (the rows' max and sum online, then p normalised
before the dropout and the rounding), and the backward's two kernels: (a)
the rows' (m, l, dsum) with dsum's numerator rescaled online, then dq; (b)
per 64-key tile, the transposed tiles against 64-query tiles whose rows past
L carry m = +inf. A tail-mask or rescaling error shows here before the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.ops.attention import fused_attention as jax_fused_attention
from dpr_scale_tpu_torch.ops import attention as port

TILE = 64  # rows of a block and of a streamed tile (attention_tiles.cuh)
LENGTHS = [1, 15, 33, 64, 65, 130, 257, 512]
HEAD_DIMS = [16, 64, 128]


def _pad_rows(x, n):
    """(..., L, hd) -> (..., n, hd) with zero rows: cp.async's zero fill."""
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[-2]))


def _keep(seed, shape, rate, n):
    """Keep bits of the (B, nh, n, n) padded problem (all kept at rate 0)."""
    B, nh = shape[:2]
    return port.dropout_keep_mask(seed, (B, nh, n, n), rate) if rate else None


def _drop(x, keep, rate):
    if not rate:
        return x
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros(()))


def tiled_forward(q, k, v, bias, seed=0, rate=0.0):
    """attention_fwd.cu: sweep 1 over the key tiles keeps the rows' max m
    and sum l of exp(s - m), rescaled as m grows; sweep 2 recomputes s,
    p = exp(s - m) / l (0 past L), drops, rounds p to the input dtype and
    accumulates O += P V tile by tile."""
    dt = q.dtype
    B, nh, L, hd = q.shape
    n = math.ceil(L / TILE) * TILE
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    kp, vp = _pad_rows(k.float(), n), _pad_rows(v.float(), n)
    bp = torch.nn.functional.pad(bias.float(), (0, n - L))[:, :, None, :]  # (B, 1, 1, n)
    keep = _keep(seed, q.shape, rate, n)

    def tile_scores(t):
        cols = slice(t, t + TILE)
        s = qf @ kp[..., cols, :].transpose(-1, -2) * scale + bp[..., cols]
        return torch.where(torch.arange(t, t + TILE) < L, s, -torch.inf), cols

    m = torch.full((B, nh, L, 1), -torch.inf)
    l = torch.zeros((B, nh, L, 1))
    for t in range(0, n, TILE):
        s, _ = tile_scores(t)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new
    o = torch.zeros((B, nh, L, hd))
    for t in range(0, n, TILE):
        s, cols = tile_scores(t)
        p = torch.exp(s - m) / l  # 0 at the masked tail: exp(-inf)
        if rate:
            p = _drop(p, keep[..., :L, cols], rate)
        o += p.to(dt).float() @ vp[..., cols, :]
    return o.to(dt)


def tiled_backward(q, k, v, bias, g, seed=0, rate=0.0):
    """attention_bwd.cu: kernel (a) sweeps the key tiles for m, l and the
    dsum numerator sum_j dp e^(s - m) (rescaled as m grows), then again for
    ds = dtype((p (dp - dsum)) scale) and dq += ds K; kernel (b) walks, per
    64-key tile, the 64-query tiles and recomputes S^T = K Q^T and
    dP^T = V G^T from the rows' (m, l, dsum) for dv += dtype(pd)^T G and
    dk += ds^T Q."""
    dt = q.dtype
    B, nh, L, hd = q.shape
    n = math.ceil(L / TILE) * TILE
    scale = 1.0 / math.sqrt(hd)
    qp, kp, vp, gp = (_pad_rows(x.float(), n) for x in (q, k, v, g))
    bkeys = torch.nn.functional.pad(bias.float(), (0, n - L))[:, :, :, None]  # (B, 1, n, 1)
    keep = _keep(seed, q.shape, rate, n)
    valid = torch.arange(n) < L

    # (a): statistics, then dq
    def tile(t):
        cols = slice(t, t + TILE)
        s = qp @ kp[..., cols, :].transpose(-1, -2) * scale + bkeys[..., cols, 0][:, :, None, :]
        s = torch.where(valid[cols], s, -torch.inf)
        d = gp @ vp[..., cols, :].transpose(-1, -2)
        return s, _drop(d, keep[..., cols] if rate else None, rate), cols

    m = torch.full((B, nh, n, 1), -torch.inf)
    l, dn = torch.zeros((B, nh, n, 1)), torch.zeros((B, nh, n, 1))
    for t in range(0, n, TILE):
        s, dp, _ = tile(t)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        e, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        dn = dn * alpha + (dp * e).sum(-1, keepdim=True)
        m = m_new
    dsum = dn / l
    dq = torch.zeros((B, nh, n, hd))
    for t in range(0, n, TILE):
        s, dp, cols = tile(t)
        p = torch.exp(s - m) / l
        ds = ((p * (dp - dsum)) * scale).to(dt).float()
        dq += ds @ kp[..., cols, :]

    # (b): query rows past L get m = +inf, l = 1, dsum = 0, so their p is 0
    m = torch.where(valid[:, None], m, torch.inf)
    l = torch.where(valid[:, None], l, 1.0)
    dsum = torch.where(valid[:, None], dsum, 0.0)
    dk, dv = torch.zeros((B, nh, n, hd)), torch.zeros((B, nh, n, hd))
    for k0 in range(0, n, TILE):
        ks = slice(k0, k0 + TILE)
        for q0 in range(0, n, TILE):
            qs = slice(q0, q0 + TILE)
            st = kp[..., ks, :] @ qp[..., qs, :].transpose(-1, -2) * scale + bkeys[..., ks, :]
            p = torch.exp(st - m[..., qs, 0][:, :, None, :]) / l[..., qs, 0][:, :, None, :]
            dt_ = vp[..., ks, :] @ gp[..., qs, :].transpose(-1, -2)
            kt = keep[..., qs, ks].transpose(-1, -2) if rate else None
            pd, dp = _drop(p, kt, rate), _drop(dt_, kt, rate)
            ds = ((p * (dp - dsum[..., qs, 0][:, :, None, :])) * scale).to(dt).float()
            dv[..., ks, :] += pd.to(dt).float() @ gp[..., qs, :]
            dk[..., ks, :] += ds @ qp[..., qs, :]
    return tuple(x[..., :L, :].to(dt) for x in (dq, dk, dv))


def _inputs(L, hd, seed):
    """B = 3, nh = 2: sequence 0 unpadded, 1 ragged, 2 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(3, 2, L, hd)).astype(np.float32) for _ in range(4))
    lens = np.array([L, rng.integers(1, L + 1), L])
    bias = np.where(np.arange(L)[None, :] < lens[:, None], 0.0, -1e9).astype(np.float32)
    bias[2] = -1e9
    return q, k, v, bias[:, None, :], g


def _torch(arrays, dtype):
    q, k, v, bias, g = (torch.from_numpy(a) for a in arrays)
    return q.to(dtype), k.to(dtype), v.to(dtype), bias, g.to(dtype)


def _f32(x):
    """A torch tensor or a numpy array of the reference, as an fp32 tensor."""
    return x.float() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))


def _assert_fwd_close(got, want, dtype):
    """fp32: within 1e-5 of max |ref|; bf16: 1e-2 + 1e-2 |ref| (two ulps)."""
    got, want = got.float(), _f32(want)
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    else:
        torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)


def _assert_bwd_close(got, want, dtype):
    """Each gradient within 1e-5 (fp32) or 2e-2 (bf16) of its max |ref|."""
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), _f32(b)
        assert torch.isfinite(a).all(), name
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        assert err <= rel * scale + 1e-7, f"{name}: max err {err} vs max |ref| {scale}"


_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", _DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("L", LENGTHS)
def test_tiled_forward_matches_plain(L, hd, dtype, rate):
    q, k, v, bias, _ = _torch(_inputs(L, hd, L + hd), dtype)
    got = tiled_forward(q, k, v, bias, 1234, rate)
    assert got.dtype == dtype
    _assert_fwd_close(got, port.attention_plain(q, k, v, bias, 1234, rate), dtype)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", _DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("L", LENGTHS)
def test_tiled_backward_matches_plain(L, hd, dtype, rate):
    q, k, v, bias, g = _torch(_inputs(L, hd, 3 * L + hd), dtype)
    got = tiled_backward(q, k, v, bias, g, 99, rate)
    assert all(x.dtype == dtype for x in got)
    _assert_bwd_close(got, port.attention_bwd_plain(q, k, v, bias, g, 99, rate), dtype)


def _jax(arrays, dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v, bias, g = arrays
    cast = lambda a: jnp.asarray(a).astype(jd)
    f = lambda q_, k_, v_: jax_fused_attention(
        q_, k_, v_, jnp.asarray(bias), jnp.zeros((1,), jnp.int32), 0.0, True
    )
    out, vjp = jax.vjp(f, cast(q), cast(k), cast(v))
    grads = vjp(cast(g))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(t.astype(jnp.float32)) for t in grads]


@pytest.mark.parametrize("dtype", _DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("L", LENGTHS)
def test_tiled_model_matches_jax_kernel(L, hd, dtype):
    """Rate 0: the tiled forward and backward against the Pallas kernel and
    its custom VJP, run in interpret mode."""
    arrays = _inputs(L, hd, 5 * L + hd)
    want_out, want_grads = _jax(arrays, dtype)
    q, k, v, bias, g = _torch(arrays, dtype)
    _assert_fwd_close(tiled_forward(q, k, v, bias), want_out, dtype)
    _assert_bwd_close(tiled_backward(q, k, v, bias, g), want_grads, dtype)
