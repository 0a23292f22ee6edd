"""Port attention (dpr_scale_tpu_torch.ops.attention) against the JAX kernel.

On the CPU the port runs its plain versions; the JAX Pallas kernels (forward
and the custom-VJP backward) run in interpret mode at rate 0, as the JAX
package's own tests run them. The TPU's in-kernel PRNG has no CPU lowering,
so dropout (rate > 0) is tested on the port alone: its drop fraction, its
seeding, its backward against autograd through an explicit-mask forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.ops.attention import fused_attention as jax_fused_attention
from dpr_scale_tpu_torch.ops import attention as port


def _inputs(seed, B, nh, L, hd):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, nh, L, hd)).astype(np.float32) for _ in range(3))
    lens = rng.integers(1, L + 1, size=B)
    lens[0] = L  # one unpadded row
    bias = np.where(np.arange(L)[None, :] < lens[:, None], 0.0, -1e9)
    return q, k, v, bias[:, None, :].astype(np.float32)


@pytest.mark.parametrize("B,nh,L,hd", [(3, 2, 16, 8), (2, 4, 40, 16), (1, 12, 32, 64)])
def test_plain_matches_jax_kernel_fp32(B, nh, L, hd):
    """fp32, ragged key masks; atol 1e-5 covers fp32 summation-order noise
    in the two L-long reductions."""
    q, k, v, bias = _inputs(B * 100 + L, B, nh, L, hd)
    ref = jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.zeros((1,), jnp.int32), 0.0, True,
    )
    out = port.fused_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert out.dtype == torch.float32 and out.shape == (B, nh, L, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_plain_bf16_rounds_probs_like_jax_kernel():
    """bf16 inputs: both round the probabilities to bf16 before P.V; the
    outputs agree to one bf16 ulp of the output (|x| < 4 here)."""
    q, k, v, bias = _inputs(7, 2, 2, 24, 16)
    to_j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    ref = jax_fused_attention(
        to_j(q), to_j(k), to_j(v), jnp.asarray(bias), jnp.zeros((1,), jnp.int32), 0.0, True
    )
    to_t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    out = port.fused_attention(to_t(q), to_t(k), to_t(v), torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2.0 ** -6, rtol=0
    )


def test_fully_masked_row_stays_finite():
    q, k, v, bias = _inputs(3, 2, 1, 8, 8)
    bias[1] = -1e9  # every key of sequence 1 dropped
    out = port.fused_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert torch.isfinite(out).all()


def _jax_vjp(q, k, v, bias, g, dtype):
    cast = lambda a: jnp.asarray(a).astype(dtype)
    f = lambda q_, k_, v_: jax_fused_attention(
        q_, k_, v_, jnp.asarray(bias), jnp.zeros((1,), jnp.int32), 0.0, True
    )
    _, vjp = jax.vjp(f, cast(q), cast(k), cast(v))
    return [np.asarray(t.astype(jnp.float32)) for t in vjp(cast(g))]


@pytest.mark.parametrize("B,nh,L,hd", [(3, 2, 16, 8), (2, 4, 40, 16), (1, 12, 32, 64)])
def test_bwd_plain_and_autograd_match_jax_vjp_fp32(B, nh, L, hd):
    """Rate 0, fp32, ragged masks: dq/dk/dv of ``attention_bwd_plain`` and of
    autograd through ``fused_attention`` equal ``jax.vjp`` of the Pallas
    kernel within atol 5e-6 (fp32 summation-order noise)."""
    q, k, v, bias = _inputs(B * 10 + L, B, nh, L, hd)
    g = np.random.default_rng(L).normal(size=q.shape).astype(np.float32)
    ref = _jax_vjp(q, k, v, bias, g, jnp.float32)
    tq, tk, tv, tb, tg = (torch.from_numpy(a) for a in (q, k, v, bias, g))
    plain = port.attention_bwd_plain(tq, tk, tv, tb, tg)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    port.fused_attention(*leaves, tb).backward(tg)
    for name, r, a, b in zip("qkv", ref, plain, leaves):
        np.testing.assert_allclose(a.numpy(), r, atol=5e-6, rtol=0, err_msg=f"d{name}")
        np.testing.assert_allclose(b.grad.numpy(), r, atol=5e-6, rtol=0, err_msg=f"d{name}")


def test_bwd_plain_bf16_matches_jax_vjp_to_one_ulp():
    """bf16 inputs, rate 0: both round pd and ds*scale to bf16 at the same
    points; every gradient entry agrees to one bf16 ulp of the JAX entry."""
    q, k, v, bias = _inputs(9, 2, 3, 24, 16)
    g = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    ref = _jax_vjp(q, k, v, bias, g, jnp.bfloat16)
    to_t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = port.attention_bwd_plain(to_t(q), to_t(k), to_t(v), torch.from_numpy(bias), to_t(g))
    for name, r, a in zip("qkv", ref, got):
        assert a.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0**-100))) - 7)
        err = np.abs(a.float().numpy() - r)
        assert (err <= ulp).all(), f"d{name}: {(err > ulp).sum()} entries beyond one ulp"


def _bits_reference(seed, bh, i, j):
    """csrc/dropout_bits.cuh in plain Python integers mod 2^32."""
    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    key = fmix(seed ^ (((bh + 1) * 0x9E3779B9) & 0xFFFFFFFF))
    row = fmix(key ^ (((i + 1) * 0x85EBCA6B) & 0xFFFFFFFF))
    return fmix(row ^ (((j + 1) * 0xC2B2AE35) & 0xFFFFFFFF))


@pytest.mark.parametrize("seed", [0, 12345, 2**32 - 1])
def test_keep_mask_is_the_kernels_hash(seed):
    """The int64 tensor arithmetic (32 x 32-bit products split so nothing
    overflows) gives the kernels' uint32 bits for every entry, at a rate
    whose threshold sits in the middle of the range."""
    B, nh, L = 2, 3, 9
    rate = 0.5
    mask = port.dropout_keep_mask(seed, (B, nh, L, L), rate)
    thr = port.dropout_threshold(rate)
    want = torch.tensor([
        [[[_bits_reference(seed, b * nh + h, i, j) >= thr for j in range(L)]
          for i in range(L)] for h in range(nh)] for b in range(B)
    ])
    assert torch.equal(mask, want)


def test_dropout_drops_its_rate():
    """>= 10^5 entries: the drop fraction is within 0.01 of the rate, for
    rates 0.1 and 0.5, and rate 0 keeps everything."""
    shape = (4, 12, 64, 64)  # 196,608 entries
    for rate in (0.1, 0.5):
        frac = 1.0 - port.dropout_keep_mask(7, shape, rate).float().mean().item()
        assert abs(frac - rate) < 0.01, (rate, frac)
    assert port.dropout_keep_mask(7, shape, 0.0).all()


def test_dropout_seeding_repeats_and_decorrelates():
    """One seed gives one mask; two seeds agree on about p^2 + (1-p)^2 of
    the entries, as independent masks would; so do two heads, two rows."""
    shape, rate = (2, 4, 64, 64), 0.1
    a = port.dropout_keep_mask(3, shape, rate)
    assert torch.equal(a, port.dropout_keep_mask(3, shape, rate))
    expect = rate**2 + (1 - rate) ** 2
    b = port.dropout_keep_mask(4, shape, rate)
    assert abs((a == b).float().mean().item() - expect) < 0.01
    assert abs((a[:, 0] == a[:, 1]).float().mean().item() - expect) < 0.01
    assert abs((a[..., 0, :] == a[..., 1, :]).float().mean().item() - expect) < 0.02


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_fwd_and_bwd_match_autograd_of_explicit_mask(rate):
    """fp32, rate > 0: the plain forward and ``attention_bwd_plain`` equal
    autograd through softmax -> where(keep, p/(1-rate), 0) -> @ v with the
    same keep mask, within fp32 summation noise (atol 2e-6)."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(5, 2, 3, 24, 16))
    g = torch.from_numpy(np.random.default_rng(2).normal(size=q.shape).astype(np.float32))
    seed = 12345
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    p = torch.softmax(
        leaves[0] @ leaves[1].transpose(-1, -2) / 4.0 + bias[:, :, None, :], dim=-1
    )
    keep = port.dropout_keep_mask(seed, p.shape, rate)
    ref_out = torch.where(keep, p / (1 - rate), 0.0) @ leaves[2]
    ref = torch.autograd.grad(ref_out, leaves, g)
    out = port.attention_plain(q, k, v, bias, seed, rate)
    np.testing.assert_allclose(out.numpy(), ref_out.detach().numpy(), atol=2e-6, rtol=0)
    got = port.attention_bwd_plain(q, k, v, bias, g, seed, rate)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6, rtol=0)


def test_dropped_entries_keep_the_softmax_term():
    """A key dropped for every query gets no dv, but its dk is not zero: the
    softmax VJP uses the FULL p, so dropped entries keep -p * dsum."""
    rate, L, hd = 0.7, 3, 8
    shape = (1, 1, L, L)
    seed = next(
        s for s in range(10_000) if not port.dropout_keep_mask(s, shape, rate)[0, 0, :, 1].any()
    )
    q, k, v = (
        torch.from_numpy(np.random.default_rng(i).normal(size=(1, 1, L, hd)).astype(np.float32))
        for i in range(3)
    )
    bias = torch.zeros(1, 1, L)
    g = torch.ones(1, 1, L, hd)
    dq, dk, dv = port.attention_bwd_plain(q, k, v, bias, g, seed, rate)
    assert torch.equal(dv[0, 0, 1], torch.zeros(hd))
    p = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(hd), dim=-1)[0, 0]
    keep = port.dropout_keep_mask(seed, shape, rate)[0, 0]
    dp = torch.where(keep, (g @ v.transpose(-1, -2))[0, 0] / (1 - rate), 0.0)
    dsum = (dp * p).sum(-1)
    want = ((-p[:, 1] * dsum)[:, None] * q[0, 0]).sum(0) / np.sqrt(hd)
    assert want.abs().max() > 1e-3
    np.testing.assert_allclose(dk[0, 0, 1].numpy(), want.numpy(), atol=1e-6)


def test_bias_that_requires_grad_is_refused():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(0, 1, 1, 8, 8))
    with pytest.raises(ValueError, match="bias"):
        port.fused_attention(q, k, v, bias.requires_grad_())


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(0, 1, 1, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_fwd_kernel(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias)
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_bwd_kernel(*(t.bfloat16() for t in (q, k, v)), bias, q.bfloat16())
