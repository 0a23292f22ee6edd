"""The port's multi-vector scorers and losses (dpr_scale_tpu_torch.train.multivec)
against the JAX package's, and the blocked ``expert_sim_score`` against the
literal transcription, on the CPU.

Inputs come from numpy seeds and look like an encoder's outputs: routing
weights ``log1p(relu(.))`` (about half of them 0), ids from a small range so
that many token pairs match, pad positions with id -1, weight 0 and a zero
vector. The gated products then tie at 0 everywhere (gated-out pairs and
zero-weight matches), which is where the max's gradient is split among the
tied entries: the blocked scorer must split it as the literal form and JAX
do. Values and VJPs (one random cotangent) within 1e-5 absolute of JAX,
the scores being O(1); blocked against literal within 1e-5 (the products
are summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from dpr_scale_tpu.train import multivec as jmv
from dpr_scale_tpu_torch.train import multivec as tmv

TOL = 1e-5
DIFF_KEYS = ("expert_repr", "expert_weights")


def _side(rng, n, L, K, variant, D=6, n_ids=5):
    """One side's output dict (numpy): ragged lengths, pads at the end."""
    lens = rng.integers(2, L + 1, size=n)
    live = np.arange(L)[None, :] < lens[:, None]
    out = {"attention_mask": live.astype(np.float32),
           "expert_repr": (rng.normal(size=(n, L, D)) * live[..., None]).astype(np.float32)}
    if variant == "colbert":
        return out
    shape = (n, L, K) if variant == "citadel" else (n, L)
    ids = rng.integers(0, n_ids, size=shape)
    m = live[..., None] if variant == "citadel" else live
    out["expert_ids"] = np.where(m, ids, -1).astype(np.int32)
    if variant == "citadel":
        w = np.log1p(np.maximum(rng.normal(size=shape), 0.0)) * m
        out["expert_weights"] = w.astype(np.float32)
    return out


def _inputs(variant, seed, Q=3, M=4, LQ=5, LC=7):
    rng = np.random.default_rng(seed)
    q = _side(rng, Q, LQ, 2, variant)
    c = _side(rng, Q * M, LC, 3, variant)
    ctx_mask = np.zeros(Q * M, bool)
    ctx_mask[[3, 6]] = True
    return q, c, ctx_mask


def _torch(d):
    return {k: torch.tensor(v, requires_grad=k in DIFF_KEYS) for k, v in d.items()}


def _jax_value_and_vjp(q, c, ctx_mask, pairwise, pool, cot):
    diff = lambda d: {k: jnp.asarray(d[k]) for k in DIFF_KEYS if k in d}
    rest = lambda d: {k: jnp.asarray(v) for k, v in d.items() if k not in DIFF_KEYS}

    def f(qd, cd):
        return jmv.expert_sim_score({**rest(q), **qd}, {**rest(c), **cd}, jnp.asarray(ctx_mask),
                                    pairwise=pairwise, query_pool=pool)

    val, vjp = jax.vjp(f, diff(q), diff(c))
    gq, gc = vjp(jnp.asarray(cot))
    return np.asarray(val), gq, gc


def _torch_value_and_grads(fn, q, c, ctx_mask, pairwise, pool, cot, **kw):
    tq, tc = _torch(q), _torch(c)
    val = fn(tq, tc, torch.tensor(ctx_mask), pairwise=pairwise, query_pool=pool, **kw)
    leaves = [d[k] for d in (tq, tc) for k in DIFF_KEYS if k in d]
    grads = torch.autograd.grad(val, leaves, torch.tensor(cot))
    return val.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("pool", ["sum", "max"])
@pytest.mark.parametrize("pairwise", [False, True], ids=["inbatch", "pairwise"])
@pytest.mark.parametrize("variant", ["citadel", "coil", "colbert"])
def test_expert_sim_score_and_vjp_match_jax(variant, pairwise, pool):
    """The blocked scorer (a block far below the product, so queries and
    contexts are both split) against JAX's, values and VJPs."""
    seed = ["citadel", "coil", "colbert"].index(variant) * 4 + 2 * pairwise + (pool == "max")
    q, c, ctx_mask = _inputs(variant, seed=seed)
    n_ctx = 4 if pairwise else 12
    cot = np.random.default_rng(1).normal(size=(3, n_ctx)).astype(np.float32)
    want, jgq, jgc = _jax_value_and_vjp(q, c, ctx_mask, pairwise, pool, cot)
    got, grads = _torch_value_and_grads(tmv.expert_sim_score, q, c, ctx_mask, pairwise, pool,
                                        cot, block=150)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    jgrads = [np.asarray(d[k]) for d in (jgq, jgc) for k in DIFF_KEYS if k in d]
    assert len(jgrads) == len(grads)
    for g, j in zip(grads, jgrads):
        np.testing.assert_allclose(g, j, rtol=0, atol=TOL)


@pytest.mark.parametrize("block", [1, 200, 5000, tmv.SCORE_BLOCK])
@pytest.mark.parametrize("variant", ["citadel", "coil"])
def test_blocked_equals_literal_with_zero_weight_ties(variant, block):
    """Every block size, down to one query against one context, against the
    literal form on inputs where most gated products tie at 0."""
    q, c, ctx_mask = _inputs(variant, seed=7, Q=4, M=3, LQ=6, LC=5)
    if variant == "citadel":
        assert (q["expert_weights"] == 0).mean() > 0.3
    cot = np.random.default_rng(2).normal(size=(4, 12)).astype(np.float32)
    for pool in ("sum", "max"):
        want, wgrads = _torch_value_and_grads(tmv.expert_sim_score_literal, q, c, ctx_mask,
                                              False, pool, cot)
        got, grads = _torch_value_and_grads(tmv.expert_sim_score, q, c, ctx_mask, False, pool,
                                            cot, block=block)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        for g, w in zip(grads, wgrads):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


class _LargestTensor(TorchDispatchMode):
    """Records the most elements of any tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


def test_blocked_scorer_working_set_is_bounded():
    """Forward and backward (the checkpointed blocks' recompute included)
    never make a tensor above the block, while the literal form makes the
    whole (Q, LQ*KQ, C, LC*KC) product."""
    Q, LQ, KQ, M, LC, KC = 6, 7, 2, 2, 9, 3
    rng = np.random.default_rng(3)
    q, c = _side(rng, Q, LQ, KQ, "citadel", D=8), _side(rng, Q * M, LC, KC, "citadel", D=8)
    full = Q * LQ * KQ * Q * M * LC * KC
    block = 2000
    for fn, kw in ((tmv.expert_sim_score, {"block": block}), (tmv.expert_sim_score_literal, {})):
        tq, tc = _torch(q), _torch(c)
        with _LargestTensor() as rec:
            out = fn(tq, tc, **kw)
            torch.autograd.grad(out.sum(), [tq["expert_repr"], tc["expert_weights"]])
        if fn is tmv.expert_sim_score:
            assert rec.most <= block < full // 10, (rec.most, full)
        else:
            assert rec.most == full


@pytest.mark.parametrize("pairwise", [False, True])
def test_dot_score_and_losses_match_jax(pairwise):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 5)).astype(np.float32)
    c = rng.normal(size=(9, 5)).astype(np.float32)
    mask = np.zeros(9, bool)
    mask[[2, 7]] = True
    want = np.asarray(jmv.dot_score(jnp.asarray(q), jnp.asarray(c), jnp.asarray(mask), pairwise))
    got = tmv.dot_score(torch.tensor(q), torch.tensor(c), torch.tensor(mask), pairwise).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    teacher = rng.normal(size=want.shape).astype(np.float32)
    labels = np.array([0, 1, 2] if not pairwise else [0, 0, 1], np.int32)
    finite = np.where(want < -1e29, -30.0, want).astype(np.float32)
    for jfn, tfn, a, b in ((jmv.distilled_loss, tmv.distilled_loss, finite / 2, teacher / 2),
                           (jmv.softmax_ce, tmv.softmax_ce, want, labels)):
        j = float(jfn(jnp.asarray(a), jnp.asarray(b)))
        t = float(tfn(torch.tensor(a), torch.tensor(b)))
        np.testing.assert_allclose(t, j, rtol=1e-6)
