"""GradCache in the port (dpr_scale_tpu_torch.train.gradcache) against the
JAX package's ``grad_cache_chunks`` step, and against one autograd pass
over the same chunk folds, on the CPU.

Inputs come from numpy seeds; weights cross from Flax through
``from_jax_params``. The JAX side runs its fused attention in interpret
mode, as its own tests do.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.models.transformer import DropoutRng, TransformerConfig
from dpr_scale_tpu_torch.optim.factory import make_optimizer
from dpr_scale_tpu_torch.train.gradcache import grad_cache_grads
from dpr_scale_tpu_torch.train.loss import contrastive_loss
from dpr_scale_tpu_torch.train.task import DenseRetrieverTask
from test_torch_train import _assert_params_close, _fake_batch, _tasks


@pytest.mark.parametrize("chunks,fused_attention", [(4, True), (2, False)])
def test_grad_cache_three_steps_match_jax(chunks, fused_attention):
    """Rate 0, fp32: the port's GradCache step and the JAX one from the same
    weights and batch: each step's loss within 1e-5 and pre-clip grad_norm
    within 1e-4 relative, the parameters after three steps within 2e-5 (the
    JAX package's own GradCache-vs-monolithic bounds)."""
    batch = _fake_batch(8, 3, seed=21)
    jtask, ttask = _tasks(fused_attention, grad_cache_chunks=chunks)
    jstate = jtask.init_state(jax.random.PRNGKey(0), batch)
    tstate = ttask.init_state(state_dict=from_jax_params(jax.device_get(jstate.params)))
    jstep = jtask.make_train_step()
    for _ in range(3):
        jstate, jm = jstep(jstate, jtask.shard(batch))
        tstate, tm = ttask.train_step(tstate, ttask.to_device(batch))
        np.testing.assert_allclose(float(tm["train_loss"]), float(jm["train_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert tstate.step == 3
    _assert_params_close(jstate.params, tstate.model, atol=2e-5, rtol=0)


def _dropout_task(chunks, fused_ffn=False, remat=False):
    cfg = dataclasses.replace(
        TransformerConfig.tiny(), dtype=torch.float32, num_heads=2, hidden_size=16,
        intermediate_size=32, hidden_dropout=0.1, attention_dropout=0.1,
        fused_attention=True, fused_ffn=fused_ffn, remat=remat,
    )
    return DenseRetrieverTask(cfg=cfg, grad_cache_chunks=chunks,
                              optimizer=make_optimizer("adamw", 1e-3))


@pytest.mark.parametrize("chunks,fused_ffn", [(2, False), (4, False), (2, True)])
def test_grad_cache_with_dropout_equals_one_pass_over_the_chunk_folds(chunks, fused_ffn):
    """Rate 0.1: GradCache's loss and gradients equal one autograd pass that
    encodes chunk ``g`` (strided rows) with ``rng.fold(g)``, puts the rows
    back in order and takes the loss of the whole batch: phases 1 and 3
    draw the masks and kernel seeds of that pass."""
    task = _dropout_task(chunks, fused_ffn)
    state = task.init_state(3)
    batch = task.to_device(_fake_batch(8, 3, seed=5))
    rng = DropoutRng(7, 2, "cpu")
    loss, grads = task.loss_and_grads(state, batch, rng)

    B, C = 8, chunks
    qs, cs = [], []
    for g in range(C):
        q, c = state.model(batch["query_ids"][g::C], batch["query_mask"][g::C],
                           batch["contexts_ids"].view(B, 3, -1)[g::C].reshape(-1, 8),
                           batch["contexts_mask"].view(B, 3, -1)[g::C].reshape(-1, 8),
                           rng.fold(g))
        qs.append(q)
        cs.append(c.view(B // C, 3, -1))
    q = torch.stack(qs, 1).reshape(B, -1)
    c = torch.stack(cs, 1).reshape(3 * B, -1)
    want_loss, _ = contrastive_loss(q, c, batch["pos_ctx_indices"], batch["ctx_mask"], 1.0, True)
    params = list(state.model.parameters())
    want = torch.autograd.grad(want_loss, params, allow_unused=True)
    np.testing.assert_allclose(float(loss), want_loss.item(), rtol=1e-6)
    for (name, _), got, ref in zip(state.model.named_parameters(), grads, want):
        ref = torch.zeros_like(got) if ref is None else ref
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=1e-5, err_msg=name)
    # and not the monolithic pass, whose masks are the unchunked rng's
    mono, _ = task._loss(state.model, batch, rng, True)
    assert abs(float(mono) - float(loss)) > 1e-6


def test_grad_cache_with_remat_equals_grad_cache_without_it():
    """Rate 0.1: remat inside GradCache's phase 3 changes no bit."""
    batch = _fake_batch(8, 3, seed=6)
    out = []
    for remat in (False, True):
        task = _dropout_task(2, remat=remat)
        state = task.init_state(1)
        out.append(task.loss_and_grads(state, task.to_device(batch), DropoutRng(0, 9, "cpu")))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_grad_cache_refuses_a_batch_that_does_not_split():
    task = _dropout_task(4)
    state = task.init_state(0)
    with pytest.raises(ValueError, match="grad_cache_chunks=4"):
        task.loss_and_grads(state, task.to_device(_fake_batch(6, 2, seed=0)))


def test_grad_cache_keeps_integer_leaves_and_drops_chunk_scalars():
    """Over dicts of encoder outputs (the multi-vector tasks' form): the
    loss sees every float and integer leaf of the whole batch in row order
    and no per-chunk scalar; its gradients equal autograd's through the
    unchunked computation; ``.grad`` of the parameters is left as it was."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(4, 3, generator=gen).requires_grad_(True)
    w.grad = torch.full_like(w, 7.0)
    B, ratio, C = 6, 2, 3
    batch = {"query_ids": torch.randint(0, 4, (B, 5), generator=gen),
             "query_mask": torch.ones(B, 5, dtype=torch.int32),
             "contexts_ids": torch.randint(0, 4, (B * ratio, 5), generator=gen),
             "contexts_mask": torch.ones(B * ratio, 5, dtype=torch.int32)}

    def side(ids):
        return {"repr": w[ids].sum(1), "ids": ids[:, 0], "mean": w.sum()}

    def encode_chunk(qi, qm, ci, cm, rng):
        assert rng is None
        return side(qi), side(ci)

    seen = {}

    def loss_on_reprs(q, c):
        seen["keys"] = (sorted(q), sorted(c))
        seen["ids"] = (q["ids"], c["ids"])
        scores = q["repr"] @ c["repr"].T + q["ids"][:, None] - c["ids"][None, :]
        return scores.logsumexp(-1).mean(), {"n": len(scores)}

    loss, aux, grads = grad_cache_grads([w], batch, None, C, encode_chunk, loss_on_reprs)
    assert seen["keys"] == (["ids", "repr"], ["ids", "repr"]) and aux == {"n": B}
    assert torch.equal(seen["ids"][0], batch["query_ids"][:, 0])
    assert torch.equal(seen["ids"][1], batch["contexts_ids"][:, 0])
    want_loss, _ = loss_on_reprs(side(batch["query_ids"]), side(batch["contexts_ids"]))
    (want,) = torch.autograd.grad(want_loss, [w])
    torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-6, atol=0)
    torch.testing.assert_close(grads[0], want, rtol=1e-5, atol=1e-6)
    assert torch.equal(w.grad, torch.full_like(w, 7.0))


def test_grad_cache_takes_float_leaves_without_a_gradient():
    """A float leaf with a batch axis that the encoder makes from constants
    (a token mask; the CITADEL router's usage counts) has no graph: the loss
    still sees it and differentiates it in phase 2, and phase 3 skips it, as
    JAX's VJP gives it a zero cotangent. Loss and gradients equal autograd's
    through the unchunked computation."""
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(5, 3, generator=gen).requires_grad_(True)
    B, ratio, C = 4, 3, 2
    batch = {"query_ids": torch.randint(0, 5, (B, 6), generator=gen),
             "query_mask": torch.ones(B, 6, dtype=torch.int32),
             "contexts_ids": torch.randint(0, 5, (B * ratio, 6), generator=gen),
             "contexts_mask": torch.ones(B * ratio, 6, dtype=torch.int32)}

    def side(ids):
        mask = (ids > 1).float()  # no grad_fn
        return {"repr": (w[ids] * mask[..., None]).sum(1), "mask": mask}

    def loss_on_reprs(q, c):
        scores = q["repr"] @ c["repr"].T + q["mask"].sum(1, keepdim=True) * c["mask"].mean(1)
        return scores.logsumexp(-1).mean(), {}

    loss, _aux, grads = grad_cache_grads(
        [w], batch, None, C, lambda qi, qm, ci, cm, rng: (side(qi), side(ci)), loss_on_reprs)
    want_loss, _ = loss_on_reprs(side(batch["query_ids"]), side(batch["contexts_ids"]))
    (want,) = torch.autograd.grad(want_loss, [w])
    torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-6, atol=0)
    torch.testing.assert_close(grads[0], want, rtol=1e-5, atol=1e-6)
