"""The port's MultiVecRetrieverTask against the JAX package's, on the CPU:
three training steps of CITADEL (teacher distillation, every regulariser,
annealed at epoch 1 of 2; in-batch and pairwise), COIL and ColBERT from the
same weights and batch.

Tiny fp32 models (2 layers, hidden 32, vocab 48, L = 10), dropout 0,
weights from a Flax init through ``from_jax_params``. Each step's loss and
every metric within 1e-5 relative, the pre-clip grad_norm within 1e-4, the
parameters after three steps within 2e-5 (the dense task's bounds). The
router's ``topk`` breaks ties at 0 unlike ``lax.top_k``; a zero-weight
expert id changes neither the loss nor its gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.models import TransformerConfig as JaxConfig
from dpr_scale_tpu.optim import make_optimizer as jax_make_optimizer
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu.train.multivec import MultiVecRetrieverTask as JaxTask
from dpr_scale_tpu.train.schedule import linear_warmup_decay as jax_schedule
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.models.transformer import TransformerConfig
from dpr_scale_tpu_torch.optim.factory import make_optimizer
from dpr_scale_tpu_torch.train.multivec import MultiVecRetrieverTask
from dpr_scale_tpu_torch.train.schedule import linear_warmup_decay

VOCAB = 48

CITADEL = dict(variant="citadel", tok_projection_dim=8, cls_projection_dim=8, add_cls=True,
               query_topk=2, context_topk=3, teacher_coef=0.3, tau=2.0,
               query_expert_load_loss_coef=0.01, context_expert_load_loss_coef=0.02,
               query_router_marg_load_loss_coef=0.03, context_router_marg_load_loss_coef=0.04,
               anneal_factor=1.0, max_epochs=2)
KINDS = {
    "citadel": CITADEL,
    "citadel_pairwise_max": {**CITADEL, "in_batch": False, "query_pool": "max"},
    "coil": dict(variant="coil", tok_projection_dim=8),
    "colbert": dict(variant="colbert", tok_projection_dim=8, add_cls=True),
}


def mv_batch(B, M, L=10, seed=0, dummies=True):
    """A multi-vector batch as the datamodule lays it out: contexts in
    blocks of M a query (the positive first), ragged masks, teacher scores,
    one dummy context when ``dummies``."""
    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(5, VOCAB, size=(n, L)).astype(np.int32)

    def mask(n):
        lens = rng.integers(3, L + 1, size=n)
        return (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)

    ctx_mask = np.zeros(B * M, bool)
    if dummies:
        ctx_mask[M + M - 1] = True
    qm, cm = mask(B), mask(B * M)
    return {
        "query_ids": ids(B) * qm, "query_mask": qm,
        "contexts_ids": ids(B * M) * cm, "contexts_mask": cm,
        "pos_ctx_indices": (np.arange(B) * M).astype(np.int32),
        "scores": rng.normal(size=(B, M)).astype(np.float32),
        "ctx_mask": ctx_mask,
    }


def configs():
    jcfg = dataclasses.replace(JaxConfig.tiny(vocab_size=VOCAB), dtype=jnp.float32,
                               hidden_size=32, num_heads=2, intermediate_size=64,
                               fused_attention=False)
    fields = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype"}
    tcfg = TransformerConfig(dtype=torch.float32,
                             **{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    return jcfg, tcfg


def tasks(lr=1e-3, clip=0.5, weight_decay=0.01, **kw):
    """The JAX task and the port's with the same optimizer."""
    jcfg, tcfg = configs()
    sched = dict(base_lr=lr, warmup_steps=1, total_steps=10)
    jtask = JaxTask(cfg=jcfg, mesh=get_mesh(1), optimizer=jax_make_optimizer(
        "adamw", jax_schedule(**sched), weight_decay=weight_decay, grad_clip_norm=clip), **kw)
    ttask = MultiVecRetrieverTask(cfg=tcfg, optimizer=make_optimizer(
        "adamw", linear_warmup_decay(**sched), weight_decay=weight_decay, grad_clip_norm=clip),
        **kw)
    return jtask, ttask


def states(jtask, ttask, batch, seed=0):
    jstate = jtask.init_state(jax.random.PRNGKey(seed), batch)
    tstate = ttask.init_state(state_dict=from_jax_params(jax.device_get(jstate.params)))
    return jstate, tstate


def assert_metrics_close(got, want, rtol=1e-5):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, val in want.items():
        tol = 1e-4 if key == "grad_norm" else rtol
        np.testing.assert_allclose(float(got[key]), float(val), rtol=tol, atol=1e-6, err_msg=key)


def assert_params_close(jparams, model, atol=2e-5):
    ref = from_jax_params(jax.device_get(jparams))
    got = model.state_dict()
    assert set(ref) == set(got)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_three_steps_match_jax(kind):
    kw = KINDS[kind]
    batch = mv_batch(4, 3, seed=len(kind))
    jtask, ttask = tasks(**kw)
    jstate, tstate = states(jtask, ttask, batch)
    jstep = jtask.make_train_step()
    for _ in range(3):
        jstate, jm = jstep(jstate, jtask.shard(batch), 1.0)
        tstate, tm = ttask.train_step(tstate, ttask.to_device(batch), 1.0)
        assert_metrics_close(tm, jax.device_get(jm))
    if kw["variant"] == "citadel":
        assert {"router_loss", "expert_loss", "query_router_marg_load_loss",
                "context_expert_load_loss", "avg_query_marg_num_experts"} <= set(tm)
    assert tstate.step == 3
    assert_params_close(jstate.params, tstate.model)


def test_anneal_follows_the_epoch():
    """At epoch 0 the annealed regularisers are 0, at epoch 1 of 2 half of
    their value, at epoch 2 whole, as in JAX."""
    batch = mv_batch(4, 3, seed=1)
    _, ttask = tasks(**CITADEL)
    tstate = ttask.init_state(0)
    vals = []
    for epoch in (0.0, 1.0, 2.0):
        _loss, m, _g = ttask.loss_and_grads(tstate, ttask.to_device(batch), None, epoch)
        vals.append(m["context_router_marg_load_loss"].item())
    assert vals[0] == 0.0 and vals[2] > 0
    np.testing.assert_allclose(vals[1], vals[2] / 2, rtol=1e-6)
