"""The port's multi-vector evaluation and the SPLADE bi-encoder's training
step against the JAX package's, on the CPU (the setup and tolerances of
``test_torch_multivec_task``).
"""
import jax
import numpy as np
import pytest
import torch

from dpr_scale_tpu.optim import make_optimizer as jax_make_optimizer
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu.train import DenseRetrieverTask as JaxDenseTask
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.optim.factory import make_optimizer
from dpr_scale_tpu_torch.train.task import DenseRetrieverTask
from test_torch_multivec_task import (CITADEL, assert_metrics_close, assert_params_close,
                                      configs, mv_batch, states, tasks)


@pytest.mark.parametrize("kind", ["citadel", "colbert"])
def test_run_eval_matches_jax(kind):
    """Two evaluation batches with a dummy context each (the expert scores
    plus the CLS score): every metric of JAX's run_eval within 1e-5."""
    kw = CITADEL if kind == "citadel" else dict(variant="colbert", tok_projection_dim=8)
    batches = [mv_batch(4, 3, seed=20 + i) for i in range(2)]
    jtask, ttask = tasks(**kw)
    jstate, tstate = states(jtask, ttask, batches[0], seed=2)
    want = jtask.run_eval(jstate, batches)
    got = ttask.run_eval(tstate, batches)
    assert set(got) == set(want) and got["query_count"] == 8
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)


def test_splade_steps_match_jax():
    """DenseRetrieverTask(encoder_family="splade") (SpladeBiEncoder: the
    max-pooled log1p(relu(MLM)) vocab vectors) against JAX's, three steps."""
    from dpr_scale_tpu.train.schedule import linear_warmup_decay as jax_schedule
    from dpr_scale_tpu_torch.train.schedule import linear_warmup_decay

    jcfg, tcfg = configs()
    sched = dict(base_lr=1e-3, warmup_steps=1, total_steps=10)
    jtask = JaxDenseTask(cfg=jcfg, mesh=get_mesh(1), encoder_family="splade",
                         optimizer=jax_make_optimizer("adamw", jax_schedule(**sched),
                                                      weight_decay=0.01, grad_clip_norm=0.5))
    ttask = DenseRetrieverTask(cfg=tcfg, encoder_family="splade",
                               optimizer=make_optimizer("adamw", linear_warmup_decay(**sched),
                                                        weight_decay=0.01, grad_clip_norm=0.5))
    batch = mv_batch(4, 2, seed=9)
    jstate = jtask.init_state(jax.random.PRNGKey(0), batch)
    tstate = ttask.init_state(state_dict=from_jax_params(jax.device_get(jstate.params)))
    assert sorted(tstate.model.state_dict())[0].startswith("context_encoder.mlm_head")
    jstep = jtask.make_train_step()
    for _ in range(3):
        jstate, jm = jstep(jstate, jtask.shard(batch))
        tstate, tm = ttask.train_step(tstate, ttask.to_device(batch))
        assert_metrics_close(tm, jax.device_get(jm))
    assert_params_close(jstate.params, tstate.model)
    with torch.no_grad():
        emb = tstate.model.encode_query(torch.from_numpy(batch["query_ids"]),
                                        torch.from_numpy(batch["query_mask"]))
    assert emb.shape == (4, jcfg.vocab_size) and float(emb.min()) >= 0.0
