"""The port's multi-vector GradCache step against the JAX package's and
its own monolithic step, on the CPU (the setup and tolerances of
``test_torch_multivec_task``).
"""
import jax
import numpy as np
import pytest

from test_torch_multivec_task import (CITADEL, assert_metrics_close, assert_params_close,
                                      mv_batch, states, tasks)


@pytest.mark.parametrize("chunks", [2, 4])
def test_grad_cache_steps_match_jax(chunks):
    """CITADEL with every loss term under GradCache (strided chunks; the
    routing statistics recomputed from the whole batch's router_mask)
    against JAX's ``grad_cache_chunks`` step."""
    batch = mv_batch(8, 2, seed=11 + chunks)
    jtask, ttask = tasks(grad_cache_chunks=chunks, **CITADEL)
    jstate, tstate = states(jtask, ttask, batch)
    jstep = jtask.make_train_step()
    for _ in range(3):
        jstate, jm = jstep(jstate, jtask.shard(batch), 1.0)
        tstate, tm = ttask.train_step(tstate, ttask.to_device(batch), 1.0)
        assert_metrics_close(tm, jax.device_get(jm))
    assert_params_close(jstate.params, tstate.model)


def test_grad_cache_equals_the_monolithic_step():
    """The port's GradCache gradient equals its monolithic one (rate 0)."""
    batch = mv_batch(8, 2, seed=3)
    _, mono = tasks(**CITADEL)
    _, cached = tasks(grad_cache_chunks=4, **CITADEL)
    state = mono.init_state(5)
    b = mono.to_device(batch)
    lm, mm, gm = mono.loss_and_grads(state, b, None, 1.0)
    lc, mc, gc = cached.loss_and_grads(state, b, None, 1.0)
    np.testing.assert_allclose(lc.item(), lm.item(), rtol=1e-6)
    for key in ("avg_query_marg_num_experts", "avg_context_cond_num_experts"):
        assert float(mc[key]) == float(mm[key])
    for a, g in zip(gm, gc):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-4, atol=1e-6)
