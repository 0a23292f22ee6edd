"""Remat with replayable dropout (models.transformer: ``DropoutRng.fold``,
``torch.utils.checkpoint``) against the JAX package's ``nn.remat``, and the
training profiler (utils.profiling) against the JAX one's, on the CPU.

Inputs come from numpy seeds; weights cross from Flax through
``from_jax_params``. The JAX side runs its fused attention in interpret
mode, as its own tests do.
"""
import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu.train import DenseRetrieverTask as JaxTask
from dpr_scale_tpu.utils.profiling import StageTimer as JaxStageTimer
from dpr_scale_tpu_torch.models import transformer
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.models.transformer import DropoutRng
from dpr_scale_tpu_torch.train.task import DenseRetrieverTask
from dpr_scale_tpu_torch.utils.profiling import TRACE_FILE, StageTimer, trace_if
from test_torch_train import _fake_batch, _tasks


@pytest.mark.parametrize("fused_attention", [True, False])
def test_remat_gradients_match_jax_nn_remat(fused_attention):
    """Rate 0, fp32: the loss and every parameter's gradient of a training
    forward with remat, port against JAX, from the same weights and batch:
    loss within 1e-5 relative, gradients within 1e-6 + 1e-4 relative."""
    batch = _fake_batch(6, 3, seed=4)
    jtask, ttask = _tasks(fused_attention)
    jtask = JaxTask(cfg=dataclasses.replace(jtask.cfg, remat=True), mesh=get_mesh(1))
    ttask = DenseRetrieverTask(cfg=dataclasses.replace(ttask.cfg, remat=True))
    jstate = jtask.init_state(jax.random.PRNGKey(0), batch)
    grad_fn = jax.jit(jax.value_and_grad(jtask._loss_fn, has_aux=True))
    (jloss, _), jgrads = grad_fn(jstate.params, jtask.shard(batch), jax.random.PRNGKey(1))
    tstate = ttask.init_state(state_dict=from_jax_params(jax.device_get(jstate.params)))
    tloss, tgrads = ttask.loss_and_grads(tstate, ttask.to_device(batch), DropoutRng(0, 0, "cpu"))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    ref = from_jax_params(jax.device_get(jgrads))
    names = [n for n, _ in tstate.model.named_parameters()]
    assert set(ref) == set(names)
    for name, got in zip(names, tgrads):
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def _dropout_cfg(ttask, **kw):
    return dataclasses.replace(ttask.cfg, hidden_dropout=0.1, attention_dropout=0.1, **kw)


@pytest.mark.parametrize("fused_attention,fused_ffn", [(True, False), (False, False),
                                                       (True, True)])
def test_remat_equals_no_remat_bit_for_bit_with_dropout(fused_attention, fused_ffn):
    """Rate 0.1: the loss and gradients with remat equal those without it,
    bit for bit (the recompute rebuilds each layer's generators), and the
    recompute did run: each layer's forward runs twice a tower with remat,
    once without."""
    _, ttask = _tasks(fused_attention, fused_ffn=fused_ffn)
    batch = _fake_batch(6, 3, seed=8)
    calls = []
    real = transformer.TransformerLayer.forward

    def counted(self, *args, **kwargs):
        calls.append(self)
        return real(self, *args, **kwargs)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer.TransformerLayer, "forward", counted)
        for remat in (False, True):
            task = DenseRetrieverTask(cfg=_dropout_cfg(ttask, remat=remat))
            state = task.init_state(5)
            calls.clear()
            out[remat] = task.loss_and_grads(state, task.to_device(batch), DropoutRng(2, 7, "cpu"))
            out[remat, "calls"] = len(calls)
    layers = ttask.cfg.num_layers
    assert (out[False, "calls"], out[True, "calls"]) == (2 * layers, 4 * layers)
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))
    # and dropout was on: another step draws other masks
    task = DenseRetrieverTask(cfg=_dropout_cfg(ttask, remat=True))
    other = task.loss_and_grads(task.init_state(5), task.to_device(batch), DropoutRng(2, 8, "cpu"))
    assert not torch.equal(other[0], out[True][0])


def test_dropout_rng_fold_is_a_pure_function_of_its_path():
    """``fold(i)`` depends on (seed, step, path, i) alone: not on what was
    drawn from the parent; distinct indices, depths and steps draw apart."""
    def draws(rng):
        return rng.kernel_seed(), torch.rand(4, generator=rng.device).tolist()

    root = DropoutRng(1, 2, "cpu")
    first = draws(root.fold(3))
    draws(root)
    assert draws(root.fold(3)) == first == draws(DropoutRng(1, 2, "cpu").fold(3))
    seen = {str(draws(r)) for r in (root, root.fold(0), root.fold(1), root.fold(0).fold(0),
                                    DropoutRng(1, 3, "cpu").fold(3), root.fold(3))}
    assert len(seen) == 6
    assert root.fold(2).fold(5).path == (2, 5)
    with pytest.raises(ValueError):
        root.fold(-1)


def test_trace_if_writes_a_trace_and_is_a_noop_without_a_dir(tmp_path):
    with trace_if(None), trace_if(""):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "prof"
    with trace_if(str(out)):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    with open(out / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_stage_timer_summary_matches_the_jax_one():
    """The same stages in the same order: equal keys and counts, each mean
    the total over the count, and the same ``__str__`` layout."""
    timers = StageTimer(), JaxStageTimer()
    for t in timers:
        for name in ("encode", "search", "encode", "encode"):
            with t.stage(name):
                pass
    port, ref = (t.summary() for t in timers)
    assert list(port) == list(ref) == ["encode", "search"]
    for name in port:
        assert set(port[name]) == set(ref[name])
        assert port[name]["count"] == ref[name]["count"]
        assert port[name]["mean_ms"] == pytest.approx(1e3 * port[name]["total_s"] / port[name]["count"])
    pattern = r"encode=\d+\.\d\ds/3x search=\d+\.\d\ds/1x"
    assert re.fullmatch(pattern, str(timers[0])) and re.fullmatch(pattern, str(timers[1]))
