"""The port's optimizers (dpr_scale_tpu_torch.optim: lamb, madgrad and
MultiSteps accumulation, beside adamw) against optax and the JAX package's
madgrad, their state in checkpoints, and resumes that equal unbroken runs,
on the CPU.

Parameters and gradients come from numpy seeds and go to both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpr_scale_tpu.optim import make_optimizer as jax_make_optimizer
from dpr_scale_tpu.train.schedule import linear_warmup_decay as jax_schedule
from dpr_scale_tpu_torch.cli import train
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.optim.factory import MultiSteps, make_optimizer
from dpr_scale_tpu_torch.optim.madgrad import Madgrad
from dpr_scale_tpu_torch.train.checkpoint import CheckpointManager
from dpr_scale_tpu_torch.train.schedule import linear_warmup_decay
from dpr_scale_tpu_torch.train.task import DenseRetrieverTask
from test_torch_checkpoint import _argv, _lrs, _same
from test_torch_train import _assert_params_close, _fake_batch, _tasks

SHAPES = [(3, 4), (5,), (2, 3, 2), (4,)]
UPDATES = 6


def _params_and_grads(seed):
    """Parameters (the last one all zero: lamb's trust ratio is 1 there) and
    UPDATES gradients, from a numpy seed."""
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    params[-1][:] = 0.0
    grads = [[rng.normal(scale=0.7, size=s).astype(np.float32) for s in SHAPES]
             for _ in range(UPDATES)]
    return params, grads


@pytest.mark.parametrize("accumulate", [1, 2, 3])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("name", ["adamw", "lamb", "madgrad"])
def test_optimizer_updates_match_the_jax_package(name, weight_decay, accumulate):
    """UPDATES steps of the port's optimizer and the JAX package's, built by
    their ``make_optimizer`` with a clip at 1.0 and a warmup-decay schedule:
    the parameters within 1e-6 after every step. With ``accumulate`` k the
    clip runs on the mean of k gradients and the schedule advances once per
    k steps (optax.MultiSteps)."""
    sched = dict(base_lr=0.05, warmup_steps=2, total_steps=8)
    kw = dict(weight_decay=weight_decay, grad_clip_norm=1.0, accumulate_steps=accumulate)
    tx = jax_make_optimizer(name, jax_schedule(**sched), **kw)
    port = make_optimizer(name, linear_warmup_decay(**sched), **kw)
    params, grads = _params_and_grads(seed=len(name) + accumulate)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tx_update = jax.jit(tx.update)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = port.init(tp)
    for i, g in enumerate(grads):
        updates, js = tx_update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        before = [t.clone() for t in tp]
        port.update(tp, [torch.from_numpy(x.copy()) for x in g], ts)
        if (i + 1) % accumulate:  # a micro-step between updates moves nothing
            assert all(torch.equal(a, b) for a, b in zip(before, tp))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0,
                                       err_msg=f"update {i + 1}")
    assert ts["count"] == UPDATES // accumulate
    assert ts["optimizer"] == port.name


def test_lamb_trust_ratio_and_madgrad_state():
    """lamb leaves a zero parameter's step unscaled (ratio 1); madgrad keeps
    x0 at the initial parameters and its sums in the state."""
    lamb = make_optimizer("lamb", 0.1)
    p = [torch.zeros(3), torch.ones(3)]
    state = lamb.init(p)
    lamb.update(p, [torch.ones(3), torch.ones(3)], state)
    torch.testing.assert_close(p[0], torch.full((3,), -0.1), rtol=1e-5, atol=0)
    mad = make_optimizer("madgrad", 0.1)
    assert isinstance(mad, Madgrad) and mad.eps == 1e-6
    p = [torch.ones(2)]
    state = mad.init(p)
    mad.update(p, [torch.ones(2)], state)
    assert set(state) == {"optimizer", "count", "grad_sum", "grad_sum_sq", "x0"}
    assert torch.equal(state["x0"][0], torch.ones(2)) and state["count"] == 1
    assert isinstance(make_optimizer("adam", accumulate_steps=2), MultiSteps)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")


@pytest.mark.parametrize("name,accumulate", [("adamw", 2), ("madgrad", 1), ("lamb", 3)])
def test_task_steps_with_each_optimizer_match_jax(name, accumulate):
    """Three train steps of the JAX task and the port's from the same
    weights (dropout 0, fp32) with the optimizer and accumulation of the
    config: losses within 1e-5, the parameters within 2e-6 + 1e-4 relative."""

    batch = _fake_batch(6, 3, seed=2)
    jtask, ttask = _tasks(False)
    sched = dict(base_lr=1e-3, warmup_steps=1, total_steps=10)
    kw = dict(weight_decay=0.01, grad_clip_norm=0.5, accumulate_steps=accumulate)
    jtask.optimizer = jax_make_optimizer(name, jax_schedule(**sched), **kw)
    ttask.optimizer = make_optimizer(name, linear_warmup_decay(**sched), **kw)
    jstate = jtask.init_state(jax.random.PRNGKey(0), batch)
    # madgrad's x0 aliases the params' buffers, which the step donates
    jstate = jstate.replace(opt_state=jax.tree_util.tree_map(jnp.copy, jstate.opt_state))
    tstate = ttask.init_state(state_dict=from_jax_params(jax.device_get(jstate.params)))
    jstep = jtask.make_train_step()
    for _ in range(3):
        jstate, jm = jstep(jstate, jtask.shard(batch))
        tstate, tm = ttask.train_step(tstate, ttask.to_device(batch))
        np.testing.assert_allclose(float(tm["train_loss"]), float(jm["train_loss"]), rtol=1e-5)
    _assert_params_close(jstate.params, tstate.model, atol=2e-6, rtol=1e-4)


@pytest.mark.parametrize("extra,kill_at", [
    (["trainer.accumulate_grad_batches=2"], 3),
    (["task.optim.name=madgrad"], 6),
], ids=["accumulate_mid_cycle", "madgrad"])
def test_resume_with_the_optimizer_state_equals_the_unbroken_run(
        tiny_bert_dir, dpr10_jsonl, tmp_path, monkeypatch, extra, kill_at):
    """cli.train for 10 steps unbroken, against a run killed after its save
    at ``kill_at`` and resumed with --resume: the same LR at every step and
    at step 10 the same state bit for bit. With accumulation over 2 steps
    the save at step 3 lands in the middle of a cycle (``mini_step`` 1, the
    mean holding step 3's gradient); madgrad's state is its sums and x0."""
    log = lambda name: f"trainer.metrics_jsonl={tmp_path / name}"
    train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "a", log("a.jsonl"), *extra))
    real_save = CheckpointManager.save
    saved = {}

    def save_then_die(self, step, state, metrics=None):
        real_save(self, step, state, metrics)
        if step == kill_at:
            self.wait()
            saved.update(state.state_dict())
            raise KeyboardInterrupt

    monkeypatch.setattr(CheckpointManager, "save", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "b", log("b1.jsonl"), *extra))
    monkeypatch.setattr(CheckpointManager, "save", real_save)
    if "mini_step" in saved:
        assert saved["mini_step"] == 1 and saved["count"] == 1
    train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "b", log("b2.jsonl"), *extra,
                     "--resume"))
    lrs, resumed = _lrs(tmp_path / "a.jsonl"), _lrs(tmp_path / "b2.jsonl")
    assert sorted(resumed) == list(range(kill_at + 1, 11))
    assert all(resumed[s] == lrs[s] for s in resumed)
    a = CheckpointManager(str(tmp_path / "a")).restore_last()
    b = CheckpointManager(str(tmp_path / "b")).restore_last()
    assert a["step"] == 10 and a["optimizer"] in ("madgrad", "adamw/accumulate_2")
    _same(a, b)


def test_checkpoint_names_its_optimizer_and_reads_the_untagged_adamw_form():
    """A state dict names its optimizer; one without the name (the
    AdamW-only form: params, mu, nu, count, step, dropout_seed) loads into
    an adam-family state, and a state of another optimizer is refused."""
    _, ttask = _tasks(False)
    adamw = ttask.init_state(0)
    ttask.train_step(adamw, ttask.to_device(_fake_batch(4, 2, seed=1)))
    untagged = {k: v for k, v in adamw.state_dict().items() if k != "optimizer"}
    assert set(untagged) == {"params", "mu", "nu", "count", "step", "dropout_seed"}
    fresh = ttask.init_state(1)
    fresh.load_state_dict(untagged)
    _same(fresh.state_dict(), adamw.state_dict())
    mad = DenseRetrieverTask(cfg=ttask.cfg, optimizer=make_optimizer("madgrad", 1e-3))
    with pytest.raises(ValueError, match="'adamw'.*'madgrad'"):
        mad.init_state(0).load_state_dict(untagged)
    with pytest.raises(ValueError, match="'madgrad'.*'adamw'"):
        fresh.load_state_dict(mad.init_state(0).state_dict())
