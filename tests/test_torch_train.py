"""The port's training slice (dpr_scale_tpu_torch.train / optim / cli.train)
against the JAX package's, on the CPU.

Every input is made from a seed with numpy and handed to both sides; model
weights cross from Flax to the port through ``from_jax_params``. The JAX
task runs on a one-device mesh; its fused attention runs the Pallas kernels
in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpr_scale_tpu.models import TransformerConfig as JaxConfig
from dpr_scale_tpu.optim import make_optimizer as jax_make_optimizer
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu.train import DenseRetrieverTask as JaxTask
from dpr_scale_tpu.train import loss as jax_loss
from dpr_scale_tpu.train.schedule import linear_warmup_decay as jax_schedule
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.models.transformer import DropoutRng, TransformerConfig
from dpr_scale_tpu_torch.optim.factory import make_optimizer
from dpr_scale_tpu_torch.train import loss as port_loss
from dpr_scale_tpu_torch.train.schedule import linear_warmup_decay
from dpr_scale_tpu_torch.train.task import DenseRetrieverTask


def _fake_batch(B, C, L=8, vocab=32, seed=0):
    """A dense batch as the datamodule lays it out: contexts question-major,
    ragged masks, some dummy contexts."""
    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(5, vocab, size=(n, L)).astype(np.int32)
    mask = lambda n: (np.arange(L)[None, :] < rng.integers(2, L + 1, size=(n, 1))).astype(np.int32)
    ctx_mask = np.zeros((B * C,), bool)
    ctx_mask[np.arange(B) * C + (C - 1)] = rng.random(B) < 0.3
    return {
        "query_ids": ids(B), "query_mask": mask(B),
        "contexts_ids": ids(B * C), "contexts_mask": mask(B * C),
        "pos_ctx_indices": (np.arange(B) * C).astype(np.int32),
        "scores": np.zeros((B, C), np.float32),
        "ctx_mask": ctx_mask,
    }


def _tasks(fused_attention, lr=1e-3, clip=0.5, weight_decay=0.01, bf16=False,
           fused_ffn=False, **task_kw):
    """The JAX task and the port's, dropout 0, fp32 activations unless
    ``bf16``, the same optimizer."""
    jcfg = dataclasses.replace(
        JaxConfig.tiny(), dtype=jnp.bfloat16 if bf16 else jnp.float32,
        fused_attention=fused_attention, num_heads=2, hidden_size=16, intermediate_size=32,
        fused_ffn=fused_ffn,
    )
    fields = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype"}
    tcfg = TransformerConfig(
        dtype=torch.bfloat16 if bf16 else torch.float32,
        **{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields},
    )
    sched = dict(base_lr=lr, warmup_steps=1, total_steps=10)
    jtask = JaxTask(
        cfg=jcfg, mesh=get_mesh(1),
        optimizer=jax_make_optimizer("adamw", jax_schedule(**sched), weight_decay=weight_decay,
                                     grad_clip_norm=clip),
        **task_kw,
    )
    ttask = DenseRetrieverTask(
        cfg=tcfg,
        optimizer=make_optimizer("adamw", linear_warmup_decay(**sched),
                                 weight_decay=weight_decay, grad_clip_norm=clip),
        **task_kw,
    )
    return jtask, ttask


def _assert_params_close(jparams, model, atol, rtol):
    ref = from_jax_params(jax.device_get(jparams))
    got = model.state_dict()
    assert set(ref) == set(got)
    for name in ref:
        np.testing.assert_allclose(
            got[name].numpy(), ref[name].numpy(), atol=atol, rtol=rtol, err_msg=name
        )


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("in_batch_negatives", [True, False])
@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_contrastive_loss_matches_jax(in_batch_negatives, temperature):
    """Dummy contexts, both negatives modes: fp32 scores, loss within 1e-6."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    c = rng.normal(size=(15, 8)).astype(np.float32)
    pos = (np.arange(5) * 3).astype(np.int32)
    mask = np.zeros(15, bool)
    mask[[2, 8, 14]] = True
    jl, js = jax_loss.contrastive_loss(q, c, pos, mask, temperature, in_batch_negatives)
    tl, ts = port_loss.contrastive_loss(
        *(torch.from_numpy(a) for a in (q, c, pos, mask)), temperature, in_batch_negatives
    )
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def test_rank_metrics_match_jax_with_ties():
    """Exact ties resolve by position (stable sort), as in the JAX metrics."""
    scores = np.array(
        [[5.0, 9.0, 5.0, 5.0], [1.0, 1.0, 1.0, 1.0], [0.5, 0.1, 0.9, 0.2]], np.float32
    )
    pos = np.array([2, 3, 0], np.int32)
    for k in (1, 2):
        ref = jax_loss.rank_metrics(jnp.asarray(scores), jnp.asarray(pos), k)
        got = port_loss.rank_metrics(torch.from_numpy(scores), torch.from_numpy(pos), k)
        assert set(ref) == set(got)
        for key in ref:
            assert float(got[key]) == pytest.approx(float(ref[key]), rel=1e-7), key


def test_schedule_matches_jax():
    for warmup, total in ((0, 10), (5, 40), (1237, 2000)):
        ref, got = jax_schedule(2e-5, warmup, total), linear_warmup_decay(2e-5, warmup, total)
        for step in list(range(0, total + 3, max(1, total // 37))) + [warmup]:
            assert got(step) == pytest.approx(float(ref(step)), rel=1e-7, abs=1e-15), step


# ------------------------------------------------------------------ optimizer


@pytest.mark.parametrize("clip", [None, 1.0, 100.0])
@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_optimizer_two_steps_match_optax(name, clip):
    """Clipped (global norm ~3 > 1.0) and unclipped steps: parameters after
    each of two updates within 1e-7 abs / 1e-6 rel of optax's."""
    rng = np.random.default_rng(0)
    shapes = [(4, 6), (6,), (3, 3, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(2)]
    sched = linear_warmup_decay(1e-2, 1, 5)
    tx = jax_make_optimizer(name, jax_schedule(1e-2, 1, 5), weight_decay=0.1, grad_clip_norm=clip)
    port = make_optimizer(name, sched, weight_decay=0.1, grad_clip_norm=clip)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = port.init(tp)
    for g in grads:
        updates, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        port.update(tp, [torch.from_numpy(x.copy()) for x in g], ts)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)
    assert ts["count"] == 2


# ------------------------------------------------------------------ the step


@pytest.mark.parametrize(
    "fused_attention,fused_ffn", [(True, False), (False, False), (True, True)],
    ids=["True", "False", "True-fused_ffn"],
)
def test_two_train_steps_match_jax_task(fused_attention, fused_ffn):
    """Same params (via from_jax_params), same batch, dropout 0, fp32: after
    each of two steps the loss and the pre-clip grad_norm agree within 1e-5
    relative, and after both every parameter agrees within 2e-6 abs + 1e-4
    rel (fp32 summation-order noise through two layers, amplified where
    Adam divides a small gradient by its own magnitude). With ``fused_ffn``
    both train steps run the fused FFN between two LayerNorms (the JAX
    kernel in interpret mode, the port's plain version)."""
    batch = _fake_batch(6, 3, seed=1)
    jtask, ttask = _tasks(fused_attention, fused_ffn=fused_ffn)
    jstate = jtask.init_state(jax.random.PRNGKey(0), batch)
    tstate = ttask.init_state(state_dict=from_jax_params(jax.device_get(jstate.params)))
    jstep = jtask.make_train_step()
    clipped = False
    for _ in range(2):
        jstate, jm = jstep(jstate, jtask.shard(batch))
        tstate, tm = ttask.train_step(tstate, ttask.to_device(batch))
        np.testing.assert_allclose(float(tm["train_loss"]), float(jm["train_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        clipped |= float(jm["grad_norm"]) > 0.5
    assert clipped and tstate.step == 2
    _assert_params_close(jstate.params, tstate.model, atol=2e-6, rtol=1e-4)


@pytest.mark.parametrize("in_batch_eval", [True, False])
def test_run_eval_matches_jax(in_batch_eval):
    jtask, ttask = _tasks(True, in_batch_eval=in_batch_eval)
    batches = [_fake_batch(4, 2, seed=s) for s in range(3)]
    jstate = jtask.init_state(jax.random.PRNGKey(1), batches[0])
    tstate = ttask.init_state(state_dict=from_jax_params(jax.device_get(jstate.params)))
    ref = jtask.run_eval(jstate, batches)
    got = ttask.run_eval(tstate, batches)
    assert set(got) == set(ref) and ref["query_count"] == 12
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-5), key


def test_bf16_model_keeps_fp32_master_weights_that_move():
    """bf16 activations, lr 2e-5: one AdamW step moves the weights by ~lr
    (Adam's first update is ~lr * sign(g)), as optax's fp32 update does. A
    weight of ~0.02 stored in bf16 has a half-ulp of ~6e-5, so bf16 storage
    would leave almost every entry where it was."""
    jtask, ttask = _tasks(True, lr=2e-5, clip=2.0, weight_decay=0.0, bf16=True)
    batch = _fake_batch(6, 3, seed=2)
    jstate = jtask.init_state(jax.random.PRNGKey(0), batch)
    before = from_jax_params(jax.device_get(jstate.params))
    tstate = ttask.init_state(state_dict=before)
    assert all(p.dtype == torch.float32 for p in tstate.model.parameters())
    for _ in range(2):  # the schedule's first LR is 0 (warmup)
        jstate, _ = jtask.make_train_step()(jstate, jtask.shard(batch))
        tstate, _ = ttask.train_step(tstate, ttask.to_device(batch))
    after_jax = from_jax_params(jax.device_get(jstate.params))
    name = "context_encoder.transformer.layers.0.intermediate.weight"
    moved = (tstate.model.state_dict()[name] - before[name]).numpy()
    ref = (after_jax[name] - before[name]).numpy()
    lr = linear_warmup_decay(2e-5, 1, 10)(1)
    assert 0.5 * lr < np.median(np.abs(moved)) < 1.5 * lr
    agree = np.mean(np.abs(moved - ref) <= 0.1 * lr)
    assert agree > 0.9, agree


def test_train_step_learns():
    _, ttask = _tasks(False, lr=1e-3, clip=2.0)
    batch = ttask.to_device(_fake_batch(8, 2, seed=0))
    state = ttask.init_state(seed=0)
    losses = []
    for _ in range(30):
        state, m = ttask.train_step(state, batch)
        losses.append(float(m["train_loss"]))
    assert losses[-1] < losses[0] * 0.7
    assert state.step == 30


@pytest.mark.parametrize("fused_attention", [True, False])
def test_dropout_is_a_function_of_seed_and_step(fused_attention):
    """Training forwards with dropout: the same (seed, step) repeats, another
    step differs, and no rng means deterministic."""
    from dpr_scale_tpu_torch.models.encoder import DenseEncoder
    from dpr_scale_tpu_torch.models.convert import init_params

    cfg = dataclasses.replace(
        TransformerConfig.tiny(), dtype=torch.float32, hidden_dropout=0.2,
        attention_dropout=0.2, fused_attention=fused_attention,
    )
    model = DenseEncoder(cfg)
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    b = _fake_batch(4, 1, seed=5)
    ids, mask = torch.from_numpy(b["query_ids"]), torch.from_numpy(b["query_mask"])
    run = lambda rng: model(ids, mask, rng).detach()
    a, again = run(DropoutRng(1, 3, "cpu")), run(DropoutRng(1, 3, "cpu"))
    assert torch.equal(a, again)
    assert not torch.allclose(a, run(DropoutRng(1, 4, "cpu")))
    assert not torch.allclose(a, run(None))
    assert torch.equal(run(None), run(None))


def test_unported_task_options_raise():
    """Only the distillation task stays refused (A8); the splade family,
    GradCache and remat train: a step of each gives a finite loss and moves
    the parameters."""
    from dpr_scale_tpu_torch.cli.common import build_task
    from dpr_scale_tpu_torch.config import load_config

    _, ttask = _tasks(True)
    with pytest.raises(NotImplementedError, match="distill.*A8"):
        build_task(load_config("conf/nq.yaml", ["task.type=distill"]), make_optimizer(), "cpu")
    batch = _fake_batch(4, 2, seed=3)
    for task in (DenseRetrieverTask(cfg=ttask.cfg, encoder_family="splade"),
                 DenseRetrieverTask(cfg=ttask.cfg, grad_cache_chunks=2),
                 DenseRetrieverTask(cfg=dataclasses.replace(ttask.cfg, remat=True))):
        state = task.init_state(0)
        before = [p.detach().clone() for p in state.model.parameters()]
        state, m = task.train_step(state, task.to_device(batch))
        assert np.isfinite(float(m["train_loss"])) and state.step == 1
        assert any(not torch.equal(a, p) for a, p in zip(before, state.model.parameters()))


# ------------------------------------------------------------------ config + CLI


def _cli_overrides(tiny_bert_dir, dpr10_jsonl):
    return [
        f"task.transform.model_path={tiny_bert_dir}",
        f"datamodule.train_path={dpr10_jsonl}",
        f"datamodule.val_path={dpr10_jsonl}",
        f"datamodule.test_path={dpr10_jsonl}",
    ]


def test_model_config_reads_dropout_and_remat():
    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.cli.common import build_model_config, build_task

    cfg = load_config(
        "conf/nq.yaml", ["task.model.hidden_dropout=0.2", "task.model.attention_dropout=0.3"]
    )
    mc = build_model_config(cfg)
    assert (mc.hidden_dropout, mc.attention_dropout, mc.remat) == (0.2, 0.3, False)
    task = build_task(cfg, make_optimizer(), "cpu")
    assert task.cfg.hidden_dropout == 0.2
    remat = load_config("conf/nq.yaml", ["task.model.remat=true"])
    assert build_model_config(remat).remat is True
    task = build_task(remat, make_optimizer(), "cpu")
    assert task.cfg.remat is True  # a task that trains with remat, no refusal


def test_cli_train_runs_on_cpu(tiny_bert_dir, dpr10_jsonl, tmp_path, capsys):
    from dpr_scale_tpu_torch.cli import train

    out = tmp_path / "m.json"
    metrics = train.main(
        ["--config", "conf/tiny_smoke.yaml", "--device", "cpu", "--metrics-out", str(out),
         *_cli_overrides(tiny_bert_dir, dpr10_jsonl)]
    )
    text = capsys.readouterr().out
    assert "test metrics:" in text and "valid_mrr" in text
    assert metrics["query_count"] == 10 and 0.0 < metrics["mrr"] <= 1.0
    assert out.exists()


def test_cli_train_runs_fused_ffn_on_cpu(tiny_bert_dir, dpr10_jsonl, capsys, monkeypatch):
    """``task.model.fused_ffn=true`` reaches the model through the CLI: the
    train steps run ``fused_ffn`` and validation and test ``fused_ffn_ln``
    (their plain versions on the CPU)."""
    from dpr_scale_tpu_torch.cli import train
    from dpr_scale_tpu_torch.ops import ffn

    calls = {ffn.FusedFFN: 0, ffn.FusedFFNLN: 0}
    for fn in calls:
        def counted(*args, fn=fn, apply=fn.apply):
            calls[fn] += 1
            return apply(*args)

        monkeypatch.setattr(fn, "apply", counted)
    metrics = train.main(["--config", "conf/tiny_smoke.yaml", "--device", "cpu",
                          "task.model.fused_ffn=true",
                          *_cli_overrides(tiny_bert_dir, dpr10_jsonl)])
    assert "valid_mrr" in capsys.readouterr().out
    assert metrics["query_count"] == 10 and 0.0 < metrics["mrr"] <= 1.0
    assert min(calls.values()) > 0, calls


@pytest.mark.parametrize("extra", [["datamodule.num_workers=2"]])
def test_cli_train_refuses_what_is_not_ported(tiny_bert_dir, dpr10_jsonl, extra):
    from dpr_scale_tpu_torch.cli import train

    with pytest.raises(NotImplementedError, match="A8"):
        train.main(["--config", "conf/tiny_smoke.yaml", "--device", "cpu", *extra,
                    *_cli_overrides(tiny_bert_dir, dpr10_jsonl)])


@pytest.mark.parametrize("extra", [
    ["task.grad_cache_chunks=2"],
    ["task.model.remat=true"],
    ["task.optim.name=lamb"],
    ["task.optim.name=madgrad"],
    ["trainer.accumulate_grad_batches=2"],
    ["trainer.profile_dir={tmp}/prof"],
], ids=["grad_cache", "remat", "lamb", "madgrad", "accumulate", "profile_dir"])
def test_cli_train_runs_each_training_option(tiny_bert_dir, dpr10_jsonl, tmp_path, extra):
    """Each option the port once refused trains through ``cli.train`` on
    the CPU: every logged loss and gradient norm finite, test metrics
    finite, and ``profile_dir`` holds the trace."""
    import json

    from dpr_scale_tpu_torch.cli import train

    log = tmp_path / "m.jsonl"
    metrics = train.main(["--config", "conf/tiny_smoke.yaml", "--device", "cpu",
                          "trainer.log_every=1", f"trainer.metrics_jsonl={log}",
                          *[e.format(tmp=tmp_path) for e in extra],
                          *_cli_overrides(tiny_bert_dir, dpr10_jsonl)])
    steps = [json.loads(l) for l in log.read_text().splitlines()]
    steps = [l for l in steps if "train_loss" in l]
    assert steps and np.isfinite([l[k] for l in steps for k in ("train_loss", "grad_norm")]).all()
    assert metrics["query_count"] == 10 and np.isfinite(list(metrics.values())).all()
    if "profile_dir" in extra[0]:
        assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
