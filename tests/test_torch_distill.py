"""The port's distillation slice (``data.distill``, ``DistillDataModule``,
``train.distill.DPRDistillTask``, ``cli.train --config conf/distill.yaml``)
against the JAX package's, on the CPU.

Inputs come from numpy seeds; the weights cross from Flax through
``from_jax_params``. A 2-layer encoder at hidden 64, fp32, dropout 0 (the
dropout realisations differ between the packages by design). Tolerances:
batches byte for byte; the loss, grad norm and eval metrics within 1e-5
relative, the parameters after two AdamW steps within 1e-6 abs / 1e-5 rel.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.data.datamodule import DistillDataModule as JaxDistillDataModule
from dpr_scale_tpu.data.tokenize import HFTokenizer as JaxTokenizer
from dpr_scale_tpu.models import TransformerConfig as JaxConfig
from dpr_scale_tpu.optim import make_optimizer as jax_make_optimizer
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu.train.distill import DPRDistillTask as JaxDistillTask
from dpr_scale_tpu.train.schedule import linear_warmup_decay as jax_schedule
from dpr_scale_tpu_torch.data.datamodule import DistillDataModule
from dpr_scale_tpu_torch.data.tokenize import HFTokenizer
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.models.transformer import TransformerConfig
from dpr_scale_tpu_torch.optim.factory import make_optimizer
from dpr_scale_tpu_torch.train.distill import DPRDistillTask
from dpr_scale_tpu_torch.train.schedule import linear_warmup_decay

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
H = 64
WORDS = list("abcdefghij") + ["who", "what", "book", "city"]


@pytest.fixture(scope="module")
def distill_jsonl(tmp_path_factory):
    """14 rows with 1-3 teacher context vectors and a teacher query vector."""
    path = tmp_path_factory.mktemp("distill") / "distill.jsonl"
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        for i in range(14):
            f.write(json.dumps({
                "question": " ".join(rng.choice(WORDS, size=4)),
                "ctx_target_vectors": rng.normal(size=(1 + i % 3, H)).round(4).tolist(),
                "qry_target_vector": rng.normal(size=H).round(4).tolist(),
            }) + "\n")
    return str(path)


def _modules(tiny_bert_dir, path, batch_size=4):
    kw = dict(train_path=path, val_path=path, batch_size=batch_size, seed=3,
              prefetch_batches=0)
    return (JaxDistillDataModule(JaxTokenizer(tiny_bert_dir, max_seq_len=12), **kw),
            DistillDataModule(HFTokenizer(tiny_bert_dir, max_seq_len=12), **kw))


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"query_ids", "query_mask", "target_vectors"}
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].tobytes() == w[key].tobytes(), key


def test_distill_batches_equal_jax_including_the_resume_skip(tiny_bert_dir, distill_jsonl):
    jdm, dm = _modules(tiny_bert_dir, distill_jsonl)
    assert dm.steps_per_epoch() == jdm.steps_per_epoch() == 3
    for epoch in (0, 1):
        want = list(jdm.train_batches(epoch))
        _same_batches(list(dm.train_batches(epoch)), want)
        # the resume skip: batch 1.. of the epoch, byte for byte the unbroken stream's
        _same_batches(list(dm.train_batches(epoch, start_batch=1)), want[1:])
        _same_batches(list(dm.train_batches(epoch, start_batch=1)),
                      list(jdm.train_batches(epoch, start_batch=1)))
    _same_batches(list(dm.val_batches()), list(jdm.val_batches()))
    _same_batches([dm.example_batch()], [jdm.example_batch()])
    # two rows a question: the sampled positive's vector, then the query's
    assert dm.example_batch()["target_vectors"].shape == (8, H)


def _tasks(lr=1e-3):
    jcfg = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32, hidden_size=H, num_heads=4,
                               intermediate_size=128, num_layers=2)
    fields = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype"}
    tcfg = TransformerConfig(dtype=torch.float32,
                             **{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    sched = dict(base_lr=lr, warmup_steps=1, total_steps=10)
    jtask = JaxDistillTask(cfg=jcfg, mesh=get_mesh(1), optimizer=jax_make_optimizer(
        "adamw", jax_schedule(**sched), weight_decay=0.01, grad_clip_norm=1.0))
    ttask = DPRDistillTask(cfg=tcfg, optimizer=make_optimizer(
        "adamw", linear_warmup_decay(**sched), weight_decay=0.01, grad_clip_norm=1.0))
    return jtask, ttask


def test_two_distill_steps_and_eval_equal_jax(tiny_bert_dir, distill_jsonl):
    jdm, _dm = _modules(tiny_bert_dir, distill_jsonl)
    jtask, ttask = _tasks()
    batches = list(jdm.train_batches(0))[:2]
    jstate = jtask.init_state(jax.random.PRNGKey(0), batches[0])
    tstate = ttask.init_state(state_dict=from_jax_params(jax.device_get(jstate.params)))
    step = jtask.make_train_step()
    for batch in batches:
        jstate, jm = step(jstate, jtask.shard(batch))
        tstate, tm = ttask.train_step(tstate, ttask.to_device(batch))
        for key in ("train_loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    ref = from_jax_params(jax.device_get(jstate.params))
    got = tstate.model.state_dict()
    assert set(ref) == set(got) and tstate.step == 2
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=name)
    want = jtask.run_eval(jstate, jdm.val_batches())
    metrics = ttask.run_eval(tstate, _modules(tiny_bert_dir, distill_jsonl)[1].val_batches())
    assert set(metrics) == set(want) and metrics["query_count"] == want["query_count"] == 28
    for key in want:
        assert metrics[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7), key


def test_cli_train_distill_conf_runs_on_cpu(tiny_bert_dir, distill_jsonl, tmp_path, capsys):
    """``cli.train --config conf/distill.yaml`` at a tiny width: it trains,
    validates, saves, tests and exports the student's weights."""
    from dpr_scale_tpu_torch.cli import train
    from dpr_scale_tpu_torch.train.checkpoint import load_params

    ckpt = tmp_path / "ckpt"
    metrics = train.main([
        "--config", os.path.join(CONF, "distill.yaml"), "--device", "cpu",
        f"task.transform.model_path={tiny_bert_dir}", "task.transform.max_seq_len=12",
        "task.model.arch=tiny", "task.model.vocab_size=32", f"task.model.hidden_size={H}",
        "task.model.num_heads=4", "task.model.intermediate_size=128", "task.model.dtype=float32",
        f"datamodule.train_path={distill_jsonl}", f"datamodule.val_path={distill_jsonl}",
        f"datamodule.test_path={distill_jsonl}", "datamodule.batch_size=4",
        "trainer.max_epochs=1", "trainer.log_every=1", f"checkpoint_callback.dirpath={ckpt}",
    ])
    out = capsys.readouterr().out
    assert "valid_mrr" in out and "test metrics:" in out
    assert metrics["query_count"] == 28 and 0.0 < metrics["mrr"] <= 1.0
    assert np.isfinite(metrics["loss"])
    params = load_params(str(ckpt / "params_best"))
    assert "transformer.word_embeddings.weight" in params  # the student DenseEncoder's names
