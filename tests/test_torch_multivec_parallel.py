"""The multi-vector task under data parallelism, on the CPU: two gloo ranks
against one process on the same global batch, and against the JAX task's
step on its 8-device mesh.

Two ranks (``torch_dp_worker.py``, started through ``parallel.launch``'s
environment) each train on their contiguous half of one global batch of 8
queries and 24 contexts: the gathered output dicts with the local half
spliced in, the global loss (its routing statistics, the router and expert
load losses and ``avg_marg_num_experts``, a max over the batch, taken over
the gathered planes) and the summed gradients must give the single-process
step on the whole batch, at ``test_torch_data_parallel.py``'s tolerances
(loss and grad_norm within rtol 1e-5, every metric too; parameters and
optimizer moments within 1e-6 abs + 1e-5 rel after two steps) for CITADEL
(teacher distillation and every regulariser, annealed at epoch 1 of 2),
COIL, ColBERT, CITADEL under GradCache (c = 2) and under ZeRO-1. CITADEL's
2-rank steps equal the JAX task's on the 8-device mesh at
``test_torch_multivec_task.py::test_three_steps_match_jax``'s tolerances.
At dropout 0.1 the step trains. ``cli.train trainer.num_devices=2
task.type=multivec --device cpu`` starts a second rank itself and equals one
process.
"""
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest

from dpr_scale_tpu.optim import make_optimizer as jax_make_optimizer
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu.train.multivec import MultiVecRetrieverTask as JaxTask
from dpr_scale_tpu.train.schedule import linear_warmup_decay as jax_schedule
from dpr_scale_tpu_torch.models.convert import from_jax_params

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_dp_worker as worker  # noqa: E402
from test_torch_data_parallel import _assert_states_close, _launch, _run_group  # noqa: E402
from test_torch_multivec_task import (  # noqa: E402
    CITADEL,
    assert_metrics_close,
    assert_params_close,
    configs,
    mv_batch,
)

EPOCH = 1.0  # the annealed regularisers at half their weight
CASES = [
    {"name": "citadel", "steps": 2, "task": "multivec", "epoch": EPOCH, "multivec": CITADEL},
    {"name": "coil", "steps": 2, "task": "multivec",
     "multivec": dict(variant="coil", tok_projection_dim=8)},
    {"name": "colbert", "steps": 2, "task": "multivec",
     "multivec": dict(variant="colbert", tok_projection_dim=8, add_cls=True)},
    {"name": "citadel_grad_cache", "steps": 2, "task": "multivec", "epoch": EPOCH, "chunks": 2,
     "multivec": CITADEL},
    {"name": "citadel_zero1", "steps": 2, "task": "multivec", "epoch": EPOCH, "zero1": True,
     "multivec": CITADEL},
    {"name": "citadel_dropout", "steps": 1, "task": "multivec", "epoch": EPOCH, "dropout": True,
     "multivec": CITADEL},
]
for case in CASES:
    case["state_key"] = "citadel" if case["multivec"]["variant"] == "citadel" else case["name"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX mesh(8) CITADEL steps, the 2-rank run and the 1-process runs."""
    jcfg, tcfg = configs()
    batch = mv_batch(8, 3, seed=7)
    sched = dict(base_lr=1e-3, warmup_steps=1, total_steps=10)
    jtask = JaxTask(cfg=jcfg, mesh=get_mesh(8), optimizer=jax_make_optimizer(
        "adamw", jax_schedule(**sched), weight_decay=0.01, grad_clip_norm=0.5), **CITADEL)
    jstate = jtask.init_state(jax.random.PRNGKey(3), batch)
    spec = {"cfg": tcfg, "cfg_dropout": dataclasses.replace(
                tcfg, hidden_dropout=0.1, attention_dropout=0.1),
            "batch": batch, "cases": CASES,
            "citadel": from_jax_params(jax.device_get(jstate.params)),
            "coil": None, "colbert": None}  # COIL and ColBERT: the port's seeded init
    step, metrics = jtask.make_train_step(), []
    for _ in range(2):
        jstate, m = step(jstate, jtask.shard(batch), EPOCH)
        metrics.append(jax.device_get(m))
    jax_steps = (metrics, jstate.params)
    two = _launch(spec, tmp_path_factory.mktemp("mv_dp"))
    single = {c["name"]: worker.run_case(spec, c) for c in CASES}
    return {"two": two, "single": single, "jax": jax_steps}


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c["name"] != "citadel_dropout"])
def test_two_ranks_equal_one_process(runs, name):
    """Loss, grad_norm, every metric (the routing statistics included),
    parameters and the whole optimizer state of the 2-rank run equal one
    process training on the global batch."""
    two, one = runs["two"][name], runs["single"][name]
    assert runs["two"]["world"] == 2
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(two["grad_norm"], one["grad_norm"], rtol=1e-5)
    for got, want in zip(two["metrics"], one["metrics"]):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-7, err_msg=key)
    _assert_states_close(two["state"], one["state"])
    if name.startswith("citadel"):
        first = one["metrics"][0]
        assert first["query_router_marg_load_loss"] > 0 and first["context_expert_load_loss"] > 0
        assert first["avg_context_marg_num_experts"] > first["avg_context_cond_num_experts"]


def test_two_ranks_equal_the_jax_mesh_step(runs):
    """CITADEL's 2-rank steps against the JAX task on its 8-device mesh:
    each step's metrics within 1e-5 relative (grad_norm 1e-4), the
    parameters after two steps within 2e-5."""
    jax_metrics, jax_params = runs["jax"]
    two = runs["two"]["citadel"]
    for got, want in zip(two["metrics"], jax_metrics):
        assert_metrics_close(got, want)

    class Model:
        def state_dict(self):
            return two["state"]["params"]

    assert_params_close(jax_params, Model())


def test_ranks_train_with_dropout(runs):
    """At rate 0.1 each rank folds its rank into the step's randomness (the
    masks differ: ``test_torch_data_parallel.py``); the step trains to a
    finite loss that is not the rate-0 loss."""
    drop = runs["two"]["citadel_dropout"]["loss"][0]
    assert np.isfinite(drop) and drop != runs["two"]["citadel"]["loss"][0]


def test_cli_train_multivec_on_two_ranks_equals_one(tiny_bert_dir, dpr10_jsonl, tmp_path):
    """``cli.train task.type=multivec trainer.num_devices=2 --device cpu``
    starts a second rank itself: the same per-step losses and test metrics
    as one process, and rank 0's export."""
    from dpr_scale_tpu_torch.cli import train

    def argv(name, *extra):
        return ["--config", os.path.join(ROOT, "conf", "tiny_smoke.yaml"), "--device", "cpu",
                "--metrics-out", str(tmp_path / name / "metrics.json"),
                f"task.transform.model_path={tiny_bert_dir}", f"datamodule.train_path={dpr10_jsonl}",
                f"datamodule.val_path={dpr10_jsonl}", f"datamodule.test_path={dpr10_jsonl}",
                "task.model.dtype=float32", "task.model.vocab_size=32",
                "task.transform.max_seq_len=12", "task.type=multivec", "task.variant=citadel",
                "task.tok_projection_dim=8", "task.cls_projection_dim=8", "task.add_cls=true",
                "task.query_topk=1", "task.context_topk=2",
                "task.query_router_marg_load_loss_coef=0.01",
                "task.context_expert_load_loss_coef=0.01", "trainer.log_every=1",
                f"trainer.metrics_jsonl={tmp_path / name / 'log.jsonl'}",
                f"checkpoint_callback.dirpath={tmp_path / name / 'ckpt'}", *extra]

    one = train.main(argv("one"))
    _run_group([([sys.executable, "-m", "dpr_scale_tpu_torch.cli.train",
                  *argv("two", "trainer.num_devices=2", "trainer.strategy=ddp_sharded")],
                 dict(os.environ, PYTHONPATH=ROOT))])
    with open(tmp_path / "two" / "metrics.json") as f:
        two = json.load(f)
    assert set(two) == set(one) and one["query_count"] > 0
    for key in one:
        np.testing.assert_allclose(two[key], one[key], rtol=1e-5, err_msg=key)

    def losses(name):
        with open(tmp_path / name / "log.jsonl") as f:
            return [r["train_loss"] for r in map(json.loads, f) if "train_loss" in r]

    assert len(losses("one")) > 1
    np.testing.assert_allclose(losses("two"), losses("one"), rtol=1e-5)
    assert os.path.exists(tmp_path / "two" / "ckpt" / "params_best" / "params.pt")
