"""Data-parallel training of the port (``dpr_scale_tpu_torch.parallel``)
against one process and against the JAX sharded step, on the CPU.

Two gloo ranks (``torch_dp_worker.py``, started through
``parallel.launch``'s environment) each train on their contiguous half of
one global batch: the gathered embeddings with the local half spliced in,
the global loss and the summed gradients must give the single-process step
on the whole batch (loss and grad_norm within rtol 1e-5, parameters and
optimizer moments within 1e-6 abs + 1e-5 rel after two steps: fp32 sums in
another order) for the dense task, under GradCache, under ZeRO-1 (AdamW,
Lamb, and AdamW under MultiSteps, whose clip takes its norm across ranks)
and for the distill task; the dense and ZeRO-1 steps also equal the JAX
task's on the 8-device mesh (the tolerances of
tests/test_torch_train.py's JAX parity). At dropout 0.1 the ranks draw
different masks. A ZeRO-1 checkpoint loads at world size 1, and a world
size 1 checkpoint under ZeRO-1. The machine has one GPU at most, so the
2-rank parity is a CPU test; the card runs world size 1 over NCCL
(chip_smoke.py phase 22).
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.models import TransformerConfig as JaxConfig
from dpr_scale_tpu.optim import make_optimizer as jax_make_optimizer
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu.train import DenseRetrieverTask as JaxTask
from dpr_scale_tpu.train.schedule import linear_warmup_decay as jax_schedule
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.models.transformer import TransformerConfig
from dpr_scale_tpu_torch.parallel import launch, mesh

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_dp_worker as worker  # noqa: E402

CASES = [
    {"name": "dense", "steps": 2},
    {"name": "grad_cache", "steps": 2, "chunks": 2},
    {"name": "zero1", "steps": 2, "zero1": True},
    {"name": "zero1_lamb", "steps": 2, "zero1": True, "optim": "lamb"},
    {"name": "zero1_accumulate", "steps": 4, "zero1": True, "accumulate": 2},
    {"name": "distill", "steps": 2, "task": "distill"},
    {"name": "dropout", "steps": 1, "dropout": True},
    {"name": "zero1_resume", "steps": 1, "zero1": True},
]


def _fake_batch(B, C, L=8, vocab=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(5, vocab, size=(n, L)).astype(np.int32)
    mask = lambda n: (np.arange(L)[None, :] < rng.integers(2, L + 1, size=(n, 1))).astype(np.int32)
    ctx_mask = np.zeros((B * C,), bool)
    ctx_mask[np.arange(B) * C + (C - 1)] = rng.random(B) < 0.3
    return {
        "query_ids": ids(B), "query_mask": mask(B),
        "contexts_ids": ids(B * C), "contexts_mask": mask(B * C),
        "pos_ctx_indices": (np.arange(B) * C).astype(np.int32),
        "scores": np.zeros((B, C), np.float32), "ctx_mask": ctx_mask,
    }


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(cmds, timeout=240):
    """Run each (argv, env) as a process of its own session; on a timeout
    kill the sessions (children of a rank included) and fail."""
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, start_new_session=True) for argv, env in cmds]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return logs


def _launch(spec, tmp_path, world=2):
    spec_path, out_path = tmp_path / "spec.pt", tmp_path / "out.pt"
    torch.save(spec, spec_path)
    port = _free_port()
    _run_group([([sys.executable, os.path.join(HERE, "torch_dp_worker.py"), str(spec_path),
                  str(out_path)],
                 dict(os.environ, DPR_COORDINATOR=f"127.0.0.1:{port}",
                      DPR_NUM_PROCESSES=str(world), DPR_PROCESS_ID=str(r), PYTHONPATH=ROOT))
                for r in range(world)])
    return torch.load(out_path, weights_only=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX sharded steps, the 2-rank run and the 1-process runs."""
    jcfg = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32, num_heads=2,
                               hidden_size=16, intermediate_size=32)
    fields = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype"}
    tcfg = TransformerConfig(dtype=torch.float32,
                             **{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    batch = _fake_batch(8, 3, seed=1)
    rng = np.random.default_rng(2)
    distill_batch = {"query_ids": batch["query_ids"], "query_mask": batch["query_mask"],
                     "target_vectors": rng.normal(size=(8, 16)).astype(np.float32)}

    def jax_run(**kw):
        task = JaxTask(cfg=jcfg, mesh=get_mesh(8), optimizer=jax_make_optimizer(
            "adamw", jax_schedule(base_lr=1e-3, warmup_steps=1, total_steps=10),
            weight_decay=0.01, grad_clip_norm=0.5), **kw)
        state = task.init_state(jax.random.PRNGKey(0), batch)
        init = from_jax_params(jax.device_get(state.params))
        step, out = task.make_train_step(), []
        for _ in range(2):
            state, m = step(state, task.shard(batch))
            out.append((float(m["train_loss"]), float(m["grad_norm"])))
        return init, out, from_jax_params(jax.device_get(state.params))

    init, jax_dense, jax_dense_params = jax_run()
    _, jax_zero1, jax_zero1_params = jax_run(zero1=True)
    _, jax_gc, jax_gc_params = jax_run(grad_cache_chunks=2)
    spec = {"cfg": tcfg, "cfg_dropout": dataclasses.replace(
                tcfg, hidden_dropout=0.1, attention_dropout=0.1),
            "state_dict": init, "distill_state_dict": None, "batch": batch,
            "distill_batch": distill_batch, "cases": CASES}
    # one step alone, without ZeRO-1: the checkpoint the 2-rank ZeRO-1 run resumes
    one = worker.run_case(spec, {"name": "one", "steps": 1})
    spec["loads"] = {"zero1_resume": one["state"]}
    two = _launch(spec, tmp_path_factory.mktemp("dp"))
    single = {c["name"]: worker.run_case(spec, c, spec["loads"].get(c["name"])) for c in CASES}
    return {"two": two, "single": single, "spec": spec, "one": one,
            "jax": {"dense": (jax_dense, jax_dense_params), "zero1": (jax_zero1, jax_zero1_params),
                    "grad_cache": (jax_gc, jax_gc_params)}}


def _assert_states_close(got, want, atol=1e-6, rtol=1e-5):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, dict):
            assert set(got[key]) == set(value), key
            for name in value:
                np.testing.assert_allclose(got[key][name].numpy(), value[name].numpy(),
                                           atol=atol, rtol=rtol, err_msg=f"{key}/{name}")
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c["name"] != "dropout"])
def test_two_ranks_equal_one_process(runs, name):
    """Loss, grad_norm, parameters and the whole optimizer state (a ZeRO-1
    state gathered from both ranks) of the 2-rank run equal one process
    training on the global batch."""
    two, one = runs["two"][name], runs["single"][name]
    assert runs["two"]["world"] == 2
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(two["grad_norm"], one["grad_norm"], rtol=1e-5)
    _assert_states_close(two["state"], one["state"])


@pytest.mark.parametrize("name", ["dense", "zero1", "grad_cache"])
def test_two_ranks_equal_the_jax_sharded_step(runs, name):
    """The 2-rank port step against the JAX task on its 8-device mesh
    (``zero1=True`` / ``grad_cache_chunks=2`` for those cases): loss and
    grad_norm within rtol 1e-5, parameters within 2e-6 abs + 1e-4 rel
    (tests/test_torch_train.py's JAX tolerances)."""
    (jax_steps, jax_params) = runs["jax"][name]
    two = runs["two"][name]
    np.testing.assert_allclose(two["loss"], [s[0] for s in jax_steps], rtol=1e-5)
    np.testing.assert_allclose(two["grad_norm"], [s[1] for s in jax_steps], rtol=1e-5)
    assert max(s[1] for s in jax_steps) > 0.5  # the clip acted
    for key, want in jax_params.items():
        np.testing.assert_allclose(two["state"]["params"][key].numpy(), want.numpy(),
                                   atol=2e-6, rtol=1e-4, err_msg=key)


def test_ranks_draw_different_dropout_masks(runs):
    """At rate 0.1 each rank folds its rank into the step's randomness: the
    ranks' draws differ, and the step trains (a finite loss that is not the
    rate-0 loss)."""
    assert runs["two"]["masks_differ"]
    drop = runs["two"]["dropout"]["loss"][0]
    assert np.isfinite(drop) and drop != runs["two"]["dense"]["loss"][0]


def test_zero1_checkpoint_loads_at_world_size_one(runs):
    """The ZeRO-1 run's state dict, gathered whole, loads into a plain
    world-size-1 state; one more step from it equals one more step of the
    single-process run. (``zero1_resume``, the reverse, starts both ranks
    from a checkpoint of one process: test_two_ranks_equal_one_process.)"""
    spec = runs["spec"]
    got = worker.run_case(spec, {"name": "a", "steps": 1}, runs["two"]["zero1"]["state"])
    want = worker.run_case(spec, {"name": "b", "steps": 1}, runs["single"]["zero1"]["state"])
    assert runs["two"]["zero1"]["state"]["step"] == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_states_close(got["state"], want["state"])


def test_partition_balances_whole_parameters():
    params = [torch.zeros(n) for n in (10, 3, 7, 7, 1)]
    owner = mesh.partition(params, 2)
    assert owner == [0, 0, 1, 1, 0] and mesh.partition(params, 1) == [0] * 5
    load = [sum(p.numel() for p, o in zip(params, owner) if o == r) for r in (0, 1)]
    assert load == [14, 14]


def test_shard_batch_slices_or_replicates():
    batch = _fake_batch(8, 3)
    local, sharded = mesh.shard_batch(batch, world=2, at=1)
    assert sharded and local["query_ids"].shape[0] == 4 and local["contexts_ids"].shape[0] == 12
    np.testing.assert_array_equal(local["pos_ctx_indices"], batch["pos_ctx_indices"][4:])
    ragged = _fake_batch(7, 3)
    assert mesh.shard_batch(ragged, world=2, at=0) == (ragged, False)
    assert mesh.shard_batch(batch) == (batch, False)  # no group: world size 1


def test_launch_does_nothing_unconfigured(monkeypatch):
    for name in ("DPR_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert launch.maybe_initialize_distributed(device="cpu") is False
    assert mesh.world_size() == 1 and mesh.rank() == 0


def test_launch_raises_on_a_failed_multi_process_start(monkeypatch):
    """Configured for two processes with no peer at the coordinator: the
    start times out and raises, never training alone (the JAX rule). In a
    process of its own: torch counts the failed group, so a later group of
    the same process would take another name than its peers'."""
    env = dict(os.environ, DPR_COORDINATOR=f"127.0.0.1:{_free_port()}", DPR_NUM_PROCESSES="2",
               DPR_PROCESS_ID="1", PYTHONPATH=ROOT)
    code = ("from dpr_scale_tpu_torch.parallel import launch\n"
            "launch.maybe_initialize_distributed(device='cpu', timeout_s=3)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "refusing to fall back to training alone" in proc.stderr
    monkeypatch.setenv("DPR_COORDINATOR", env["DPR_COORDINATOR"])
    monkeypatch.setenv("DPR_NUM_PROCESSES", "2")
    monkeypatch.delenv("DPR_PROCESS_ID", raising=False)
    with pytest.raises(RuntimeError, match="DPR_PROCESS_ID"):  # refused before any start
        launch.maybe_initialize_distributed(device="cpu", timeout_s=3)
    assert mesh.world_size() == 1


def test_cli_train_on_two_ranks_equals_one(tiny_bert_dir, dpr10_jsonl, tmp_path):
    """``cli.train trainer.num_devices=2 trainer.strategy=ddp_sharded
    --device cpu`` starts a second rank itself: the same per-step losses
    and test metrics as one process, a checkpoint and an export from rank 0
    alone, written whole (no partition map, every parameter's moments)."""
    from dpr_scale_tpu_torch.cli import train
    from dpr_scale_tpu_torch.train.checkpoint import CheckpointManager

    def argv(name, *extra):
        return ["--config", os.path.join(ROOT, "conf", "tiny_smoke.yaml"), "--device", "cpu",
                "--metrics-out", str(tmp_path / name / "metrics.json"),
                f"task.transform.model_path={tiny_bert_dir}", f"datamodule.train_path={dpr10_jsonl}",
                f"datamodule.val_path={dpr10_jsonl}", f"datamodule.test_path={dpr10_jsonl}",
                "task.model.dtype=float32", "trainer.log_every=1",
                f"trainer.metrics_jsonl={tmp_path / name / 'log.jsonl'}",
                f"checkpoint_callback.dirpath={tmp_path / name / 'ckpt'}", *extra]

    import json

    one = train.main(argv("one"))
    # rank 0 in a process (and session) of its own, killed with its rank 1 on a timeout
    _run_group([([sys.executable, "-m", "dpr_scale_tpu_torch.cli.train",
                  *argv("two", "trainer.num_devices=2", "trainer.strategy=ddp_sharded")],
                 dict(os.environ, PYTHONPATH=ROOT))])
    with open(tmp_path / "two" / "metrics.json") as f:
        two = json.load(f)
    for key in one:
        np.testing.assert_allclose(two[key], one[key], rtol=1e-5, err_msg=key)

    def losses(name):
        with open(tmp_path / name / "log.jsonl") as f:
            return [r["train_loss"] for r in map(json.loads, f) if "train_loss" in r]

    np.testing.assert_allclose(losses("two"), losses("one"), rtol=1e-5)
    assert os.path.exists(tmp_path / "two" / "ckpt" / "params_best" / "params.pt")
    restored = CheckpointManager(str(tmp_path / "two" / "ckpt")).restore_last()
    assert "zero1_owner" not in restored and set(restored["mu"]) == set(restored["params"])
