"""The port's checkpoint layer (dpr_scale_tpu_torch.train.checkpoint, the
trainer's saves, ``--resume``, the best-params export) on the CPU, held
against the JAX package's manager where both keep steps.

Every comparison here is exact: retention and ``best_step`` are decisions,
and a restored or resumed state must equal its unbroken twin bit for bit
(one process, the CPU's deterministic kernels, dropout a pure function of
(seed, step)).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.train.checkpoint import CheckpointManager as JaxManager
from dpr_scale_tpu_torch.cli import generate_embeddings, train
from dpr_scale_tpu_torch.cli.common import build_biencoder, build_datamodule, build_task
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.data.tokenize import HFTokenizer
from dpr_scale_tpu_torch.encode.embeddings import load_embedding_shard
from dpr_scale_tpu_torch.optim.factory import make_optimizer
from dpr_scale_tpu_torch.train import checkpoint
from dpr_scale_tpu_torch.train.checkpoint import CheckpointManager, load_params, save_params
from dpr_scale_tpu_torch.train.loop import Trainer
from dpr_scale_tpu_torch.train.task import DenseRetrieverTask

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")


def _state(step):
    return {"w": torch.arange(4.0) + step, "step": step}


def _same(a, b):
    """Nested dicts of tensors / ints equal key for key, bit for bit."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# (step, metric or None: a save without the monitored metric)
_SEQUENCES = {
    "ranked": [(1, 0.3), (2, 0.9), (3, 0.5), (4, 0.9), (5, 0.1)],
    "missing": [(1, None), (2, 0.4), (3, None), (4, 0.1), (5, 0.4)],
}


@pytest.mark.parametrize("seq", sorted(_SEQUENCES))
@pytest.mark.parametrize("save_top_k", [1, 2])
@pytest.mark.parametrize("mode", ["max", "min"])
def test_manager_keeps_the_steps_the_jax_manager_keeps(tmp_path, mode, save_top_k, seq):
    """The same (step, metric) sequence through the JAX manager (orbax) and
    the port's: the same steps on disk after every save, the same
    best_step, and the best step's state restored."""
    jax_mgr = JaxManager(str(tmp_path / "jax"), mode=mode, save_top_k=save_top_k)
    mgr = CheckpointManager(str(tmp_path / "port"), mode=mode, save_top_k=save_top_k)
    for step, mrr in _SEQUENCES[seq]:
        metrics = {} if mrr is None else {"mrr": mrr, "loss": 1.0}
        jax_mgr.save(step, {"w": jnp.arange(4.0) + step, "step": jnp.asarray(step)}, metrics)
        mgr.save(step, _state(step), metrics)
        assert mgr.all_steps() == sorted(jax_mgr._mgr.all_steps()), step
        assert mgr.best_step() == jax_mgr.best_step(), step
    best = mgr.best_step()
    _same(mgr.restore(), _state(best))
    assert sorted(d for d in os.listdir(tmp_path / "port") if d.isdigit()) == [
        str(s) for s in mgr.all_steps()]
    # a new manager over the directory (a resumed run) ranks the same steps
    assert CheckpointManager(str(tmp_path / "port"), mode=mode,
                             save_top_k=save_top_k).best_step() == best
    jax_mgr.close()


def test_last_survives_topk_eviction(tmp_path):
    """A save whose metric does not make the top-k writes no step directory,
    but "last" holds it (tests/test_config_and_loop.py's twin)."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), monitor="mrr", save_top_k=1)
    for step, mrr in [(1, 0.9), (2, 0.5), (3, 0.1)]:
        mgr.save(step, _state(step), {"mrr": mrr})
    assert mgr.best_step() == 1
    assert sorted(d for d in os.listdir(tmp_path / "ckpt") if d.isdigit()) == ["1"]
    _same(mgr.restore_last(), _state(3))
    last = tmp_path / "ckpt" / "last" / "state"
    assert last.is_dir() and not last.is_symlink()
    assert json.loads((last / "metrics.json").read_text()) == {"mrr": 0.1, "step": 3}


class _Killed(BaseException):
    """Stands for SIGKILL: nothing after the raise point runs."""


@pytest.mark.parametrize("where", ["step_dir", "last_tmp", "last_tmp_unranked",
                                   "between_renames"])
def test_last_survives_a_kill_in_the_middle_of_a_write(tmp_path, monkeypatch, where):
    """A process killed while it writes save 2 (in the step directory, in
    last/state.tmp as a link to the step's file or, for a step that does not
    rank, serialized there, or after last/state moved to state.old) leaves
    save 1 whole for a new process's restore_last."""
    directory = str(tmp_path / "ckpt")
    mgr = CheckpointManager(directory, save_top_k=2)
    mgr.save(1, _state(1), {"mrr": 0.3})
    mgr.save(0, _state(0), {"mrr": 0.2})  # fills the top 2: a worse step 2 does not rank
    mgr.save(1, _state(1), {"mrr": 0.3})  # last holds save 1 again

    real_save, real_rename, real_link = torch.save, os.rename, os.link

    def half_written(path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise _Killed

    def killing_save(obj, path, *a, **k):
        if where == "step_dir" and "/2.tmp/" in str(path) or (
                where == "last_tmp_unranked" and "state.tmp" in str(path)):
            half_written(path)
        return real_save(obj, path, *a, **k)

    def killing_link(src, dst):
        if where == "last_tmp" and "state.tmp" in str(dst):
            half_written(dst)
        return real_link(src, dst)

    def killing_rename(src, dst):
        if where == "between_renames" and str(src).endswith("state.tmp"):
            raise _Killed
        return real_rename(src, dst)

    monkeypatch.setattr(checkpoint.torch, "save", killing_save)
    monkeypatch.setattr(checkpoint.os, "link", killing_link)
    monkeypatch.setattr(checkpoint.os, "rename", killing_rename)
    with pytest.raises(_Killed):
        mgr.save(2, _state(2), {"mrr": 0.1 if where == "last_tmp_unranked" else 0.9})
    monkeypatch.undo()
    if where == "between_renames":
        assert not (tmp_path / "ckpt" / "last" / "state").exists()
        assert (tmp_path / "ckpt" / "last" / "state.old").is_dir()
    fresh = CheckpointManager(directory, save_top_k=2)
    _same(fresh.restore_last(), _state(1))
    assert fresh.all_steps() == {"step_dir": [0, 1], "last_tmp_unranked": [0, 1]}.get(where, [1, 2])
    fresh.save(3, _state(3), {"mrr": 0.5})  # the next save cleans up and lands
    _same(fresh.restore_last(), _state(3))
    assert sorted(os.listdir(tmp_path / "ckpt" / "last")) == ["state"]


def test_last_links_the_step_just_written(tmp_path, monkeypatch):
    """A kept step's state.pt is hard-linked into last/state, not written
    twice; evicting that step leaves last whole, also for a kill between
    the eviction and the next last/state."""
    directory = tmp_path / "ckpt"
    mgr = CheckpointManager(str(directory), save_top_k=1)
    mgr.save(1, _state(1), {"mrr": 0.3})
    last = directory / "last" / "state" / checkpoint.STATE_FILE
    assert last.stat().st_ino == (directory / "1" / checkpoint.STATE_FILE).stat().st_ino

    def killed(*a, **k):
        raise _Killed

    monkeypatch.setattr(mgr, "_write_last", killed)
    with pytest.raises(_Killed):
        mgr.save(2, _state(2), {"mrr": 0.9})  # step 1 evicted, last not yet replaced
    monkeypatch.undo()
    assert sorted(d for d in os.listdir(directory) if d.isdigit()) == ["2"]
    fresh = CheckpointManager(str(directory), save_top_k=1)
    _same(fresh.restore_last(), _state(1))
    fresh.save(3, _state(3), {"mrr": 0.1})  # does not rank: serialized into last
    assert fresh.all_steps() == [2]
    _same(fresh.restore_last(), _state(3))
    assert last.stat().st_nlink == 1


def test_async_saves_equal_sync_saves_bit_for_bit(tmp_path):
    """async_save writes the same files as a synchronous save, from a host
    copy taken before save() returns: the caller's tensors are changed in
    place right after each save, as the train step changes them."""
    mgrs = {mode: CheckpointManager(str(tmp_path / mode), save_top_k=2,
                                    async_save=mode == "async")
            for mode in ("sync", "async")}
    live = {mode: {"params": {"w": torch.zeros(64, 8)}, "count": 0, "step": 0}
            for mode in mgrs}
    for step, mrr in [(1, 0.3), (2, 0.9), (3, 0.5)]:
        for mode, mgr in mgrs.items():
            s = live[mode]
            s["params"]["w"].copy_(torch.randn(64, 8, generator=torch.Generator().manual_seed(step)))
            s["step"] = s["count"] = step
            mgr.save(step, s, {"mrr": mrr})
            s["params"]["w"].mul_(-7.0)  # the next step's in-place update
    for mgr in mgrs.values():
        mgr.wait()
    assert mgrs["sync"].all_steps() == mgrs["async"].all_steps() == [2, 3]
    for step in (2, 3):
        _same(mgrs["async"].restore(step=step), mgrs["sync"].restore(step=step))
        ref = torch.randn(64, 8, generator=torch.Generator().manual_seed(step))
        assert torch.equal(mgrs["async"].restore(step=step)["params"]["w"], ref)
    _same(mgrs["async"].restore_last(), mgrs["sync"].restore_last())


def test_a_failed_async_save_names_its_step_and_the_next_save_lands(tmp_path, monkeypatch):
    """A failed async save raises at the next barrier, naming the step that
    failed; the save that surfaces it is still scheduled and lands."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    real = mgr._save_host

    def failing(step, host_state, metrics):
        if step == 1:
            raise OSError("disk full")
        return real(step, host_state, metrics)

    monkeypatch.setattr(mgr, "_save_host", failing)
    mgr.save(1, _state(1), {"mrr": 0.1})
    with pytest.raises(RuntimeError, match="save of step 1 .*disk full"):
        mgr.save(2, _state(2), {"mrr": 0.2})
    mgr.wait()  # raised once, then cleared; step 2 is on disk
    assert mgr.all_steps() == [2]
    _same(mgr.restore_last(), _state(2))


def test_params_export_round_trip_and_missing_paths(tmp_path):
    sd = {"a.weight": torch.randn(3, 4), "a.bias": torch.randn(4)}
    save_params(str(tmp_path / "p"), sd)
    _same(load_params(str(tmp_path / "p")), sd)
    for missing in (tmp_path / "nothing", tmp_path / "p.npz", tmp_path):
        with pytest.raises(FileNotFoundError, match="no params export"):
            load_params(str(missing))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "params.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        load_params(str(tmp_path / "bad"))


# ---------------------------------------------------------------------- #
# the trainer through cli.train


def _argv(tiny_bert_dir, dpr10_jsonl, ckpt, *extra):
    return ["--config", os.path.join(CONF, "tiny_smoke.yaml"), "--device", "cpu",
            f"task.transform.model_path={tiny_bert_dir}", f"datamodule.train_path={dpr10_jsonl}",
            f"datamodule.val_path={dpr10_jsonl}", f"datamodule.test_path={dpr10_jsonl}",
            "datamodule.batch_size=2", "trainer.max_epochs=2", "trainer.eval_every_steps=3",
            "trainer.log_every=1", "task.model.hidden_dropout=0.1",
            "task.model.attention_dropout=0.1", f"checkpoint_callback.dirpath={ckpt}",
            "checkpoint_callback.async_save=true", *extra]


def _lrs(path):
    with open(path) as f:
        return {l["step"]: l["lr"] for l in map(json.loads, f) if "lr" in l}


@pytest.mark.parametrize("kill_at", [5, 6], ids=["epoch_end", "mid_epoch"])
def test_resume_equals_the_unbroken_run_bit_for_bit(tiny_bert_dir, dpr10_jsonl, tmp_path,
                                                    monkeypatch, kill_at):
    """10 steps (2 epochs of 5) unbroken, against a run killed after its save
    at ``kill_at`` (a validation at an epoch's end, or at eval_every_steps in
    the middle of epoch 2) and resumed with --resume: the same batches from
    the next one on, the same LR at every step, and at step 10 the same
    params, mu, nu, count, step and dropout seed, bit for bit."""
    batches = []
    real_step = DenseRetrieverTask.train_step

    def recording(self, state, batch, *args):
        batches.append((state.step, {k: v.clone() for k, v in batch.items()}))
        return real_step(self, state, batch, *args)

    monkeypatch.setattr(DenseRetrieverTask, "train_step", recording)
    log = lambda name: f"trainer.metrics_jsonl={tmp_path / name}"
    train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "a", log("a.jsonl")))
    unbroken = dict(batches)
    batches.clear()

    real_save = CheckpointManager.save

    def save_then_die(self, step, state, metrics=None):
        real_save(self, step, state, metrics)
        if step == kill_at:
            self.wait()
            raise KeyboardInterrupt

    monkeypatch.setattr(CheckpointManager, "save", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "b", log("b1.jsonl")))
    monkeypatch.setattr(CheckpointManager, "save", real_save)
    assert max(s for s, _ in batches) == kill_at - 1
    batches.clear()
    train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "b", log("b2.jsonl"), "--resume"))

    assert [s for s, _ in batches] == list(range(kill_at, 10))
    for step, batch in batches:
        for key, t in batch.items():
            assert torch.equal(t, unbroken[step][key]), (step, key)
    lrs, resumed = _lrs(tmp_path / "a.jsonl"), _lrs(tmp_path / "b2.jsonl")
    assert sorted(resumed) == list(range(kill_at + 1, 11))
    assert all(resumed[s] == lrs[s] for s in resumed)
    a = CheckpointManager(str(tmp_path / "a")).restore_last()
    b = CheckpointManager(str(tmp_path / "b")).restore_last()
    assert a["step"] == 10 and a["count"] == 10
    _same(a, b)
    # the best steps agree too, and both runs exported the same params
    assert CheckpointManager(str(tmp_path / "a")).best_step() == \
        CheckpointManager(str(tmp_path / "b")).best_step()
    _same(load_params(str(tmp_path / "a" / "params_best")),
          load_params(str(tmp_path / "b" / "params_best")))


@pytest.mark.parametrize("limit,last", [([], 10), (["trainer.max_steps=7"], 7)],
                         ids=["max_epochs", "max_steps"])
def test_resume_of_a_finished_run_trains_no_further(tiny_bert_dir, dpr10_jsonl, tmp_path, capsys,
                                                    limit, last):
    """A run resumed after its last step (2 epochs, or max_steps in the
    middle of an epoch) trains no further step."""
    train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "a", *limit))
    done = CheckpointManager(str(tmp_path / "a")).restore_last()
    assert done["step"] == last
    capsys.readouterr()
    train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "a", *limit, "--resume"))
    out = capsys.readouterr().out
    assert f"Resumed from last checkpoint at step {last}" in out and "train_loss" not in out
    _same(CheckpointManager(str(tmp_path / "a")).restore_last(), done)


def test_resume_without_a_last_checkpoint_starts_fresh(tiny_bert_dir, dpr10_jsonl, tmp_path,
                                                       capsys):
    train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "a", "trainer.max_epochs=1",
                     "--resume"))
    assert "No last checkpoint found; starting fresh" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path / "a")).restore_last()["step"] == 5


def _task_and_dm(tiny_bert_dir, dpr10_jsonl):
    cfg = load_config(os.path.join(CONF, "tiny_smoke.yaml"), [
        f"task.transform.model_path={tiny_bert_dir}", f"datamodule.train_path={dpr10_jsonl}",
        f"datamodule.val_path={dpr10_jsonl}", f"datamodule.test_path={dpr10_jsonl}",
        "datamodule.batch_size=2"])
    dm = build_datamodule(cfg, HFTokenizer(tiny_bert_dir, max_seq_len=16))
    return build_task(cfg, make_optimizer("adamw", 3e-2), "cpu"), dm


def test_test_restores_the_best_step(tiny_bert_dir, dpr10_jsonl, tmp_path):
    """Trainer.test evaluates the best checkpoint, not the final state (the
    JAX trainer restores it first); restore_best=False evaluates the state
    as it is."""
    task, dm = _task_and_dm(tiny_bert_dir, dpr10_jsonl)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_top_k=1)
    trainer = Trainer(task, dm, checkpoint=mgr, log_every=100)
    state = task.init_state(0)
    mgr.save(0, state, {"mrr": 0.9})
    want = task.run_eval(state, dm.test_batches())
    trainer.fit(state)  # 5 steps at lr 3e-2 move the weights; its save ranks below
    assert state.step == 5 and mgr.best_step() == 0
    final = Trainer(task, dm, log_every=100).test(state)
    assert final != want
    assert trainer.test(state, restore_best=False) == final
    assert trainer.test(state) == want
    assert state.step == 0  # restored in place
    # a kept step whose file is gone raises; it is not the final state
    os.remove(tmp_path / "ckpt" / "0" / checkpoint.STATE_FILE)
    with pytest.raises(FileNotFoundError):
        trainer.test(state)
    # with no step kept, test evaluates the state it is given
    assert Trainer(task, dm, checkpoint=CheckpointManager(str(tmp_path / "none")),
                   log_every=100).test(state) == want


def test_state_dict_round_trip_keeps_device_dtype_and_names(tiny_bert_dir, dpr10_jsonl,
                                                            tmp_path):
    """A saved TrainState holds mu / nu keyed by the parameter names, and
    loads into a fresh state in place, keeping dtypes; a name that is not
    the model's raises."""
    task, dm = _task_and_dm(tiny_bert_dir, dpr10_jsonl)
    state = task.init_state(0)
    Trainer(task, dm, max_steps=2, log_every=100).fit(state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, state)
    snap = mgr.restore_last()
    names = [n for n, _ in state.model.named_parameters()]
    assert list(snap["params"]) == list(snap["mu"]) == list(snap["nu"]) == names
    assert (snap["count"], snap["step"], snap["dropout_seed"]) == (2, 2, 0)
    fresh = task.init_state(1)
    fresh.load_state_dict(snap)
    _same(fresh.state_dict(), state.state_dict())
    assert all(t.dtype == torch.float32 for t in fresh.opt_state["mu"])
    bad = dict(snap, mu={**snap["mu"], "extra": torch.zeros(1)})
    with pytest.raises(KeyError, match="unexpected.*extra"):
        fresh.load_state_dict(bad)


def test_encode_from_params_best_equals_the_model_in_memory(tiny_bert_dir, dpr10_jsonl,
                                                            tmp_path, monkeypatch):
    """cli.train's export, read back through task.checkpoint_path by
    generate_embeddings, encodes the corpus as the trained model in memory
    does, bit for bit."""
    seen = {}
    real_test = Trainer.test

    def keep(self, state, restore_best=True):
        seen["state"] = state
        return real_test(self, state, restore_best)

    monkeypatch.setattr(Trainer, "test", keep)
    train.main(_argv(tiny_bert_dir, dpr10_jsonl, tmp_path / "ckpt",
                     "checkpoint_callback.save_top_k=1", "task.optim.lr=3e-2"))
    model = seen["state"].model.eval()
    with open(tmp_path / "passages.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        f.writelines(f"p{i}\ttext {'abcdefgh'[i % 8]} who\ttitle {i}\n" for i in range(11))
    common = ["--config", os.path.join(CONF, "tiny_smoke.yaml"), "--device", "cpu",
              f"task.transform.model_path={tiny_bert_dir}",
              f"datamodule.passages_path={tmp_path}/passages.tsv",
              "datamodule.encode_batch_size=4"]
    export = [f"task.checkpoint_path={tmp_path}/ckpt/params_best"]
    generate_embeddings.main(common + export + [f"task.ctx_embeddings_dir={tmp_path}/embs"])
    got = load_embedding_shard(str(tmp_path / "embs" / "reps_0000.pkl"))

    monkeypatch.setattr(generate_embeddings, "build_biencoder", lambda cfg, device: model)
    generate_embeddings.main(common + [f"task.ctx_embeddings_dir={tmp_path}/mem"])
    want = load_embedding_shard(str(tmp_path / "mem" / "reps_0000.pkl"))
    assert got.shape == (11, 16)
    np.testing.assert_array_equal(got, want)

    cfg = lambda extra: load_config(common[1], common[4:] + extra)
    loaded, seeded = build_biencoder(cfg(export), "cpu"), build_biencoder(cfg([]), "cpu")
    _same(loaded.state_dict(), model.state_dict())
    assert not torch.equal(seeded.context_encoder.transformer.word_embeddings.weight,
                           loaded.context_encoder.transformer.word_embeddings.weight)
