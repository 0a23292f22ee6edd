"""The port's multirun driver (``dpr_scale_tpu_torch.cli.sweep``) against
the JAX package's ``cli.sweep``: the same axis expansion and dry-run plan,
and a two-run sweep of the port's ``cli.train`` on the CPU end to end
(tiny model, one epoch each; the JAX test's size would take twice as long
for nothing more)."""
import json
import os

import pytest

from dpr_scale_tpu.cli import sweep as jax_sweep
from dpr_scale_tpu_torch.cli import sweep

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")


@pytest.mark.parametrize("overrides", [
    ["task.optim.lr=1e-5,3e-5", "datamodule.batch_size=4", "a.b=[1,2]"],
    ["x=1,2", "y=a,b", "z={p: 1,q: 2}"],
    ["x=7"],
    [],
], ids=["one_axis", "two_axes", "constant", "none"])
def test_expand_overrides_equals_jax(overrides):
    assert sweep.expand_overrides(overrides) == jax_sweep.expand_overrides(overrides)


def test_expand_overrides_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="not key=value"):
        sweep.expand_overrides(["novalue"])
    with pytest.raises(ValueError, match="not key=value"):
        jax_sweep.expand_overrides(["novalue"])


def test_dry_run_plans_as_jax(tmp_path, capsys):
    """``--dry-run`` (and ``--run-index``) print the same plan and return
    the same (index, overrides, None) runs, running nothing."""
    argv = ["--config", os.path.join(CONF, "tiny_smoke.yaml"), "--dry-run",
            "task.optim.lr=1e-3,3e-3", "datamodule.batch_size=2,4", "trainer.max_epochs=1"]
    for extra in ([], ["--run-index", "2"]):
        got = sweep.main(argv[:2] + ["--sweep-dir", str(tmp_path / "p")] + extra + argv[2:])
        port_out = capsys.readouterr().out
        want = jax_sweep.main(argv[:2] + ["--sweep-dir", str(tmp_path / "j")] + extra + argv[2:])
        jax_out = capsys.readouterr().out
        assert got == want and port_out == jax_out
        assert len(got) == (4 if not extra else 1)
    assert not any((tmp_path / "p").iterdir())


def test_sweep_runs_cli_train_end_to_end(dpr10_jsonl, tiny_bert_dir, tmp_path):
    """A 2-point lr axis: each run its own ``cli.train --device cpu``
    subprocess with its own checkpoint directory, metrics and log; the
    summary writes the best run."""
    sweep_dir = tmp_path / "sweep"
    results = sweep.main([
        "--config", os.path.join(CONF, "tiny_smoke.yaml"), "--sweep-dir", str(sweep_dir),
        "--monitor", "mrr", "--device", "cpu", "task.optim.lr=1e-3,3e-3",
        f"task.transform.model_path={tiny_bert_dir}", f"datamodule.train_path={dpr10_jsonl}",
        f"datamodule.val_path={dpr10_jsonl}", f"datamodule.test_path={dpr10_jsonl}",
        "trainer.max_epochs=1",
    ])
    assert [r[1][-1] for r in results] == ["task.optim.lr=1e-3", "task.optim.lr=3e-3"]
    for idx, _ovs, metrics in results:
        assert metrics is not None and 0.0 < metrics["mrr"] <= 1.0, f"run {idx} failed"
        run = sweep_dir / f"run_{idx:03d}"
        assert (run / "ckpt" / "last").exists() and (run / "metrics.jsonl").exists()
        assert "dpr_scale_tpu_torch.cli.train --config" in (run / "cmd.txt").read_text()
    best = json.load(open(sweep_dir / "best.json"))
    assert best["run"] in (0, 1) and best["runs_scored"] == 2 and best["monitor"] == "mrr"
