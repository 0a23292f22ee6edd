"""The port's profilers (tools.profile_serve, tools.profile_train) run on the
CPU at a tiny width, and ``task.model.fused_ffn=true`` reaches the model
they profile (the fused FFN's plain versions run); tools.bench_sweeps, which
only times the card, refuses to run without one; tools.keyed_train trains
and retrieves on chip_smoke.py phase 18's keyed data at a tiny width."""
import json

import pytest
import torch

from dpr_scale_tpu_torch.ops import ffn
from dpr_scale_tpu_torch.tools import bench_sweeps, keyed_train, profile_serve, profile_train

_TINY = ["task.model.arch=tiny", "task.model.vocab_size=30522", "task.transform.max_seq_len=32"]


def _count_applies(monkeypatch):
    calls = {ffn.FusedFFN: 0, ffn.FusedFFNLN: 0}
    for fn in calls:
        def counted(*args, fn=fn, apply=fn.apply):
            calls[fn] += 1
            return apply(*args)

        monkeypatch.setattr(fn, "apply", counted)
    return calls


@pytest.mark.parametrize("fused_ffn", ["false", "true"])
def test_profile_serve_runs_on_cpu(fused_ffn, monkeypatch, capsys):
    calls = _count_applies(monkeypatch)
    assert profile_serve.main(["--device", "cpu", "--rows", "4096", *_TINY,
                               f"task.model.fused_ffn={fused_ffn}"]) == 0
    out = capsys.readouterr().out
    assert "== encode B=128 L=32" in out and "== search exact_sort B=64" in out
    assert (calls[ffn.FusedFFNLN] > 0) == (fused_ffn == "true")
    assert calls[ffn.FusedFFN] == 0  # encoding runs deterministic forwards


@pytest.mark.parametrize("fused_ffn", ["false", "true"])
def test_profile_train_runs_on_cpu(fused_ffn, monkeypatch, capsys):
    calls = _count_applies(monkeypatch)
    assert profile_train.main(["--device", "cpu", "--batch", "4", *_TINY,
                               f"task.model.fused_ffn={fused_ffn}"]) == 0
    assert "== train step, 4 queries + 8 contexts, L=32" in capsys.readouterr().out
    assert (calls[ffn.FusedFFN] > 0) == (fused_ffn == "true")
    assert calls[ffn.FusedFFNLN] == 0  # training forwards


def test_profile_train_runs_the_multivec_step_on_cpu(capsys):
    """``--config conf/citadel.yaml`` profiles the multi-vector task's step
    on its teacher-less batch."""
    assert profile_train.main(["--config", "conf/citadel.yaml", "--device", "cpu", "--batch", "4",
                               *_TINY, "task.tok_projection_dim=8",
                               "task.cls_projection_dim=8"]) == 0
    assert "== train step, 4 queries + 8 contexts, L=32" in capsys.readouterr().out


def test_bench_sweeps_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_sweeps.main() == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_keyed_train_runs_on_cpu(capsys):
    """Two runs of 8 steps on the keyed data (width 32, fp32, dropout 0) that
    differ only in the attention route: the same losses within 1e-4
    relative (the CPU runs both routes' plain versions), a loss at every
    step, a validation MRR every 4 steps and at the epoch's end (step 5), and each export's recall@10
    above the seeded encoder's (the rehearsal of phase 18 gains ~0.7 in 64
    steps)."""
    extra = ["task.model.arch=tiny", "task.model.vocab_size=30522",
             "task.transform.max_seq_len=16", "task.model.hidden_size=32", "task.model.num_heads=2",
             "task.model.intermediate_size=64", "task.model.dtype=float32",
             "task.model.hidden_dropout=0.0", "task.model.attention_dropout=0.0",
             "task.optim.lr=3e-3"]
    keyed_train.main(["--device", "cpu", "--steps", "8", "--eval-every", "4", "--batch-size", "12",
                      "--passages", "60", "--questions", "32", "--extra", *extra,
                      "--run", "fused", "--run", "plain", "task.model.fused_attention=false"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    seeded, fused, plain = lines
    assert seeded["run"] == "seeded" and plain["overrides"] == ["task.model.fused_attention=false"]
    for run in (fused, plain):
        assert len(run["train_loss"]) == 8 and [s for s, _ in run["valid_mrr"]] == [4, 5, 8]
        assert run["recall_at_10"] > seeded["recall_at_10"]
    close = [abs(a - b) <= 1e-4 * abs(b) for a, b in zip(fused["train_loss"], plain["train_loss"])]
    assert all(close), (fused["train_loss"], plain["train_loss"])
