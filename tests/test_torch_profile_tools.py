"""The port's profilers (tools.profile_serve, tools.profile_train) run on the
CPU at a tiny width, and ``task.model.fused_ffn=true`` reaches the model
they profile (the fused FFN's plain versions run); tools.bench_sweeps, which
only times the card, refuses to run without one."""
import pytest
import torch

from dpr_scale_tpu_torch.ops import ffn
from dpr_scale_tpu_torch.tools import bench_sweeps, profile_serve, profile_train

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


def test_bench_sweeps_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_sweeps.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
