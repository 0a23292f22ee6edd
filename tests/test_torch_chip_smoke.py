"""chip_smoke.py without a card: it refuses to run, and its slice phase runs
end to end on the CPU at a tiny size up to the launch-count check (the
kernels never launch on CPU tensors)."""
import pytest
import torch

import chip_smoke


def test_main_exits_nonzero_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert chip_smoke.main() == 1
    assert '"ok"' not in capsys.readouterr().out


def test_slice_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    extra = ["task.model.arch=tiny", "task.model.vocab_size=30522",
             "task.transform.max_seq_len=32"]
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_slice(str(tmp_path), torch.device("cpu"), n_rows=2048,
                               n_encoded=128, extra=extra)
    out = capsys.readouterr().out
    assert "request latency ms" in out  # every request passed check_exact
    assert "main-path launches: {'attention_fwd': 0, 'count_above_groups': 0}" in out


def test_train_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    extra = ["task.model.arch=tiny", "task.model.vocab_size=30522",
             "task.transform.max_seq_len=32", "task.model.hidden_dropout=0.1",
             "task.model.attention_dropout=0.1"]
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_train(str(tmp_path), torch.device("cpu"), batch_size=4, steps=3,
                               extra=extra)
    out = capsys.readouterr().out
    assert "train: 3 steps of 4 queries" in out  # steps, validation and test passed
    assert "training-path launches: {'attention_fwd_dropout': 0, 'attention_bwd': 0}" in out
