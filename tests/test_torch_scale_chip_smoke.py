"""chip_smoke.py phase 22 (the index store, the host tiers, data-parallel
training and the sweep driver) without a card: it runs end to end on the
CPU at a tiny size up to its launch-count check (the kernels never launch
on CPU tensors); the world-size-1 group is gloo here, NCCL on the card."""
import pytest
import torch

import chip_smoke

TINY = ["task.model.arch=tiny", "task.model.vocab_size=30522", "task.transform.max_seq_len=16",
        "task.model.hidden_size=32", "task.model.num_heads=2", "task.model.intermediate_size=64",
        "task.model.dtype=float32"]


def test_scale_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    with pytest.raises(AssertionError, match="never launched") as err:
        chip_smoke.phase_scale(str(tmp_path), torch.device("cpu"), n_rows=8192, shard_rows=2048,
                               dim=16, n_queries=64, batch=32, dp_batch=4, dp_steps=2,
                               extra=TINY, sweep_extra=TINY)
    out = capsys.readouterr().out
    assert "scale (b) 8192 x 16 rows in 4 blocks of 8192: shards written" in out
    assert "streamed top-100 equal to all-on-device" in out
    assert "scale (b) host-resident fused, 8192 rows bf16 streamed" in out
    assert "scale (b) host-resident groupmax, 8192 rows bf16 streamed" in out
    assert "the ZeRO-1 checkpoint (step 2) loads without a group" in out
    assert "scale (d) cli.sweep over 2 one-step runs of batch 4 (2 layers)" in out
    assert str(err.value).endswith(
        "['b store, half streamed, first search: int_groupmax', "
        "'b from the shards, first search: int_groupmax', "
        "'b host-resident fused: count_above_groups', 'b host-resident groupmax: groupmax', "
        "'c cli.train plain: attention_fwd_dropout', 'c cli.train plain: attention_bwd', "
        "'c cli.train nccl: attention_fwd_dropout', 'c cli.train nccl: attention_bwd']")
