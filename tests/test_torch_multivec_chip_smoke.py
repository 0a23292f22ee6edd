"""chip_smoke.py phase 20 (the multi-vector slice) without a card: it runs
end to end on the CPU at a tiny size up to its launch-count check (the
kernels never launch on CPU tensors)."""
import pytest
import torch

import chip_smoke


def test_multivec_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    """Phase 20 at a tiny width (fp32): the monolithic step and the GradCache
    gate, run_eval at the conf's validation and test context counts,
    cli.train on the conf as it stands with an export and its variant with
    the fused attention under GradCache, the export's top-100 equal to the
    in-memory model's, /search_citadel equal to citadel_retrieval's
    device-index run, two SPLADE steps; no kernel launches on CPU tensors,
    so each main-path run that needs one is named."""
    tiny = ["task.model.arch=tiny", "task.model.vocab_size=30522", "task.transform.max_seq_len=16",
            "task.model.hidden_size=32", "task.model.num_heads=2",
            "task.model.intermediate_size=64", "task.model.dtype=float32",
            "task.tok_projection_dim=8", "task.cls_projection_dim=8"]
    with pytest.raises(AssertionError, match="never launched") as err:
        chip_smoke.phase_multivec(str(tmp_path), torch.device("cpu"), batch_size=8, steps=4,
                                  variant_steps=2,
                                  n_passages=64, n_questions=48, gate_batch=8, splade_batch=4,
                                  serve_questions=32, extra=tiny,
                                  splade_extra=[t for t in tiny if "projection" not in t])
    out = capsys.readouterr().out
    assert "multivec (a) monolithic step, 8 queries + 16 contexts at L = 16" in out
    assert out.count("GradCache gate, 8 queries") == 1
    assert "multivec (b) validation: 8 queries x 88 contexts" in out
    assert "multivec (b) test: 8 queries x 408 contexts" in out
    assert "(monolithic, the conf's attention): 4 steps of 8 queries + 16 contexts" in out
    assert "task.grad_cache_chunks=2: 2 steps of 8 queries + 16 contexts" in out
    assert "equal the in-memory model's for all 48 questions" in out
    assert "32 questions k=10" in out and "0 disagree" in out
    assert "multivec (f) cli.train conf/nq.yaml task.model.family=splade" in out
    assert ("summed {'attention_fwd': 0, 'attention_fwd_dropout': 0, 'attention_bwd': 0, "
            "'ffn_fwd': 0, 'gather_score_serial': 0, 'gather_score_streamed': 0}") in out
    assert str(err.value).endswith(
        "['c variant: attention_fwd', 'c variant: attention_fwd_dropout', "
        "'c variant: attention_bwd', "
        "'d encode and search: gather_score_serial/gather_score_streamed', "
        "'e serve: gather_score_serial/gather_score_streamed', 'f splade: attention_fwd', "
        "'f splade: attention_fwd_dropout', 'f splade: attention_bwd', 'f splade: ffn_fwd']")
