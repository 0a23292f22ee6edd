"""chip_smoke.py phase 21 (the rest of the reference surface) without a
card: it runs end to end on the CPU at a tiny size up to its launch-count
check (the kernels never launch on CPU tensors). Phase 18's and phase 20's
exports are stood in for by seeded weights of the same modules."""
import os

import pytest
import torch

import chip_smoke

TINY = ["task.model.arch=tiny", "task.model.vocab_size=30522", "task.transform.max_seq_len=16",
        "task.model.hidden_size=32", "task.model.num_heads=2", "task.model.intermediate_size=64",
        "task.model.dtype=float32"]


def _export(module, path, seed):
    from dpr_scale_tpu_torch.models.convert import init_params
    from dpr_scale_tpu_torch.train.checkpoint import save_params

    save_params(path, init_params(module, torch.Generator().manual_seed(seed)))


def test_rest_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    from dpr_scale_tpu_torch.cli.common import build_model_config
    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.models.encoder import BiEncoder, SpladeBiEncoder
    from dpr_scale_tpu_torch.models.multivec import MultiVecEncoder

    cfg = build_model_config(load_config(os.path.join(chip_smoke.ROOT, "conf", "nq.yaml"), TINY))
    d18, d20 = (str(tmp_path / n) for n in ("d18", "d20"))
    for d in (d18, d20):
        os.makedirs(d)
        chip_smoke.write_keyed_data(d, 64, 48, 8)
    _export(BiEncoder(cfg), f"{d18}/ckpt_b/params_best", 1)  # a teacher other than the student
    os.makedirs(f"{d18}/ckpt_b/3")
    torch.save({"params": {}}, f"{d18}/ckpt_b/3/state.pt")
    _export(MultiVecEncoder(cfg, "citadel", 8, 8), f"{d20}/ckpt/params_best", 2)
    _export(SpladeBiEncoder(cfg), f"{d20}/splade_ckpt/params_best", 3)
    proj = ["task.tok_projection_dim=8", "task.cls_projection_dim=8"]
    with pytest.raises(AssertionError, match="never launched") as err:
        chip_smoke.phase_rest(
            str(tmp_path / "work"), torch.device("cpu"), d18, f"{d18}/ckpt_b/params_best",
            f"{d20}/ckpt/params_best", d20, f"{d20}/splade_ckpt/params_best",
            n_passages=64, n_questions=48, n_rows=256, distill_steps=6, variant_steps=2,
            rerank_questions=16, workers=2, extra=TINY, mv_extra=TINY + proj, splade_extra=TINY,
            distill_extra=TINY + ["task.optim.lr=1e-3", "task.warmup_steps=0"],
            rerank_batch=16, encode_batch=16)
    out = capsys.readouterr().out
    assert "rest (a) cli.train conf/distill.yaml (the conf's attention): 6 steps of 32 rows" in out
    assert "rest (a) the distillation MSE" in out
    assert "rest (b) dense rerank vs the retrieval's scores of the same 320 pairs" in out
    assert "rest (b) cli.rerank multivec (citadel.yaml): 320 pairs" in out
    assert "equals the brute-force top-100 of the combined vectors" in out
    assert "rest (c) tools.tune_spar_weights over 64 passages" in out
    assert "rest (d) export: torch.export of the encoder at (16, 16)" in out
    assert "rest (e) generate_embeddings datamodule.num_workers=2: shard byte-equal" in out
    assert "rest (f) SPLADE (D = 30522)" in out and " 0 disagree with run_retrieval" in out
    assert str(err.value).endswith(
        "['a variant fused_attention: attention_fwd_dropout', "
        "'a variant fused_attention: attention_bwd', "
        "'b run_retrieval candidates: count_above_groups', 'b cli.rerank dense: attention_fwd', "
        "'b cli.rerank cross_encoder: attention_fwd', 'c encode export: attention_fwd', "
        "'c encode seeded: attention_fwd', 'c tools.spar_retrieval: count_above_groups', "
        "'d encode exported: attention_fwd', 'd encode int8: attention_fwd', "
        "'e encode workers: attention_fwd', 'f splade generate_embeddings: attention_fwd', "
        "'f splade queries: attention_fwd', 'f splade run_retrieval: count_above_groups', "
        "'f splade /search: count_above_groups']")
