"""chip_smoke.py without a card: it refuses to run, and its slice phase runs
end to end on the CPU at a tiny size up to the launch-count check (the
kernels never launch on CPU tensors)."""
import contextlib
import io
import re

import pytest
import torch

import chip_smoke

import torch_threads  # noqa: F401  (one intra-op thread a worker)


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


_FUSED_FFN = ["task.model.arch=tiny", "task.model.vocab_size=30522",
              "task.transform.max_seq_len=32", "task.model.fused_ffn=true"]


def test_fused_ffn_slice_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    """Phase 9 at a tiny width: every request is exact and the fused_ffn_ln
    counter joins the ones that must rise."""
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_slice(str(tmp_path), torch.device("cpu"), n_rows=2048,
                               n_encoded=128, extra=_FUSED_FFN)
    out = capsys.readouterr().out
    assert "request latency ms" in out
    assert ("main-path launches: {'attention_fwd': 0, 'count_above_groups': 0, "
            "'ffn_ln_fwd': 0}") in out


def test_fused_ffn_train_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    """Phase 10's training run at a tiny width with dropout: steps,
    validation and test pass, and both FFN counters must rise."""
    extra = _FUSED_FFN + ["task.model.hidden_dropout=0.1", "task.model.attention_dropout=0.1"]
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_train(str(tmp_path), torch.device("cpu"), batch_size=4, steps=3,
                               extra=extra)
    out = capsys.readouterr().out
    assert "train: 3 steps of 4 queries" in out
    assert ("training-path launches: {'attention_fwd_dropout': 0, 'attention_bwd': 0, "
            "'ffn_fwd': 0, 'ffn_ln_fwd': 0}") in out


def test_citadel_cli_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    """Phase 12 at a tiny width: shards, then the host, bf16, fp32, streamed
    and pipelined CLI runs, each compared with the host run; the fused
    scorer's and the pipelined kernel's counters must rise."""
    extra = ["task.model.arch=tiny", "task.model.vocab_size=30522",
             "task.transform.max_seq_len=32"]
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_citadel_cli(str(tmp_path), torch.device("cpu"), n_passages=48,
                                     n_queries=12, extra=extra)
    out = capsys.readouterr().out
    for what in ("fp32 device vs host", "fp32 device streamed vs host", "bf16 device vs host",
                 "bf16 pipelined vs bf16 fused"):
        assert f"{what}: 0 of 12 queries disagree" in out
    assert "citadel-path launches: {'gather_run_max': 0, 'gather_score_pipelined': 0}" in out


def test_citadel_search_phase_runs_on_cpu_until_the_launch_check(capsys):
    """Phase 13 at a tiny size (70,000 docs, over sorted_combine_min_docs, so
    the search without CLS takes the sorted combine): the kernel path equals
    the plain path and the numpy oracle, with and without the CLS term."""
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_citadel_search(torch.device("cpu"), n_docs=70_000,
                                        plan=((128, 40), (512, 16), (2048, 4)), batch=6,
                                        qtokens=8, dim=8, cls_dim=8, reps=1)
    out = capsys.readouterr().out
    for tag in ("with CLS", "without CLS"):
        assert (f"citadel search {tag}: kernel path vs plain scorers on cpu: 0 of 6 queries "
                "disagree") in out
        assert f"{tag}" in out and "vs the numpy oracle: 0 of 4 disagree" in out
    assert ("citadel search launches: {'gather_run_max': 0, 'gather_score_serial': 0, "
            "'gather_score_streamed': 0}") in out


def test_synthetic_citadel_layout_matches_from_host_index():
    """Phase 13 builds its index from tools/bench_citadel_device.py's layout;
    the same postings through from_host_index give the same run ids,
    run-compact docs and starts, and max run length."""
    import numpy as np

    from dpr_scale_tpu_torch.index.inverted import InvertedExpertIndex, _ExpertPostings
    from dpr_scale_tpu_torch.index.inverted_device import DeviceExpertIndex

    rng = np.random.default_rng(0)
    docs, run_id, run_doc, start_pos, mrl = chip_smoke._synth_bucket(rng, 6, 512, 300)
    host = InvertedExpertIndex(dim=4, num_docs=300)
    for e in range(6):
        d = docs[e][docs[e] >= 0]
        host.experts[e] = _ExpertPostings(d, np.ones(len(d), np.float32),
                                          np.ones((len(d), 4), np.float32))
    index = DeviceExpertIndex.from_host_index(host, dtype="float32", device="cpu")
    (b,) = index.buckets[512]["shards"]  # one device holds the whole bucket
    n = int(b["vecs"].shape[0])
    assert n >= 6
    np.testing.assert_array_equal(b["run_id"].numpy()[:6], run_id)
    R = run_doc.shape[1]
    np.testing.assert_array_equal(b["run_doc"].numpy()[:6, :R], run_doc)
    np.testing.assert_array_equal(b["start_pos"].numpy()[:6, :R], start_pos)
    assert b["max_run_len"] == mrl


def test_mips_kernel_phase_checks_run_on_cpu(monkeypatch, capsys):
    """Phase 14's comparisons at a tiny size, each kernel replaced by its
    plain version (the kernels have no CPU mode): every check passes, and a
    wrong kernel is caught."""
    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    for name in ("count_above", "groupmax", "tile_max_scores", "topk_candidates"):
        monkeypatch.setattr(mk, f"{name}_kernel", getattr(mk, f"{name}_plain"))
    cases = ((16, 8192, 32, "bfloat16", 4096, False), (5, 2048, 20, "float32", 256, False),
             (3, 1152, 7, "bfloat16", 384, False))
    entries = chip_smoke.phase_mips_kernels(torch.device("cpu"), cases)
    assert set(entries) == {"count_above", "groupmax", "tile_max_scores", "topk_candidates"}
    out = capsys.readouterr().out
    assert out.count("repeatable") == 12 and "outside the check" in out
    assert "0 pad rows" in out
    monkeypatch.setattr(mk, "groupmax_kernel", lambda q, c: tuple(t + 1e-3 for t in mk.groupmax_plain(q, c)))
    with pytest.raises(AssertionError, match="groupmax .* disagrees"):
        chip_smoke.phase_mips_kernels(torch.device("cpu"), cases[:1])
    monkeypatch.setattr(mk, "groupmax_kernel", mk.groupmax_plain)
    monkeypatch.setattr(mk, "topk_candidates_kernel", lambda *a: (  # each score on another row
        lambda s, i: (s, i.roll(1, dims=1)))(*mk.topk_candidates_plain(*a)))
    with pytest.raises(AssertionError, match="topk_candidates .* disagrees"):
        chip_smoke.phase_mips_kernels(torch.device("cpu"), cases[:1])


def test_count_phase_checks_run_on_cpu(monkeypatch, capsys):
    """Phase 3's comparison at a tiny size, the kernel replaced by its plain
    version (the kernels have no CPU mode): the check passes, and a wrong
    kernel is caught."""
    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    monkeypatch.setattr(mk, "count_above_groups_kernel", mk.count_above_groups_plain)
    cases = ((16, 8192, 32), (5, 2048, 24))
    assert chip_smoke.phase_count(torch.device("cpu"), cases) == {"max_abs_err": 0.0}
    out = capsys.readouterr().out
    assert out.count("0 counts differ (max 0), 0 outside the") == 2
    monkeypatch.setattr(mk, "count_above_groups_kernel",
                        lambda *a: mk.count_above_groups_plain(*a) + 1)
    with pytest.raises(AssertionError, match="count kernel disagrees"):
        chip_smoke.phase_count(torch.device("cpu"), cases[:1])


@pytest.fixture(scope="module")
def retrieval_work(tmp_path_factory):
    """Phase 15 at a tiny width, run once up to its launch check: (work dir
    with its shards and questions, its output, the model overrides)."""
    work = tmp_path_factory.mktemp("retrieval_cli")
    extra = ["task.model.arch=tiny", "task.model.vocab_size=30522",
             "task.transform.max_seq_len=32"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_retrieval_cli(str(work), torch.device("cpu"), n_rows=2048,
                                       n_encoded=128, n_queries=16, extra=extra)
    return str(work), out.getvalue(), extra


def test_retrieval_cli_phase_runs_on_cpu_until_the_launch_check(retrieval_work):
    """Phase 15 at a tiny width: both CLIs, retrieve() with the other three
    methods, every method's JSON equal to the brute-force top-100, qa_eval
    equal to the recount; the count_above, count_above_groups and groupmax
    counters must rise."""
    _work, out, _extra = retrieval_work
    for method in ("groupmax", "auto", "fused", "approx", "exact_sort"):
        assert f"{method}: 16 queries, each top-100 equals the brute-force exact top-100" in out
    assert "equal to a recount with has_answers" in out
    assert ("retrieval-path launches: {'count_above': 0, 'count_above_groups': 0, "
            "'groupmax': 0, 'tile_max_scores': 0, 'topk_candidates': 0}") in out


def test_int_kernel_phase_checks_run_on_cpu(monkeypatch, capsys):
    """Phase 16's comparisons at a tiny size, each kernel replaced by its
    plain version: every check passes, and a wrong kernel is caught."""
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    for name in ("int_groupmax", "int8_tile_max"):
        monkeypatch.setattr(ik, f"{name}_kernel", getattr(ik, f"{name}_plain"))
    cases = ((5, 2048, 32, True, 1, False), (3, 1152, 20, False, 2, False),
             (7, 1024, 100, False, 1, False))
    entries = chip_smoke.phase_int_kernels(torch.device("cpu"), cases)
    assert set(entries) == {"int_groupmax", "int8_tile_max"}
    assert entries["int_groupmax"]["max_abs_err"] == 0.0
    assert capsys.readouterr().out.count("repeatable") == 4  # 3 group max, 1 tile max
    monkeypatch.setattr(ik, "int_groupmax_kernel", lambda *a, **k: (
        lambda v, r: (v.nextafter(v + 1), r))(*ik.int_groupmax_plain(*a, **k)))
    with pytest.raises(AssertionError, match="int_groupmax .* disagrees"):
        chip_smoke.phase_int_kernels(torch.device("cpu"), cases[:1])


def test_int_retrieval_phase_runs_on_cpu_until_the_launch_check(retrieval_work, capsys):
    """Phase 17 on phase 15's tiny shards: both CLI runs and both retrieve()
    runs equal the plain path's dequantised top-100, the rerank's scores the
    fp32 products; the int_groupmax counter must rise."""
    work, _out, extra = retrieval_work
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_int_retrieval(work, torch.device("cpu"), n_queries=16, extra=extra)
    out = capsys.readouterr().out
    for tag in ("int8", "int8_planes2", "int4"):
        assert f"{tag}: 16 queries, each top-100 equals the plain path's dequantised" in out
    assert "every reranked score equals fp32 q.row" in out
    for method in ("int8", "int4", "groupmax"):
        assert f"benchmark {method} over" in out
    assert "quantised-retrieval launches: {'int_groupmax': 0, 'int8_tile_max': 0}" in out


def test_checkpoint_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    """Phase 18 at a tiny width (fp32, dropout 0, lr 3e-3: a width-32 model
    learns the keyed data in 64 steps only so): the unbroken run, the run
    broken after its save at step 32 (in the middle of epoch 7) and resumed, the
    same batches, LRs and losses (bit for bit on the CPU), the restored state
    equal to the saved one, the export's top-100 equal to the in-memory
    model's, and the trained recall@10 above the seeded one's by the
    phase's margin; the four counters must rise."""
    extra = ["task.model.arch=tiny", "task.model.vocab_size=30522", "task.transform.max_seq_len=16",
             "task.model.hidden_size=32", "task.model.num_heads=2",
             "task.model.intermediate_size=64", "task.model.dtype=float32",
             "task.model.hidden_dropout=0.0", "task.model.attention_dropout=0.0",
             "task.optim.lr=3e-3", "task.warmup_steps=5"]
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_checkpoint(str(tmp_path), torch.device("cpu"), batch_size=12, steps=64,
                                    n_passages=60, n_questions=32, extra=extra)
    out = capsys.readouterr().out
    assert ("steps 33..64 after --resume at step 32 (epoch 6, batch 2): 0 batches and 0 LRs "
            "differ from the unbroken run's") in out
    assert "max relative drift 0.00e+00" in out
    assert "the restored state equals the saved one bit for bit" in out
    assert "equal the in-memory best model's" in out
    gain = float(re.search(r"recall@10 trained [\d.]+ vs seeded [\d.]+ \(gain ([-\d.]+)", out)[1])
    assert gain >= chip_smoke.RECALL_MARGIN
    assert ("checkpoint-path launches: {'attention_fwd': 0, 'attention_fwd_dropout': 0, "
            "'attention_bwd': 0, 'count_above_groups': 0}") in out


# phase 19 at a tiny width: fp32, so that the remat gate is exact on the CPU
_OWN_TINY = ["task.model.vocab_size=30522", "task.transform.max_seq_len=16",
             "task.model.hidden_size=32", "task.model.num_heads=2", "task.model.num_layers=2",
             "task.model.intermediate_size=64", "task.model.dtype=float32"]


def _tiny_own_data(work):
    tok_dir, _gold = chip_smoke.write_keyed_data(str(work), 32, 8, 8)
    return [f"task.transform.model_path={tok_dir}", f"datamodule.train_path={work}/train.jsonl",
            f"datamodule.val_path={work}/val.jsonl", f"datamodule.test_path={work}/val.jsonl",
            *_OWN_TINY]


def test_own_batch_phase_runs_on_cpu_until_the_launch_check(tmp_path, capsys):
    """Phase 19 at a tiny width: both gates pass, and every run of OWN_RUNS
    (its overrides, two steps at batch 8, 16 for ccnews_ict's 16 chunks)
    trains through cli.train with finite losses; the profiled run's trace
    exists; the counters of the GradCache and remat runs must rise."""
    runs = tuple((name, cfg, 16 if batch > 256 else 8, 2, overrides)
                 for name, cfg, batch, _steps, overrides in chip_smoke.OWN_RUNS)
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_own_batch(str(tmp_path), torch.device("cpu"), runs=runs,
                                   gate_batches=(8, 8), n_val=8, extra=_OWN_TINY)
    out = capsys.readouterr().out
    assert out.count("GradCache gate, 8 queries") == 2
    assert "remat gate, 8 queries + 16 contexts, dropout 0.1: loss" in out
    assert "(relative 0, tolerance 0.0001), gradient cosine 1.0000000" in out
    assert out.count("own batch, run ") == len(runs) + 1
    assert "the trace holds 0 device kernel events" in out
    assert ("own-batch launches: {'attention_fwd_dropout': 0, 'attention_bwd': 0, "
            "'ffn_fwd': 0}") in out


def test_own_batch_gates_fail_on_a_grad_cache_mismatch(tmp_path, monkeypatch):
    """A GradCache whose last chunk adds no gradient in phase 3 (its
    outputs scaled by 0) fails the GradCache gate: the loss still agrees,
    the cosine does not."""
    from dpr_scale_tpu_torch.train import task as task_mod

    data = _tiny_own_data(tmp_path)
    assert set(chip_smoke.check_grad_cache(data, torch.device("cpu"), 8)) == {2, 4}
    real = task_mod.grad_cache_grads

    def lossy(params, batch, rng, chunks, encode_chunk, loss_on_reprs):
        calls = []

        def enc(*args):
            q, c = encode_chunk(*args)
            calls.append(1)
            if len(calls) == 2 * chunks:  # phase 3's last chunk
                q, c = ({k: v * 0 for k, v in d.items()} for d in (q, c))
            return q, c

        return real(params, batch, rng, chunks, enc, loss_on_reprs)

    monkeypatch.setattr(task_mod, "grad_cache_grads", lossy)
    with pytest.raises(AssertionError, match="GradCache disagrees"):
        chip_smoke.check_grad_cache(data, torch.device("cpu"), 8)


def test_own_batch_gates_fail_on_a_remat_mask_mismatch(tmp_path, monkeypatch):
    """A recompute that draws other dropout masks than the forward did (each
    layer's third and later calls, after the two towers' forwards, on
    another fold) fails the remat gate."""
    from dpr_scale_tpu_torch.models import transformer

    data = _tiny_own_data(tmp_path)
    assert chip_smoke.check_remat(data, torch.device("cpu"), 8) == (0.0, pytest.approx(1.0))
    calls = {}

    def drifting(layer, x, attn_bias, rng, i):
        calls[layer] = calls.get(layer, 0) + 1
        shift = 0 if calls[layer] <= 2 else 1000
        return layer(x, attn_bias, transformer.fold(rng, i + shift))

    monkeypatch.setattr(transformer, "_run_layer", drifting)
    with pytest.raises(AssertionError, match="remat changes the step"):
        chip_smoke.check_remat(data, torch.device("cpu"), 8)
