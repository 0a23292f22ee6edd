"""chip_smoke.py without a card: it refuses to run, and its slice phase runs
end to end on the CPU at a tiny size up to the launch-count check (the
kernels never launch on CPU tensors)."""
import contextlib
import io

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
    and pipelined CLI runs, each compared with the host run; the three
    gather-score counters must rise."""
    extra = ["task.model.arch=tiny", "task.model.vocab_size=30522",
             "task.transform.max_seq_len=32"]
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_citadel_cli(str(tmp_path), torch.device("cpu"), n_passages=48,
                                     n_queries=12, extra=extra)
    out = capsys.readouterr().out
    for what in ("fp32 device vs host", "fp32 device streamed vs host", "bf16 device vs host",
                 "bf16 pipelined vs bf16 serial"):
        assert f"{what}: 0 of 12 queries disagree" in out
    assert ("citadel-path launches: {'gather_score_serial': 0, 'gather_score_streamed': 0, "
            "'gather_score_pipelined': 0}") in out


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
    assert "citadel search launches: {'gather_score_serial': 0, 'gather_score_streamed': 0}" in out


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
    b = DeviceExpertIndex.from_host_index(host, dtype="float32", device="cpu").buckets[512]
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

    for name in ("count_above", "groupmax", "tile_max_scores"):
        monkeypatch.setattr(mk, f"{name}_kernel", getattr(mk, f"{name}_plain"))
    cases = ((16, 8192, 32, "bfloat16", 4096, False), (5, 2048, 20, "float32", 256, False),
             (3, 1152, 7, "bfloat16", 384, False))
    entries = chip_smoke.phase_mips_kernels(torch.device("cpu"), cases)
    assert set(entries) == {"count_above", "groupmax", "tile_max_scores"}
    out = capsys.readouterr().out
    assert out.count("repeatable") == 9 and "outside the check" in out
    monkeypatch.setattr(mk, "groupmax_kernel", lambda q, c: tuple(t + 1e-3 for t in mk.groupmax_plain(q, c)))
    with pytest.raises(AssertionError, match="groupmax .* disagrees"):
        chip_smoke.phase_mips_kernels(torch.device("cpu"), cases[:1])


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
    equal to the recount; the count_above and groupmax counters must rise."""
    _work, out, _extra = retrieval_work
    for method in ("groupmax", "auto", "fused", "approx", "exact_sort"):
        assert f"{method}: 16 queries, each top-100 equals the brute-force exact top-100" in out
    assert "equal to a recount with has_answers" in out
    assert "retrieval-path launches: {'count_above': 0, 'groupmax': 0}" in out


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
