"""Port MipsIndex (dpr_scale_tpu_torch.index.mips) against the JAX index and numpy.

fp32 corpora on the CPU: the port's methods run the plain versions of their
kernels, the JAX ones their single-device mesh programs. Returned top-k must
be the exact numpy top-k, with identical indices on both sides (random
normal fp32 scores have no ties).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.index.mips import MipsIndex as JaxMipsIndex
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu_torch.index import mips as port_mips
from dpr_scale_tpu_torch.index.mips import MipsIndex, merge_topk_batched


def _np_topk(corpus, queries, k):
    s = queries @ corpus.T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


METHODS = ["fused", "groupmax", "auto", "approx", "exact_sort"]


def _indexes(blocks, method="fused"):
    port = MipsIndex("cpu", dtype=torch.float32, method=method)
    ref = JaxMipsIndex(get_mesh(1), dtype=jnp.float32, method=method)
    for b in blocks:
        port.add(b)
        ref.add(b)
    return port, ref


@pytest.mark.parametrize("method", METHODS)
def test_two_blocks_unaligned_rows_match_jax_and_numpy(method):
    """Block 0 has 1100 rows (pads to 1280: five 256-row groups); block 1
    has 2000 rows (pads to 2048: eight groups, the last one ending
    mid-group)."""
    rng = np.random.default_rng(0)
    blocks = [rng.normal(size=(n, 24)).astype(np.float32) for n in (1100, 2000)]
    queries = rng.normal(size=(6, 24)).astype(np.float32)
    port, ref = _indexes(blocks, method)
    s, i = port.search(queries, k=20)
    rs, ri = ref.search(queries, k=20)
    es, ei = _np_topk(np.concatenate(blocks), queries, 20)
    assert i.dtype == np.int64 and s.dtype == np.float32
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(s, es, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s, rs, rtol=1e-5, atol=1e-5)
    assert port.last_repair == {"block_fail_events": 0, "queries_repaired": 0}


def test_negative_scores_never_return_pad_rows():
    """All real scores negative: the zero pad rows would win without the
    analytic pad-count subtraction and the -1 masking."""
    _check_negative_scores("fused")


@pytest.mark.parametrize("method", [m for m in METHODS if m != "fused"])
def test_negative_scores_never_return_pad_rows_other_methods(method):
    """The same for the other methods: the pad-count subtraction of auto,
    the tail-group mask of groupmax, the -1 masking of all."""
    _check_negative_scores(method)


def _check_negative_scores(method):
    rng = np.random.default_rng(1)
    corpus = np.abs(rng.normal(size=(300, 8))).astype(np.float32)
    queries = -np.abs(rng.normal(size=(3, 8))).astype(np.float32)
    port, ref = _indexes([corpus], method)
    s, i = port.search(queries, k=10)
    es, ei = _np_topk(corpus, queries, 10)
    assert (s < 0).all()
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_array_equal(i, ref.search(queries, k=10)[1])
    if method in ("fused", "groupmax", "auto"):
        assert port.last_repair == ref.last_repair


def test_masked_rows_keep_minus_one_through_block_offset():
    """A block at global offset 1100 holding 5 rows (it ends mid-group),
    searched at k=8: three slots are masked pad rows and must stay -1 after
    the offset add, as in the JAX index."""
    rng = np.random.default_rng(2)
    blocks = [rng.normal(size=(n, 16)).astype(np.float32) for n in (1100, 5)]
    queries = rng.normal(size=(4, 16)).astype(np.float32)
    port, ref = _indexes(blocks)
    port._blocks, ref._blocks = port._blocks[1:], ref._blocks[1:]
    s, i = port.search(queries, k=8)
    rs, ri = ref.search(queries, k=8)
    np.testing.assert_array_equal(i, ri)
    assert (i[:, 5:] == -1).all()
    assert set(i[:, :5].ravel()) == set(range(1100, 1105))
    np.testing.assert_allclose(s[:, :5], rs[:, :5], rtol=1e-5)


def _drop_best_jax(n_drop):
    """approx_max_k that drops the n_drop best entries per query."""

    def fake(operand, k, **kwargs):
        kk = min(k + n_drop, operand.shape[-1])
        ts, ti = jax.lax.top_k(operand, kk)
        return ts[..., kk - k :], ti[..., kk - k :]

    return fake


def _drop_best_port(n_drop):
    """Pass 1 that drops the n_drop best candidates per query."""
    real = MipsIndex._candidates

    def fake(self, qd, emb, kc, n_valid):
        s, i = real(self, qd, emb, kc + n_drop, n_valid)
        return s[:, n_drop:], i[:, n_drop:]

    return fake


def test_missed_candidates_are_rescued(monkeypatch):
    """Pass 1 misses each query's best row: the group counts locate it and
    the whole-group rescue restores the exact top-k, with no fallback."""
    rng = np.random.default_rng(12)
    corpus = rng.normal(size=(4096, 16)).astype(np.float32)
    queries = rng.normal(size=(8, 16)).astype(np.float32)
    port, ref = _indexes([corpus])
    monkeypatch.setattr(MipsIndex, "_candidates", _drop_best_port(1))
    monkeypatch.setattr(jax.lax, "approx_max_k", _drop_best_jax(1))
    s, i, not_exact = port._fused_search(
        port._blocks[0][0], torch.from_numpy(queries), 10, 4096
    )
    assert not not_exact.any()
    es, ei = _np_topk(corpus, queries, 10)
    np.testing.assert_array_equal(i.numpy(), ei)
    np.testing.assert_allclose(s.numpy(), es, rtol=1e-5)
    s2, i2 = port.search(queries, k=10)
    np.testing.assert_array_equal(i2, ref.search(queries, k=10)[1])
    assert port.last_repair == {"block_fail_events": 0, "queries_repaired": 0}


def test_too_many_discrepant_groups_fall_back_to_exact(monkeypatch):
    """More discrepant groups per query than RESCUE_GROUPS: the query is
    flagged not-exact and the exact fallback repairs it; last_repair counts
    it on both sides."""
    rng = np.random.default_rng(14)
    n_planted = port_mips.RESCUE_GROUPS + 2
    corpus = rng.normal(size=(8 * 1024, 16)).astype(np.float32)
    v = rng.normal(size=(16,)).astype(np.float32)
    for j in range(n_planted + 4):  # the true top rows, one per group
        corpus[j * 256] = v * (30 - j)
    queries = np.tile(v, (4, 1)).astype(np.float32)
    port, ref = _indexes([corpus])
    monkeypatch.setattr(MipsIndex, "_candidates", _drop_best_port(n_planted))
    monkeypatch.setattr(jax.lax, "approx_max_k", _drop_best_jax(n_planted))
    s, i = port.search(queries, k=4)
    rs, ri = ref.search(queries, k=4)
    es, ei = _np_topk(corpus, queries, 4)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(s, es, rtol=2e-5)
    assert port.last_repair == {"block_fail_events": 4, "queries_repaired": 4}
    assert port.last_repair == ref.last_repair


def test_search_takes_tensors_and_bf16_blocks():
    rng = np.random.default_rng(3)
    corpus = rng.normal(size=(700, 32)).astype(np.float32)
    queries = rng.normal(size=(5, 32)).astype(np.float32)
    port = MipsIndex("cpu")  # bf16 corpus by default
    port.add(corpus)
    s, i = port.search(torch.from_numpy(queries), k=7)
    cb = torch.from_numpy(corpus).bfloat16().float().numpy()
    qb = torch.from_numpy(queries).bfloat16().float().numpy()
    es, ei = _np_topk(cb, qb, 7)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=1e-5, atol=1e-5)


def test_unported_methods_are_refused():
    """The quantised tiers are ported (tests/test_torch_int_mips.py holds
    them to JAX), and so are host-resident blocks (ROADMAP A1, which
    raised until then; tests/test_torch_host_resident.py holds them to
    JAX); only an unknown method is refused."""
    for method in ("int8", "int4"):
        assert MipsIndex("cpu", method=method).method == method
    assert MipsIndex("cpu", host_resident=True).host_resident
    assert MipsIndex("cpu", method="int8", host_resident=True).host_resident
    with pytest.raises(ValueError, match="unknown"):
        MipsIndex("cpu", method="sorted")


def test_groupmax_clustered_top_k_inside_one_group():
    """The whole true top-k inside ONE 8-row group: the whole-group rescore
    recovers all of it (the JAX test's case)."""
    rng = np.random.default_rng(22)
    corpus = rng.normal(size=(2048, 16)).astype(np.float32)
    v = rng.normal(size=(16,)).astype(np.float32)
    corpus[:8] = v[None, :] * np.linspace(20, 10, 8)[:, None]
    queries = np.tile(v, (4, 1)).astype(np.float32)
    port, ref = _indexes([corpus], "groupmax")
    s, i = port.search(queries, k=8)
    es, ei = _np_topk(corpus, queries, 8)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_array_equal(i, ref.search(queries, k=8)[1])
    np.testing.assert_allclose(s, es, rtol=2e-5)


def test_groupmax_selection_miss_is_caught_and_repaired(monkeypatch):
    """An undersized selection (a negative tier-1 slack on the port's module,
    as the JAX test forces on its own): the soundness check fires and
    search() repairs exactly, on the same queries as the JAX index."""
    import dpr_scale_tpu.index.mips as jax_mips

    rng = np.random.default_rng(23)
    corpus = rng.normal(size=(2000, 16)).astype(np.float32)
    queries = rng.normal(size=(8, 16)).astype(np.float32)
    monkeypatch.setattr(port_mips, "GMAX_T1_SLACK", -15)
    monkeypatch.setattr(jax_mips, "GMAX_T1_SLACK", -15)
    port, ref = _indexes([corpus], "groupmax")
    _s, _i, not_exact = port._groupmax_search(
        port._blocks[0][0], torch.from_numpy(queries), 20, 2000
    )
    assert not_exact.any()  # the check fires...
    s, i = port.search(queries, k=20)  # ...and search() repairs exactly
    es, ei = _np_topk(corpus, queries, 20)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=1e-5)
    rs, ri = ref.search(queries, k=20)
    np.testing.assert_array_equal(i, ri)
    assert port.last_repair["queries_repaired"] == int(not_exact.sum()) > 0
    assert port.last_repair == ref.last_repair


def test_auto_counts_match_true_counts_and_jax():
    """The auto verification's count (pads subtracted where tau < 0) equals
    the true count over the real rows and the JAX index's count."""
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(700, 8)).astype(np.float32)  # 324 pad rows
    queries = rng.normal(size=(5, 8)).astype(np.float32)
    port, ref = _indexes([corpus], "auto")
    tau = np.array([-3.0, -0.5, 0.0, 0.7, 2.5], np.float32)
    true = (queries @ corpus.T > tau[:, None]).sum(1)
    got = port._count_above(port._blocks[0][0], 700, torch.from_numpy(queries), torch.from_numpy(tau))
    want = ref._count_above(*ref._blocks[0][:2], jnp.asarray(queries), jnp.asarray(tau))
    np.testing.assert_array_equal(got.numpy(), true)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_auto_verification_failure_is_repaired(monkeypatch):
    """Pass 1 misses each query's best row: the whole-block count disagrees
    for every query, as the JAX verification finds, and the exact fallback
    repairs them. (The JAX search itself cannot be run here: its auto
    fallback assigns into the read-only ``np.asarray`` of a device array.)"""
    rng = np.random.default_rng(12)
    corpus = rng.normal(size=(4096, 16)).astype(np.float32)
    queries = rng.normal(size=(8, 16)).astype(np.float32)
    port, ref = _indexes([corpus], "auto")
    monkeypatch.setattr(MipsIndex, "_candidates", _drop_best_port(1))
    monkeypatch.setattr(jax.lax, "approx_max_k", _drop_best_jax(1))
    _s, _i, jax_fail = ref._verified_search_device(*ref._blocks[0][:2], jnp.asarray(queries), 10)
    _s, _i, port_fail = port._auto_search(port._blocks[0][0], torch.from_numpy(queries), 10, 4096)
    np.testing.assert_array_equal(port_fail.numpy(), np.asarray(jax_fail))
    assert port_fail.all()
    s, i = port.search(queries, k=10)
    es, ei = _np_topk(corpus, queries, 10)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=1e-5)
    assert port.last_repair == {"block_fail_events": 8, "queries_repaired": 8}


def test_approx_takes_max_4k_128_candidates(monkeypatch):
    """The approx pass asks pass 1 for max(4k, 128) candidates (JAX
    _approx_search_impl) and returns the exact top-k of them unverified."""
    seen = []
    real = MipsIndex._candidates

    def spy(self, qd, emb, kc, n_valid):
        seen.append(kc)
        return real(self, qd, emb, kc, n_valid)

    monkeypatch.setattr(MipsIndex, "_candidates", spy)
    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(3000, 8)).astype(np.float32)
    queries = rng.normal(size=(3, 8)).astype(np.float32)
    port = MipsIndex("cpu", dtype=torch.float32, method="approx")
    port.add(corpus)
    for k in (10, 50):
        s, i = port.search(queries, k=k)
        np.testing.assert_array_equal(i, _np_topk(corpus, queries, k)[1])
    assert seen == [128, 200]
    assert port.last_repair == {"block_fail_events": 0, "queries_repaired": 0}


@pytest.mark.parametrize("method", METHODS)
def test_benchmark_reports_the_jax_keys(method):
    rng = np.random.default_rng(6)
    corpus = rng.normal(size=(1500, 16)).astype(np.float32)
    batches = rng.normal(size=(3, 4, 16)).astype(np.float32)
    port = MipsIndex("cpu", dtype=torch.float32, method=method)
    port.add(corpus)
    r = port.benchmark(batches, k=10)
    assert set(r) == {"seconds", "phase1_seconds", "qps", "all_exact", "fallback_queries",
                      "iters", "batch"}
    assert r["all_exact"] == (method != "approx")
    assert (r["iters"], r["batch"], r["fallback_queries"]) == (3, 4, 0)
    assert r["qps"] > 0 and r["seconds"] >= r["phase1_seconds"] > 0
    port.add(corpus)
    with pytest.raises(ValueError, match="single block"):
        port.benchmark(batches, k=10)


def test_benchmark_counts_the_fallback_queries(monkeypatch):
    rng = np.random.default_rng(7)
    corpus = rng.normal(size=(2000, 16)).astype(np.float32)
    monkeypatch.setattr(port_mips, "GMAX_T1_SLACK", -15)
    port = MipsIndex("cpu", dtype=torch.float32, method="groupmax")
    port.add(corpus)
    batches = rng.normal(size=(2, 8, 16)).astype(np.float32)
    fails = sum(
        int(port._groupmax_search(port._blocks[0][0], torch.from_numpy(b), 20, 2000)[2].sum())
        for b in batches
    )
    r = port.benchmark(batches, k=20)
    assert r["fallback_queries"] == fails > 0 and r["all_exact"]


def test_merge_topk_batched():
    s = np.array([[[5.0, 1.0]], [[4.0, 3.0]]], np.float32)
    i = np.array([[[10, 11]], [[20, 21]]], np.int64)
    ms, mi = merge_topk_batched(s, i, 3)
    np.testing.assert_array_equal(ms, [[5.0, 4.0, 3.0]])
    np.testing.assert_array_equal(mi, [[10, 20, 21]])
