"""The port's quantised MipsIndex tiers (``method="int8"`` / ``"int4"``) and
its host exact-rerank tier, against the JAX index on the same numpy inputs.

On the CPU the port runs the plain versions of its integer kernels, the JAX
index its single-device programs; there ``lax.approx_max_k`` is exact, so
both return the exact top-k of the same dequantised scores. One query plane:
equal scores bit for bit. Two planes: XLA's CPU compiler may contract JAX's
``sf_hi + sf_lo * (1/127)`` into a fused multiply-add where the port rounds
the product first, so the scores agree within rtol 1e-6 (a last-bit
difference). Dequantised scores tie often (on int4-grid data all the time)
and ``torch.topk`` breaks ties unlike ``lax.top_k``: rows must agree where a
score stands clear of the k-th, the rest only by score.
"""
import numpy as np
import pytest
import torch

import dpr_scale_tpu.index.mips as jax_mips
from dpr_scale_tpu.index.mips import MipsIndex as JaxMipsIndex
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu_torch.index import mips as port_mips
from dpr_scale_tpu_torch.index.mips import MipsIndex

TIERS = [("int8", 1), ("int8", 2), ("int4", 1), ("int4", 2)]
IDS = [f"{m}-planes{p}" for m, p in TIERS]


def _indexes(blocks, method, planes=1):
    port = MipsIndex("cpu", method=method)
    ref = JaxMipsIndex(get_mesh(1), method=method)
    for index in (port, ref):
        index.int8_query_planes = planes
        for b in blocks:
            index.add(b)
    return port, ref


def assert_same_topk(s, i, ws, wi, rtol=0.0):
    """Equal score lists (within rtol); every row scoring clear of the k-th
    on one side is on the other, with its score."""
    assert s.shape == ws.shape and i.shape == wi.shape and i.dtype == np.int64
    np.testing.assert_allclose(s, ws, rtol=rtol, atol=0)
    for row in range(s.shape[0]):
        kth = max(s[row, -1], ws[row, -1])
        clear = s[row] > kth + rtol * abs(kth)
        wclear = ws[row] > kth + rtol * abs(kth)
        got = dict(zip(i[row][clear].tolist(), s[row][clear].tolist()))
        want = dict(zip(wi[row][wclear].tolist(), ws[row][wclear].tolist()))
        assert got.keys() == want.keys(), row
        np.testing.assert_allclose([got[r] for r in got], [want[r] for r in got], rtol=rtol)


def _rtol(planes):
    return 1e-6 if planes == 2 else 0.0


@pytest.mark.parametrize("method,planes", TIERS, ids=IDS)
def test_two_unaligned_blocks_match_jax(method, planes):
    """1,100 and 2,000 rows (the JAX index pads them to 1,152 and 2,048, the
    port to 1,280 and 2,048), k = 20, D = 48."""
    rng = np.random.default_rng(0)
    blocks = [rng.normal(size=(n, 48)).astype(np.float32) for n in (1100, 2000)]
    queries = rng.normal(size=(6, 48)).astype(np.float32)
    port, ref = _indexes(blocks, method, planes)
    s, i = port.search(queries, k=20)
    rs, ri = ref.search(queries, k=20)
    assert s.dtype == np.float32
    assert_same_topk(s, i, rs, ri, _rtol(planes))
    # exact over the dequantised scores: the exact rescan agrees
    assert_same_topk(s, i, *_exact(port, queries, 20), 0.0)


def _exact(port, queries, k):
    """The chunked dequantised rescan of each block, merged."""
    q = torch.from_numpy(queries)
    per_s, per_i = [], []
    for emb, n_valid, offset in port._blocks:
        s, i = port._exact_topk(emb, n_valid, q, min(k, emb.shape[0]))
        per_s.append(s.numpy())
        per_i.append(np.where(i.numpy() >= 0, i.numpy() + offset, -1))
    return port_mips.merge_topk_batched(np.stack(per_s), np.stack(per_i), k)


@pytest.mark.parametrize("method,planes", TIERS, ids=IDS)
def test_negative_scores_never_return_pad_rows(method, planes):
    """Every real score negative: the zero-scoring pad rows must not win."""
    rng = np.random.default_rng(1)
    corpus = np.abs(rng.normal(size=(300, 16))).astype(np.float32)
    queries = -np.abs(rng.normal(size=(3, 16))).astype(np.float32)
    port, ref = _indexes([corpus], method, planes)
    s, i = port.search(queries, k=10)
    assert (s < 0).all() and (i >= 0).all() and (i < 300).all()
    assert_same_topk(s, i, *ref.search(queries, k=10), _rtol(planes))


def test_masked_rows_surface_as_minus_one():
    """A block of 5 rows searched at k = 8: three slots are pads, -1 and
    NEG_INF, as the JAX index returns them."""
    rng = np.random.default_rng(2)
    corpus = rng.normal(size=(5, 16)).astype(np.float32)
    queries = rng.normal(size=(4, 16)).astype(np.float32)
    for method in ("int8", "int4"):
        port, ref = _indexes([corpus], method)
        s, i = port.search(queries, k=8)
        rs, ri = ref.search(queries, k=8)
        assert (i[:, 5:] == -1).all() and (ri[:, 5:] == -1).all()
        np.testing.assert_array_equal(s[:, 5:], rs[:, 5:])
        assert_same_topk(s[:, :5], i[:, :5], rs[:, :5], ri[:, :5])


def test_int4_matches_jax_with_its_chunked_scan(monkeypatch):
    """The JAX int4 sweep scans INT4_CHUNK_ROWS rows at a time (its unpack
    temporary); the port's kernel needs no chunks. Small chunks on the JAX
    side, the tail chunk padded (1,152 = 4 x 256 + 128), the same results."""
    monkeypatch.setattr(jax_mips, "INT4_CHUNK_ROWS", 256)
    rng = np.random.default_rng(3)
    corpus = rng.normal(size=(1100, 32)).astype(np.float32)
    queries = rng.normal(size=(5, 32)).astype(np.float32)
    port, ref = _indexes([corpus], "int4")
    assert_same_topk(*port.search(queries, k=10), *ref.search(queries, k=10))


def _grid4_embeddings(rng, n, d):
    """tests/test_mips_int4.py's rows, exact under int4 quantisation."""
    ints = rng.integers(-7, 8, size=(n, d)).astype(np.float32)
    ints[np.arange(n), rng.integers(0, d, size=n)] = 7.0
    scales = rng.uniform(0.005, 0.05, size=(n, 1)).astype(np.float32)
    ints[0] = 7.0
    scales[0] = scales.max()
    return ints * scales


@pytest.mark.parametrize("method,planes", TIERS, ids=IDS)
def test_lossless_grid_data_ties_everywhere(method, planes):
    """int4-grid rows and int8-grid queries tie all the time: the same score
    lists and the same rows clear of the k-th; int4 is lossless there, so
    its top-k scores are numpy's exact ones."""
    rng = np.random.default_rng(40)
    corpus = _grid4_embeddings(rng, 3000, 32)
    ints = rng.integers(-127, 128, size=(9, 32)).astype(np.float32)
    ints[np.arange(9), rng.integers(0, 32, size=9)] = 127.0
    queries = ints * rng.uniform(0.005, 0.05, size=(9, 1)).astype(np.float32)
    port, ref = _indexes([corpus], method, planes)
    s, i = port.search(queries, k=11)
    assert_same_topk(s, i, *ref.search(queries, k=11), _rtol(planes))
    if method == "int4":
        exact = queries @ corpus.T
        np.testing.assert_allclose(s, -np.sort(-exact, axis=1)[:, :11], rtol=1e-4, atol=1e-6)


def test_selection_miss_is_caught_and_repaired(monkeypatch):
    """An undersized selection (a negative tier-1 slack): the soundness check
    fires and search() repairs through the exact dequantised rescan; the
    results stay the JAX index's."""
    rng = np.random.default_rng(23)
    corpus = rng.normal(size=(2000, 16)).astype(np.float32)
    queries = rng.normal(size=(8, 16)).astype(np.float32)
    monkeypatch.setattr(port_mips, "GMAX_T1_SLACK", -15)
    for method in ("int8", "int4"):
        port, ref = _indexes([corpus], method)
        emb, n_valid, _ = port._blocks[0]
        _s, _i, not_exact = port._int_search(emb, torch.from_numpy(queries), 20, n_valid)
        assert not_exact.any()
        s, i = port.search(queries, k=20)
        assert port.last_repair["queries_repaired"] == int(not_exact.sum()) > 0
        assert_same_topk(s, i, *ref.search(queries, k=20))
        assert_same_topk(s, i, *_exact(port, queries, 20))


@pytest.mark.parametrize("method", ["int8", "int4", "approx"])
def test_set_rerank_matches_jax(method):
    """The host rerank tier over 4x candidates: the same fp32 rescores of
    the same candidates, so bit-equal results; detached, the raw search."""
    rng = np.random.default_rng(46)
    corpus = rng.normal(size=(1024, 32)).astype(np.float32)
    queries = rng.normal(size=(8, 32)).astype(np.float32)
    port = MipsIndex("cpu", dtype=torch.float32 if method == "approx" else torch.bfloat16,
                     method=method)
    ref = JaxMipsIndex(get_mesh(1), method=method,
                       **({"dtype": np.float32} if method == "approx" else {}))
    fetched = []

    def rows_fn(ids):
        fetched.append(len(ids))
        return corpus[ids]

    for index in (port, ref):
        index.add(corpus)
        index.set_rerank(rows_fn, oversample=4)
    s, i = port.search(queries, k=8)
    n_port = fetched[-1]
    rs, ri = ref.search(queries, k=8)
    assert fetched[-1] == n_port <= 8 * 32
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(i, ri)
    exact = queries @ corpus.T
    np.testing.assert_allclose(s, -np.sort(-exact, axis=1)[:, :8], rtol=1e-5)
    port.set_rerank(None)
    raw, _ = port.search(queries, k=8)
    if method != "approx":
        assert not np.allclose(raw, s, rtol=1e-6)


def test_rerank_is_ignored_by_the_exact_methods():
    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(300, 8)).astype(np.float32)
    queries = rng.normal(size=(2, 8)).astype(np.float32)
    port = MipsIndex("cpu", dtype=torch.float32, method="groupmax")
    port.add(corpus)
    want = port.search(queries, k=5)
    port.set_rerank(lambda ids: pytest.fail("the exact methods take no rerank"), 4)
    got = port.search(queries, k=5)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("method", ["int8", "int4"])
def test_benchmark_reports_the_jax_keys(method):
    rng = np.random.default_rng(6)
    corpus = rng.normal(size=(1500, 16)).astype(np.float32)
    batches = rng.normal(size=(3, 4, 16)).astype(np.float32)
    port = MipsIndex("cpu", method=method)
    port.add(corpus)
    r = port.benchmark(batches, k=10)
    assert set(r) == {"seconds", "phase1_seconds", "qps", "all_exact", "fallback_queries",
                      "iters", "batch"}
    assert r["all_exact"] is False  # lossy, as the JAX index reports it
    assert (r["iters"], r["batch"]) == (3, 4) and r["fallback_queries"] >= 0
    assert r["qps"] > 0 and r["seconds"] >= r["phase1_seconds"] > 0


def test_tensor_blocks_and_queries():
    """A torch block and torch queries give what numpy ones give."""
    rng = np.random.default_rng(8)
    corpus = rng.normal(size=(700, 32)).astype(np.float32)
    queries = rng.normal(size=(5, 32)).astype(np.float32)
    a, b = MipsIndex("cpu", method="int4"), MipsIndex("cpu", method="int4")
    a.add(corpus)
    b.add(torch.from_numpy(corpus))
    sa, ia = a.search(queries, k=7)
    sb, ib = b.search(torch.from_numpy(queries), k=7)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(ia, ib)
