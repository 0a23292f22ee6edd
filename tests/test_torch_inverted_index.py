"""The port's inverted expert indexes against the JAX package's.

Encoder outputs come from the JAX MultiVecEncoder (tiny, fp32) as numpy and
feed both packages. The host index (numpy in both) must give equal results;
shards written by either package load in the other; the port's
DeviceExpertIndex on the CPU (fp32 postings, the kernels' plain versions)
must reproduce the JAX device index and the host search within 1e-4 (the
JAX suite's tolerance), compared as dense {doc: score} vectors over every
doc, since the two sorts break ties differently.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.index import inverted_device as jdev
from dpr_scale_tpu.index.inverted import InvertedExpertIndex as JaxHostIndex
from dpr_scale_tpu.models import TransformerConfig
from dpr_scale_tpu.models.multivec import MultiVecEncoder
from dpr_scale_tpu_torch.index import inverted_device as tdev
from dpr_scale_tpu_torch.index.inverted import InvertedExpertIndex, _ExpertPostings

CFG = dataclasses.replace(TransformerConfig.tiny(vocab_size=32), dtype=jnp.float32)
N_DOCS = 8


def _encode(variant, topk, add_cls=True, n_docs=N_DOCS, n_q=3):
    """(doc_out, q_out) numpy dicts from one set of params."""
    rng = np.random.default_rng(8)
    d_ids = jnp.asarray(rng.integers(5, 32, size=(n_docs, 12)), jnp.int32)
    q_ids = jnp.asarray(rng.integers(5, 32, size=(n_q, 8)), jnp.int32)
    model = MultiVecEncoder(CFG, variant=variant, tok_projection_dim=8,
                            cls_projection_dim=8 if add_cls else None)
    params = model.init(jax.random.PRNGKey(0), d_ids, jnp.ones_like(d_ids), topk=topk,
                        add_cls=add_cls)

    def enc(ids):
        out = model.apply(params, ids, jnp.ones_like(ids), topk=topk, add_cls=add_cls,
                          routing_stats=False)
        return {k: np.asarray(v) for k, v in out.items()}

    return enc(d_ids), enc(q_ids)


def _build(cls, doc_out, n_docs=N_DOCS, **finalize):
    index = cls(dim=8, num_docs=n_docs)
    index.add_batch(range(n_docs), doc_out, finalize.pop("weight_threshold", 0.0))
    index.finalize(**finalize)
    return index


def _dense(scores, rows, n_docs=N_DOCS):
    out = np.zeros((len(scores), n_docs), np.float32)
    for b in range(len(scores)):
        keep = rows[b] >= 0
        out[b, rows[b][keep]] = scores[b][keep]
    return out


@pytest.mark.parametrize("finalize", [{}, {"quantizer": "pq"}, {"weight_threshold": 0.2}])
@pytest.mark.parametrize("variant,topk", [("citadel", 2), ("coil", 1)])
def test_host_index_equals_jax(variant, topk, finalize):
    doc_out, q_out = _encode(variant, topk)
    port = _build(InvertedExpertIndex, doc_out, **dict(finalize))
    ref = _build(JaxHostIndex, doc_out, **dict(finalize))
    assert port.stats() == ref.stats()
    assert list(port.experts) == list(ref.experts)  # the same expert (slot) order
    for e, p in port.experts.items():
        r = ref.experts[e]
        for key in ("doc_ids", "weights", "vecs", "scale"):
            np.testing.assert_array_equal(getattr(p, key), getattr(r, key), err_msg=key)
    np.testing.assert_array_equal(port.cls, ref.cls)
    (s1, r1), (s2, r2) = port.search(q_out, topk=N_DOCS), ref.search(q_out, topk=N_DOCS)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(s1, s2)
    assert set(port.latency) == set(ref.latency)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_load_in_the_other_package(writer, tmp_path):
    """Two emission shards plus CLS planes, written by one package and
    loaded by the other (also with portion and expert_shards)."""
    doc_out, q_out = _encode("citadel", 2)
    halves = [{k: v[sl] for k, v in doc_out.items()} for sl in (slice(0, 4), slice(4, 8))]
    write_cls, read_cls = ((InvertedExpertIndex, JaxHostIndex) if writer == "port"
                           else (JaxHostIndex, InvertedExpertIndex))
    for shard, (rows, half) in enumerate(zip((range(0, 4), range(4, 8)), halves)):
        part = write_cls(dim=8, num_docs=4)
        part.add_batch(range(4), half)
        part.finalize()
        part.save(str(tmp_path), shard_id=shard)
    full = _build(read_cls, doc_out)
    loaded = read_cls.load(str(tmp_path), num_docs=N_DOCS)
    assert set(loaded.experts) == set(full.experts)
    for e, p in full.experts.items():
        np.testing.assert_array_equal(np.sort(loaded.experts[e].doc_ids % 4), np.sort(p.doc_ids % 4))
    np.testing.assert_array_equal(loaded.cls, full.cls)
    kw = dict(num_docs=N_DOCS, portion=0.5)
    a, b = InvertedExpertIndex.load(str(tmp_path), **kw), JaxHostIndex.load(str(tmp_path), **kw)
    assert a.stats() == b.stats() and a.stats()["num_postings"] < full.stats()["num_postings"]
    kw = dict(num_docs=N_DOCS, expert_shards=[1])
    a, b = InvertedExpertIndex.load(str(tmp_path), **kw), JaxHostIndex.load(str(tmp_path), **kw)
    assert a.stats() == b.stats()
    with pytest.raises(ValueError, match="cls shards cover"):
        InvertedExpertIndex.load(str(tmp_path), num_docs=N_DOCS + 1)


@pytest.mark.parametrize("stream", ["auto", "on"])
@pytest.mark.parametrize("combine", ["dense", "sorted"])
@pytest.mark.parametrize("variant,topk", [("citadel", 2), ("coil", 1)])
def test_device_index_equals_jax_and_host(variant, topk, combine, stream, monkeypatch):
    """dense: the CLS term and the dense accumulator; sorted: no CLS and
    sorted_combine_min_docs lowered to 0; STREAM_MODE on: slot-sorted
    entries through the streamed scorer (its plain version on the CPU, the
    Pallas kernel in interpret mode on the JAX side)."""
    monkeypatch.setattr(tdev, "STREAM_MODE", stream)
    monkeypatch.setattr(jdev, "STREAM_MODE", stream)
    doc_out, q_out = _encode(variant, topk, add_cls=combine == "dense")
    host = _build(InvertedExpertIndex, doc_out)
    port = tdev.DeviceExpertIndex.from_host_index(host, dtype="float32", device="cpu")
    ref = jdev.DeviceExpertIndex.from_host_index(_build(JaxHostIndex, doc_out), dtype=jnp.float32)
    if combine == "sorted":
        port.sorted_combine_min_docs = ref.sorted_combine_min_docs = 0
    want = _dense(*host.search(q_out, topk=N_DOCS))
    got = _dense(*port.search(q_out, topk=N_DOCS))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _dense(*ref.search(q_out, topk=N_DOCS)), rtol=1e-4,
                               atol=1e-4)
    scorers = {s for _b, _n, s, _shard in port.last_plan}
    assert scorers == ({"streamed"} if stream == "on" else {"serial"})
    assert port.latency["routing_time"] > 0 and port.latency["search_time"] > 0
    s2, r2 = port.search(q_out, topk=N_DOCS, as_numpy=False)
    assert isinstance(s2, torch.Tensor)
    np.testing.assert_allclose(_dense(s2.numpy(), r2.numpy()), got, rtol=1e-6)


def test_device_index_pipelined_switch_and_bf16(monkeypatch):
    """DPR_GATHER_KERNEL=pipelined picks the pipelined scorer (same
    results); bf16 postings stay within 1e-2 relative of the host search."""
    doc_out, q_out = _encode("citadel", 2)
    host = _build(InvertedExpertIndex, doc_out)
    want = _dense(*host.search(q_out, topk=N_DOCS))
    port = tdev.DeviceExpertIndex.from_host_index(host, dtype="float32", device="cpu")
    serial = _dense(*port.search(q_out, topk=N_DOCS))
    monkeypatch.setenv("DPR_GATHER_KERNEL", "pipelined")
    np.testing.assert_array_equal(_dense(*port.search(q_out, topk=N_DOCS)), serial)
    assert {s for _b, _n, s, _shard in port.last_plan} == {"pipelined"}
    bf16 = tdev.DeviceExpertIndex.from_host_index(host, dtype=torch.bfloat16, device="cpu")
    assert bf16.buckets[128]["shards"][0]["vecs"].dtype == torch.bfloat16
    got = _dense(*bf16.search(q_out, topk=N_DOCS))
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())


def test_device_index_bucket_layout_equals_jax():
    """Buckets, padded expert axis, run ids, run-compact docs and starts and
    the routing tables: the JAX package's layout."""
    rng = np.random.default_rng(3)
    num_docs, D = 500, 8
    host = InvertedExpertIndex(dim=D, num_docs=num_docs)
    jhost = JaxHostIndex(dim=D, num_docs=num_docs)
    for e, n in enumerate((3, 100, 129, 600, 40)):
        ids = rng.integers(0, num_docs, size=n).astype(np.int64)  # repeated docs: runs
        ws = rng.random(n).astype(np.float32)
        v = rng.normal(size=(n, D)).astype(np.float32)
        host.experts[e] = _ExpertPostings(ids, ws, v)
        jhost.experts[e] = _ExpertPostings(ids, ws, v)
    port = tdev.DeviceExpertIndex.from_host_index(host, dtype="float32", device="cpu")
    ref = jdev.DeviceExpertIndex.from_host_index(jhost, dtype=jnp.float32)
    assert set(port.buckets) == set(ref.buckets) == {128, 512, 2048}
    for bsize, b in port.buckets.items():
        r = ref.buckets[bsize]
        (shard,) = b["shards"]  # one device holds the whole bucket
        for key in ("vecs", "run_id", "run_doc", "start_pos"):
            np.testing.assert_array_equal(shard[key].numpy(), np.asarray(r[key]), err_msg=key)
        assert b["max_run_len"] == r["max_run_len"]
        assert dict(zip(b["experts"].tolist(), range(len(b["experts"])))) == r["slot_of"]
    np.testing.assert_array_equal(port._route_bsize, ref._route_bsize)
    np.testing.assert_array_equal(port._route_slot, ref._route_slot)


@pytest.mark.parametrize("num_docs", [100_000, 2**30])
def test_sorted_combine_last_row_pad_isolation(num_docs):
    """tests/test_inverted_index.py:324's case: pad entries (row == batch,
    real doc ids, value 0.0) must not reach the last row's top-k, and a row
    touching < k docs gets placeholder docs -1 with score 0. The port's key
    is int64 at any num_docs (2**30 is JAX's two-key branch)."""
    idx = tdev.DeviceExpertIndex(num_docs, device="cpu")
    batch, k = 2, 4
    rows = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 2, 2])
    docs = torch.tensor([10, 20, 30, 40, 50, 60, 7, 8, 11, 22, 33, 44])
    vals = torch.tensor([5.0, 4.0, 3.0, 2.0, 1.0, 0.5, -1.0, -2.0, 0.0, 0.0, 0.0, 0.0])
    s, d = idx._combine_updates_sorted(rows, docs, vals, batch, k)
    np.testing.assert_array_equal(d[0].numpy(), [10, 20, 30, 40])
    np.testing.assert_allclose(s[0].numpy(), [5.0, 4.0, 3.0, 2.0])
    assert set(d[1][:2].tolist()) == {7, 8}
    np.testing.assert_allclose(sorted(s[1][:2].tolist(), reverse=True), [-1.0, -2.0])
    np.testing.assert_array_equal(d[1][2:].numpy(), -1)
    np.testing.assert_allclose(s[1][2:].numpy(), 0.0)
    # the same updates through the JAX combine give the same rows
    js, jd = jax.jit(lambda r, dd, v: jdev.DeviceExpertIndex._combine_updates_sorted(
        idx, r, dd, v, batch, k, 1))(rows.numpy().astype(np.int32),
                                     docs.numpy().astype(np.int32), vals.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d.numpy())
    np.testing.assert_array_equal(np.asarray(js), s.numpy())


def test_sorted_combine_sums_duplicate_keys_and_handles_no_updates():
    idx = tdev.DeviceExpertIndex(1000, device="cpu")
    rows = torch.tensor([0, 0, 0, 1])
    docs = torch.tensor([5, 9, 5, 5])
    vals = torch.tensor([1.0, 1.5, 2.0, 0.25])
    s, d = idx._combine_updates_sorted(rows, docs, vals, 2, 2)
    np.testing.assert_array_equal(d.numpy(), [[5, 9], [5, -1]])
    np.testing.assert_allclose(s.numpy(), [[3.0, 1.5], [0.25, 0.0]])
    empty = torch.zeros(0, dtype=torch.int64)
    s, d = idx._combine_updates_sorted(empty, empty, torch.zeros(0), 2, 3)
    assert (d == -1).all() and (s == 0).all()


@pytest.mark.parametrize("N,k", [(5, 5), (2048, 100), (5000, 3), (5000, 100), (9000, 9000)])
def test_tiled_topk_equals_topk(N, k):
    """The tiled top-k, over the accumulator whole and cut into 3 column
    shards (its columns past N at -inf, as the dense combine leaves them),
    returns the values of torch.topk (ties among equal scores may pick
    other columns), and every returned column holds its score: with
    rounded scores many tie, and whole tiles tie at -inf."""
    rng = np.random.default_rng(N + k)
    acc = torch.from_numpy(np.round(rng.normal(size=(4, N)), 1).astype(np.float32))
    acc[1, : N // 2] = float("-inf")
    want = torch.topk(acc, k, dim=1).values
    for ndev in (1, 3):
        index = tdev.DeviceExpertIndex(N - 1, device="cpu", mesh=["cpu"] * ndev)
        grid = torch.nn.functional.pad(acc, (0, index._tiles()[1] - N), value=float("-inf"))
        s, cols = tdev._tiled_topk(list(grid.view(4, -1, tdev.TILE).chunk(ndev, dim=1)), k,
                                   torch.device("cpu"))
        torch.testing.assert_close(s, want, atol=0, rtol=0)
        torch.testing.assert_close(grid.gather(1, cols), s, atol=0, rtol=0)
        assert all(len(set(r.tolist())) == k for r in cols)
