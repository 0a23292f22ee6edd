"""Host-resident blocks of the port's MipsIndex (ROADMAP A1) against the JAX
index with ``host_resident=True`` on the 8-device CPU mesh of
tests/conftest.py, and the prequantised store (``index.store``) both ways.

On the CPU a streamed block is the host block's copy; the search then runs
the same plain kernels as a device block. fp32 blocks of random normal rows
have no ties, so their indices must be equal and their scores within
1e-5; the quantised tiers' dequantised scores tie, so those compare
``{row: score}`` of the rows clear of the k-th (rtol 0 at one query plane,
1e-6 at two), as tests/test_torch_int_mips.py does. The store files must
be byte-equal, and each package must load and serve the other's.
"""
import os
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_int_mips import assert_same_topk

from dpr_scale_tpu.index import store as jax_store
from dpr_scale_tpu.index.mips import MipsIndex as JaxMipsIndex
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu_torch.index import mips as port_mips
from dpr_scale_tpu_torch.index import store
from dpr_scale_tpu_torch.index.mips import HostBlock, MipsIndex

METHODS = ["fused", "groupmax", "auto", "approx", "exact_sort", "int8", "int4"]
D = 24


def _blocks(seed=0, sizes=(1100, 2000)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, D)).astype(np.float32) for n in sizes], \
        rng.normal(size=(6, D)).astype(np.float32)


def _same(method, got, want):
    (s, i), (ws, wi) = got, want
    if method in ("int8", "int4"):
        assert_same_topk(s, i, ws, wi)
    else:
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_allclose(s, ws, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_host_resident_search_equals_jax(method):
    """Two unaligned blocks, every one in host memory, k = 20: the port's
    streamed search equals the JAX host-resident index and the port's own
    device-resident one; no verification fails on either side."""
    blocks, queries = _blocks()
    port = MipsIndex("cpu", dtype=torch.float32, method=method, host_resident=True)
    resident = MipsIndex("cpu", dtype=torch.float32, method=method)
    ref = JaxMipsIndex(get_mesh(8), dtype=jnp.float32, method=method, host_resident=True)
    for b in blocks:
        for index in (port, resident, ref):
            index.add(b)
    assert all(isinstance(blk, HostBlock) for blk, _n, _o in port._blocks)
    got = port.search(queries, k=20)
    _same(method, got, ref.search(queries, k=20))
    _same(method, got, resident.search(queries, k=20))
    assert port.last_repair == ref.last_repair == {"block_fail_events": 0,
                                                   "queries_repaired": 0}


def test_streamed_blocks_take_the_exact_fallback(monkeypatch):
    """A streamed block whose verification fails is rescanned exactly on
    the device copy, and last_repair counts it as for a resident block."""
    rng = np.random.default_rng(14)
    n_planted = port_mips.RESCUE_GROUPS + 2
    corpus = rng.normal(size=(8 * 1024, 16)).astype(np.float32)
    v = rng.normal(size=(16,)).astype(np.float32)
    for j in range(n_planted + 4):
        corpus[j * 256] = v * (30 - j)
    queries = np.tile(v, (4, 1)).astype(np.float32)
    real = MipsIndex._candidates

    def drop_best(self, qd, emb, kc, n_valid):
        s, i = real(self, qd, emb, kc + n_planted, n_valid)
        return s[:, n_planted:], i[:, n_planted:]

    monkeypatch.setattr(MipsIndex, "_candidates", drop_best)
    port = MipsIndex("cpu", dtype=torch.float32, host_resident=True)
    port.add(corpus)
    s, i = port.search(queries, k=4)
    np.testing.assert_array_equal(i, np.tile(np.arange(4) * 256, (4, 1)))
    assert port.last_repair == {"block_fail_events": 4, "queries_repaired": 4}


@pytest.mark.parametrize("method", ["fused", "int8", "int4"])
def test_add_device_equals_jax(method):
    """``add_device`` of a padded block with ``n_valid`` rows: the pad rows
    zeroed (and, for the quantised tiers, the block quantised on the device
    with XLA's arithmetic), the same search as the JAX ``add_device``."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(3)
    block = rng.normal(size=(1024, D)).astype(np.float32)
    block[900:] = 5.0  # pad rows to be ignored
    queries = rng.normal(size=(5, D)).astype(np.float32)
    port = MipsIndex("cpu", dtype=torch.float32, method=method)
    port.add_device(torch.from_numpy(block), n_valid=900)
    mesh = get_mesh(8)
    ref = JaxMipsIndex(mesh, dtype=jnp.float32, method=method)
    ref.add_device(jax.device_put(block, NamedSharding(mesh, P("data", None))), n_valid=900)
    got, want = port.search(queries, k=10), ref.search(queries, k=10)
    _same(method, got, want)
    assert got[1].max() < 900
    if method != "fused":  # the quantised rows themselves
        rows = np.asarray(jax.device_get(ref._blocks[0][0]))
        np.testing.assert_array_equal(port._blocks[0][0].rows.numpy(), rows)


@pytest.mark.parametrize("method", ["int8", "int4"])
def test_quantized_builders_equal_jax(method):
    """``add_device_quantized`` / ``add_host_quantized`` (int8) and
    ``add_device_packed4`` / ``add_host_packed4`` (int4): a device block and
    a host block quantised on the host, with column scales and a ragged
    ``n_valid``, search as the JAX index's builders do; a builder of the
    other tier is refused."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(4)
    packed = method == "int4"
    quant = MipsIndex._quantize_int4_host if packed else MipsIndex._quantize_int8_host
    parts = [quant(rng.normal(size=(1024, D)).astype(np.float32)) for _ in range(2)]
    queries = rng.normal(size=(5, D)).astype(np.float32)
    port = MipsIndex("cpu", method=method)
    mesh = get_mesh(8)
    ref = JaxMipsIndex(mesh, method=method)
    dev_add, host_add = (("add_device_packed4", "add_host_packed4") if packed
                         else ("add_device_quantized", "add_host_quantized"))
    (q0, s0, c0), (q1, s1, c1) = parts
    getattr(port, dev_add)(torch.from_numpy(q0), torch.from_numpy(s0), n_valid=1000,
                           col_scales=torch.from_numpy(c0))
    getattr(port, host_add)(q1, s1, n_valid=700, col_scales=c1)
    row, rep = NamedSharding(mesh, P("data", None)), NamedSharding(mesh, P(None))
    getattr(ref, dev_add)(jax.device_put(q0, row), jax.device_put(s0, NamedSharding(mesh, P("data"))),
                          n_valid=1000, col_scales=jax.device_put(c0, rep))
    getattr(ref, host_add)(q1, s1, n_valid=700, col_scales=c1)
    assert isinstance(port._blocks[1][0], HostBlock) and port.num_rows == 1700
    _same(method, port.search(queries, k=15), ref.search(queries, k=15))
    other = "add_host_quantized" if packed else "add_host_packed4"
    with pytest.raises(ValueError, match="builder takes"):
        getattr(port, other)(q1, s1)


def _write_shards(d, seed=0):
    rng = np.random.default_rng(seed)
    embs = d / "embs"
    embs.mkdir()
    for i, n in enumerate((700, 1300, 150)):
        with open(embs / f"reps_{i:04}.pkl", "wb") as f:
            pickle.dump(rng.normal(size=(n, D)).astype(np.float32), f, protocol=4)
    return str(embs), rng.normal(size=(7, D)).astype(np.float32)


def test_store_is_byte_equal_to_jax_and_loads_both_ways(tmp_path):
    """Blocks of at most 1,000 rows re-chunked across three shards, padded
    to 1,024 (the JAX mesh's 8 x 128): every file of the port's store equals the JAX store's; a store
    of either package fills an index of the other (all blocks on the
    device, half of them streamed, all streamed) with the same answers."""
    embs, queries = _write_shards(tmp_path)
    mp = store.build_int8_store(embs, str(tmp_path / "port"), max_block_rows=1000,
                                pad_multiple=1024)
    mj = jax_store.build_int8_store(embs, str(tmp_path / "jax"), max_block_rows=1000,
                                   pad_multiple=1024)
    assert mp == mj and [b["n_valid"] for b in mp["blocks"]] == [1000, 1000, 150]
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    ref = JaxMipsIndex(get_mesh(8), method="int8")
    jax_store.load_int8_store(ref, str(tmp_path / "port"))
    want = ref.search(queries, k=12)
    for device_rows, host in ((None, False), (1024, False), (0, False), (None, True)):
        port = MipsIndex("cpu", method="int8", host_resident=host)
        store.load_int8_store(port, str(tmp_path / "jax"), device_rows=device_rows)
        streamed = [isinstance(b, HostBlock) for b, _n, _o in port._blocks]
        assert streamed == {None: [host] * 3, 1024: [False, True, True],
                            0: [True] * 3}[device_rows]
        _same("int8", port.search(queries, k=12), want)


def test_store_is_current_tracks_the_shards(tmp_path):
    """Both packages call a store current until a shard changes, and a
    manifest that is missing or unreadable is stale."""
    embs, _q = _write_shards(tmp_path)
    s = str(tmp_path / "store")
    assert not store.store_is_current(s, embs)
    store.build_int8_store(embs, s)
    assert store.store_is_current(s, embs) and jax_store.store_is_current(s, embs)
    with open(os.path.join(embs, "reps_0003.pkl"), "wb") as f:
        pickle.dump(np.zeros((3, D), np.float32), f, protocol=4)
    assert not store.store_is_current(s, embs) and not jax_store.store_is_current(s, embs)
    with pytest.raises(ValueError, match="int8"):
        store.load_int8_store(MipsIndex("cpu", method="int4"), s)
    with open(os.path.join(s, store.MANIFEST), "w") as f:
        f.write("{not json")
    assert not store.store_is_current(s, embs)


def test_build_index_from_a_store(tmp_path):
    """``build_index(index_store=...)`` builds the missing store, then
    serves from it; a current store is loaded, not rebuilt; a method other
    than int8 is refused, as in JAX."""
    from dpr_scale_tpu_torch.retrieve.retrieval import build_index

    embs, queries = _write_shards(tmp_path)
    s = str(tmp_path / "store")
    index = build_index(embs, "cpu", method="int8", index_store=s, device_rows=0)
    assert all(isinstance(b, HostBlock) for b, _n, _o in index._blocks)
    mtime = os.stat(os.path.join(s, store.MANIFEST)).st_mtime_ns
    again = build_index(embs, "cpu", method="int8", index_store=s)
    assert os.stat(os.path.join(s, store.MANIFEST)).st_mtime_ns == mtime
    # the store quantises the shards as one block (max_block_rows 2,000,000)
    direct = MipsIndex("cpu", method="int8")
    direct.add(np.concatenate([pickle.load(open(os.path.join(embs, n), "rb"))
                               for n in sorted(os.listdir(embs))]))
    _same("int8", index.search(queries, k=9), direct.search(queries, k=9))
    _same("int8", again.search(queries, k=9), direct.search(queries, k=9))
    with pytest.raises(ValueError, match="index_store requires mips_method=int8"):
        build_index(embs, "cpu", method="fused", index_store=s)


def test_a_read_only_memmap_uploads_without_a_warning(tmp_path):
    """A store's host tier is a read-only memmap: a host block built on it
    stays a view of it (no private copy at load), and its upload copies it
    without torch's non-writable warning."""
    q8 = np.arange(256 * 4, dtype=np.int8).reshape(256, 4)
    np.save(tmp_path / "q8.npy", q8)
    mm = np.load(tmp_path / "q8.npy", mmap_mode="r")
    index = MipsIndex("cpu", method="int8")
    index.add_host_quantized(mm, np.ones(256, np.float32))
    block = index._blocks[0][0]
    assert np.shares_memory(block.rows, mm)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dev = index._stream.take(index._stream.start(block), block)
    assert torch.equal(dev.rows, torch.from_numpy(q8))
