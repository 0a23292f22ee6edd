"""Pass 1 of the exact search, ``ops.mips_kernels.topk_candidates``, against JAX.

The JAX program's pass 1 is ``lax.approx_max_k`` of ``jnp.dot(q, c.T,
preferred_element_type=jnp.float32)``; on the CPU that top-k is exact, and
here it is ``lax.top_k`` of the same dot over the valid rows. The port's
plain version (the CPU path and the card kernel's oracle) must return the
same rows where the inputs have no ties (random normal), and the same
``{row: score}`` within 1e-5 relative where they do (integer-valued):
fp32 and bf16 blocks, rows past ``n_valid`` whose score 0 beats every real
(negative) score, fewer valid rows than kc (``NEG_INF`` / -1 entries), kc
of 100, 128 and 400, and blocks over several of the plain version's
chunks; the chunked merge it shares with a quantised block's scan. The
kernel's own steps run under the emulation
(``tests/test_torch_mips_emulated.py``) and on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.ops import mips_kernels as mk

import torch_threads  # noqa: F401  (one intra-op thread a worker)

REL = 1e-5


def _jax_topk(q, c, n_valid, kc, dtype):
    """JAX's pass-1 arithmetic over the valid rows: (scores, rows)."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    s = jnp.dot(jnp.asarray(q).astype(jd), jnp.asarray(c[:n_valid]).astype(jd).T,
                preferred_element_type=jnp.float32)
    ts, ti = jax.lax.top_k(s, min(kc, n_valid))
    return np.asarray(ts), np.asarray(ti)


def _inputs(B, N, D, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "int":  # ties abound
        return (rng.integers(-2, 3, size=(B, D)).astype(np.float32),
                rng.integers(-2, 3, size=(N, D)).astype(np.float32))
    q = rng.standard_normal((B, D)).astype(np.float32)
    c = rng.standard_normal((N, D)).astype(np.float32)
    if kind == "neg":  # every real score negative: the pad rows' 0 would win
        q, c = np.abs(q), -np.abs(c)
    return q, c


def _port(q, c, n_valid, kc, dtype):
    s, i = mk.topk_candidates(torch.from_numpy(q), torch.from_numpy(c).to(dtype), n_valid, kc)
    assert s.dtype == torch.float32 and i.dtype == torch.int64 and s.shape == i.shape == (
        q.shape[0], kc)
    return s.numpy(), i.numpy()


def _assert_missing_entries(s, i, n_valid, kc):
    """Entries past the valid rows are NEG_INF / -1; the rest real rows."""
    m = min(kc, n_valid)
    assert (s[:, m:] == mk.NEG_INF).all() and (i[:, m:] == -1).all()
    assert ((i[:, :m] >= 0) & (i[:, :m] < n_valid)).all()


# (B, N rows, D, n_valid, kc, dtype, kind): kc 128 and 100 on fp32 and bf16
# blocks with pad rows; kc 400 on a bf16 block; all-negative scores with
# pad rows past n_valid; fewer valid rows than kc
CASES = [
    (6, 1280, 24, 1100, 128, torch.float32, "normal"),
    (5, 2048, 32, 2000, 100, torch.bfloat16, "normal"),
    (4, 1024, 16, 1024, 400, torch.bfloat16, "normal"),
    (3, 768, 8, 700, 100, torch.float32, "neg"),
    (3, 512, 8, 300, 400, torch.bfloat16, "neg"),
    (4, 256, 16, 90, 128, torch.float32, "normal"),
]


@pytest.mark.parametrize("B,N,D,n_valid,kc,dtype,kind", CASES,
                         ids=[f"B{c[0]}-N{c[1]}-v{c[3]}-kc{c[4]}-{str(c[5])[6:]}-{c[6]}"
                              for c in CASES])
def test_plain_equals_jax_top_k_without_ties(B, N, D, n_valid, kc, dtype, kind):
    """The same rows in the same order, scores within REL; no pad row."""
    q, c = _inputs(B, N, D, kind, B + N + kc)
    s, i = _port(q, c, n_valid, kc, dtype)
    js, ji = _jax_topk(q, c, n_valid, kc, dtype)
    m = js.shape[1]
    np.testing.assert_array_equal(i[:, :m], ji)
    np.testing.assert_allclose(s[:, :m], js, rtol=REL, atol=REL)
    _assert_missing_entries(s, i, n_valid, kc)
    if kind == "neg":
        assert (s[:, :m] < 0).all()


def _score_map(s, i, m):
    return [dict(zip(i[b, :m].tolist(), s[b, :m].tolist())) for b in range(s.shape[0])]


@pytest.mark.parametrize("kc", [100, 128, 400])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_jax_top_k_with_ties(kc, dtype):
    """Integer-valued inputs: the same sorted scores; the rows strictly above
    the kc-th score the same {row: score}; every row at it a row of that
    score."""
    q, c = _inputs(5, 1536, 12, "int", kc)
    n_valid = 1500
    s, i = _port(q, c, n_valid, kc, dtype)
    js, ji = _jax_topk(q, c, n_valid, kc, dtype)
    np.testing.assert_allclose(s, js, rtol=REL)
    exact = q @ c.T
    for b, (got, want) in enumerate(zip(_score_map(s, i, kc), _score_map(js, ji, kc))):
        kth = s[b, -1]
        assert {r: v for r, v in got.items() if v > kth} == {
            r: v for r, v in want.items() if v > kth}
        assert len(got) == kc and all(exact[b, r] == v for r, v in got.items())
    assert (s[:, -1] == s[:, -2]).any()  # the boundary ties: the trap is live


def test_plain_merges_chunks(monkeypatch):
    """Blocks over several of the plain version's chunks (64 rows here):
    the cross-chunk merge keeps the JAX rows, and a chunk wholly past
    n_valid returns none."""
    monkeypatch.setattr(mk, "PLAIN_CHUNK_ROWS", 64)
    q, c = _inputs(4, 640, 16, "normal", 9)
    s, i = _port(q, c, 500, 100, torch.float32)
    js, ji = _jax_topk(q, c, 500, 100, torch.float32)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=REL, atol=REL)


def test_fewer_rows_than_kc_pads_to_kc():
    """A corpus of fewer rows than kc: kc columns, the missing NEG_INF / -1."""
    q, c = _inputs(2, 40, 8, "normal", 4)
    s, i = _port(q, c, 30, 128, torch.float32)
    js, ji = _jax_topk(q, c, 30, 128, torch.float32)
    np.testing.assert_array_equal(i[:, :30], ji)
    _assert_missing_entries(s, i, 30, 128)
    s0, i0 = _port(q, c, 0, 16, torch.float32)
    assert (s0 == mk.NEG_INF).all() and (i0 == -1).all()


def test_plain_casts_queries_to_the_corpus_dtype():
    """fp32 queries against a bf16 corpus score as bf16 queries (the JAX
    ``q.astype(self.dtype)``)."""
    q, c = _inputs(3, 512, 16, "normal", 5)
    cb = torch.from_numpy(c).bfloat16()
    a = mk.topk_candidates_plain(torch.from_numpy(q), cb, 512, 50)
    b = mk.topk_candidates_plain(torch.from_numpy(q).bfloat16(), cb, 512, 50)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_kernel_refuses_cpu_and_bad_arguments():
    q, c = (torch.zeros(2, 8, dtype=torch.bfloat16), torch.zeros(512, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        mk.topk_candidates_kernel(q, c, 512, 16)
    for bad in ((q, c, 513, 16), (q, c, 512, 0), (q[:, :4], c, 512, 16)):
        with pytest.raises(ValueError):
            mk.topk_candidates(*bad)


def _merge_inputs(B, N, seed, ties):
    rng = np.random.default_rng(seed)
    s = (rng.integers(-3, 4, size=(B, N)) if ties else rng.standard_normal((B, N)))
    return torch.from_numpy(s.astype(np.float32))


@pytest.mark.parametrize("N,n_valid,kc,chunk,ties", [
    (1000, 1000, 50, 128, False), (1000, 777, 50, 100, False), (300, 250, 400, 64, False),
    (1000, 900, 64, 1000, True), (640, 0, 8, 64, False),
])
def test_merge_chunk_topk_equals_one_topk(N, n_valid, kc, chunk, ties):
    """The chunked merge the plain version and a quantised block's scan
    share: one ``torch.topk`` over the valid columns, whatever the chunks
    (ragged, one, chunks wholly past n_valid), padded to kc with NEG_INF /
    -1 where fewer rows are valid; with ties, the same scores and the rows
    above the kc-th."""
    s = _merge_inputs(3, N, N + kc, ties)
    chunks = ((lo, min(lo + chunk, N), s[:, lo : lo + chunk].clone()) for lo in range(0, N, chunk))
    got_s, got_i = mk.merge_chunk_topk(chunks, n_valid, kc)
    m = min(kc, n_valid)
    assert got_s.shape == got_i.shape == (3, kc)
    want_s, want_i = torch.topk(s[:, :n_valid], m, dim=1)
    assert torch.equal(got_s[:, :m], want_s)
    if ties:
        for b in range(3):
            above = want_s[b] > want_s[b, -1]
            assert set(got_i[b][above].tolist()) == set(want_i[b][above].tolist())
            assert torch.equal(s[b, got_i[b]], got_s[b])
    else:
        assert torch.equal(got_i[:, :m], want_i)
    assert (got_s[:, m:] == mk.NEG_INF).all() and (got_i[:, m:] == -1).all()


@pytest.mark.parametrize("n_valid,kc,tile", [
    (2_097_152, 128, 4096), (2_097_152, 512, 1024), (65_536, 128, 256), (2_000_000, 128, 2048),
    (4096, 128, 256), (93_056, 128, 256), (300_000, 16, 4096),
])
def test_threshold_tile(n_valid, kc, tile):
    """The tile of the threshold's maxima: the largest of 256 .. 4,096 rows
    leaving 4 kc whole tiles (256 where none does)."""
    assert mk.topk_tile_rows(n_valid, kc) == tile


def _key(score, row):
    """topk_sweep.cu::topk_key in Python."""
    b = int(np.array(score, np.float32).view(np.int32))
    b = b if b >= 0 else b ^ 0x7FFFFFFF
    return (b << 32) | (~row & 0xFFFFFFFF)


def test_keys_order_and_decode():
    """The emit sweep's int64 keys order (score, row) pairs by score, then
    the smaller row, and decode to them; an empty slot is NEG_INF / -1."""
    pairs = [(3.5, 7), (3.5, 2), (-0.25, 0), (0.0, 9), (-1e20, 5), (1e-30, 1)]
    keys = torch.tensor([_key(s, r) for s, r in pairs] + [mk._KEY_EMPTY], dtype=torch.int64)
    order = torch.argsort(keys, descending=True).tolist()
    assert order == [1, 0, 5, 3, 2, 4, 6]
    scores, rows = mk._decode_keys(keys)
    assert scores.tolist() == [np.float32(s) for s, _ in pairs] + [np.float32(mk.NEG_INF)]
    assert rows.tolist() == [r for _, r in pairs] + [-1]
