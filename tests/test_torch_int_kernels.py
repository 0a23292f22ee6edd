"""The integer sweep kernels' plain versions (dpr_scale_tpu_torch.ops.int_kernels)
and the quantised index's quantisers, against the JAX side on the same numpy
inputs.

The two TPU kernels (``tools/microbench_int4_kernel.py``) are closures inside
the tool's ``main()``; their reference is restated here as the tool computes
it: the JAX index's ``_unpack_int4``, an int8 x int8 -> int32
``lax.dot_general``, the scaling of ``_i4_kernel`` and the max / argmax over
8-row groups (``:187-198``), or the max over 2,048-row tiles of
``xla_dot``. Integers and values must be equal exactly, -8 nibbles included
(the tool's random packed bytes hold them; the quantiser never makes them).
The JAX reference runs op by op, so XLA fuses nothing into an FMA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.index.mips import MipsIndex as JaxMipsIndex
from dpr_scale_tpu_torch.ops import int_kernels as ik
from dpr_scale_tpu_torch.index.mips import MipsIndex


def _inputs(B, N, D, packed, planes, seed):
    rng = np.random.default_rng(seed)
    W = D // 2 if packed else D
    q8 = rng.integers(-127, 128, size=(planes * B, D), dtype=np.int8)
    corpus = rng.integers(-128, 128, size=(N, W), dtype=np.int8)
    sc = rng.uniform(0.5, 1.5, size=N).astype(np.float32)
    qsc = rng.uniform(0.01, 0.1, size=B).astype(np.float32)
    return q8, corpus, sc, qsc


def _jax_scores(q8, corpus, sc, qsc, packed, planes):
    x8 = JaxMipsIndex._unpack_int4(jnp.asarray(corpus)) if packed else jnp.asarray(corpus)
    s32 = jax.lax.dot_general(x8, jnp.asarray(q8), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)  # (N, planes * B)
    sf = s32.astype(jnp.float32)
    B = qsc.shape[0]
    if planes == 2:
        sf = sf[:, :B] + sf[:, B:] * (1.0 / 127.0)
    return sf * jnp.asarray(sc)[:, None] * jnp.asarray(qsc)[None, :]


def _jax_groupmax(q8, corpus, sc, qsc, packed, planes):
    sf = _jax_scores(q8, corpus, sc, qsc, packed, planes)
    N, B = sf.shape
    t = sf.reshape(N // 8, 8, B)
    rows = (jnp.argmax(t, axis=1).astype(jnp.int32)
            + jax.lax.broadcasted_iota(jnp.int32, (N // 8, B), 0) * 8)
    return np.asarray(jnp.max(t, axis=1)), np.asarray(rows)


_CASES = [(5, 384, 100), (3, 256, 16), (1, 128, 768)]


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("B,N,D", _CASES)
def test_int_groupmax_plain_equals_the_tools_reference(B, N, D, packed, planes, monkeypatch):
    """Chunks of 128 rows: the plain version's chunk loop runs too."""
    monkeypatch.setattr(ik, "PLAIN_CHUNK_ROWS", 128)
    q8, corpus, sc, qsc = _inputs(B, N, D, packed, planes, B + N + D)
    want_v, want_r = _jax_groupmax(q8, corpus, sc, qsc, packed, planes)
    args = [torch.from_numpy(a) for a in (q8, corpus, sc, qsc)]
    vals, rows = ik.int_groupmax(*args, packed=packed, planes=planes)
    assert vals.dtype == torch.float32 and rows.dtype == torch.int32
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_array_equal(rows.numpy(), want_r)
    again, none = ik.int_groupmax(*args, packed=packed, planes=planes, want_rows=False)
    assert none is None and torch.equal(again, vals)


def test_int_groupmax_plain_takes_the_first_row_of_a_tie():
    """Groups of equal scores: the row is the group's first, as jnp.argmax."""
    q8 = np.ones((2, 16), np.int8)
    corpus = np.zeros((128, 16), np.int8)
    corpus[9] = corpus[12] = 3  # group 1: rows 9 and 12 tie at the max
    sc = np.ones(128, np.float32)
    qsc = np.ones(2, np.float32)
    vals, rows = ik.int_groupmax_plain(*(torch.from_numpy(a) for a in (q8, corpus, sc, qsc)),
                                       packed=False)
    want_v, want_r = _jax_groupmax(q8, corpus, sc, qsc, False, 1)
    np.testing.assert_array_equal(rows.numpy(), want_r)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    assert rows[1, 0] == 9 and rows[0, 0] == 0


@pytest.mark.parametrize("tile", [2048, 128, 300])
@pytest.mark.parametrize("B,D", [(5, 100), (2, 768)])
def test_int8_tile_max_plain_equals_the_tools_reference(B, D, tile):
    q8, corpus, _sc, _qsc = _inputs(B, 3 * tile, D, False, 1, tile + D)
    s32 = jax.lax.dot_general(jnp.asarray(corpus), jnp.asarray(q8), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    want = np.asarray(jnp.max(s32.reshape(3, tile, B), axis=1))
    got = ik.int8_tile_max(torch.from_numpy(q8), torch.from_numpy(corpus), tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_unpack_int4_equals_jax_on_every_byte():
    p = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(ik.unpack_int4(torch.from_numpy(p)).numpy(),
                                  np.asarray(JaxMipsIndex._unpack_int4(jnp.asarray(p))))
    assert MipsIndex._unpack_int4 is ik.unpack_int4


def test_plain_versions_refuse_what_they_cannot_take():
    q8, corpus, sc, qsc = (torch.from_numpy(a) for a in _inputs(4, 256, 64, True, 1, 0))
    with pytest.raises(ValueError, match="do not agree"):
        ik.int_groupmax(q8, corpus, sc, qsc, packed=False)
    with pytest.raises(ValueError, match="must divide"):
        ik.int_groupmax(q8, corpus[:200], sc[:200], qsc, packed=True)
    with pytest.raises(ValueError, match="planes"):
        ik.int_groupmax(q8, corpus, sc, qsc, packed=True, planes=3)
    with pytest.raises(ValueError, match="scales"):
        ik.int_groupmax(q8, corpus, sc[:10], qsc, packed=True)
    with pytest.raises(ValueError, match="int8"):
        ik.int8_tile_max(q8.float(), corpus, 128)


def _rows_with_zeros(rng, n, d):
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb[:, 3] = 0.0  # a zero column: scale 1
    emb[5] = 0.0  # a zero row: scale 1
    return emb


@pytest.mark.parametrize("which", ["_quantize_int8_host", "_quantize_int4_host"])
def test_host_quantisers_are_bit_equal_to_jax(which):
    rng = np.random.default_rng(7)
    for emb in (_rows_with_zeros(rng, 300, 48), rng.normal(size=(64, 768)).astype(np.float32) * 3):
        got = getattr(MipsIndex, which)(emb)
        want = getattr(JaxMipsIndex, which)(emb)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="even"):
        MipsIndex._quantize_int4_host(np.ones((4, 5), np.float32))


@pytest.mark.parametrize("planes", [1, 2])
def test_query_quantiser_is_bit_equal_to_the_jax_search(planes):
    """The lines of JAX ``_int8_search_impl`` that quantise the queries,
    under jit as there: XLA turns ``/ 127.0`` into a product with
    float32(1/127), which the port does too; the zero query gets scale 1."""
    rng = np.random.default_rng(planes)
    q = rng.normal(size=(9, 48)).astype(np.float32)
    q[4] = 0.0
    col = rng.uniform(0.5, 2.0, size=48).astype(np.float32)

    @jax.jit
    def jax_quantise(q, col):
        q = q * col[None, :]
        qsc = jnp.max(jnp.abs(q), axis=1) / 127.0
        qsc = jnp.where(qsc == 0.0, 1.0, qsc)
        qn = q / qsc[:, None]
        hi = jnp.clip(jnp.rint(qn), -127, 127)
        if planes == 2:
            lo = jnp.clip(jnp.rint((qn - hi) * 127.0), -127, 127)
            return jnp.concatenate([hi, lo]).astype(jnp.int8), qsc
        return hi.astype(jnp.int8), qsc

    want_q8, want_qsc = jax_quantise(q, col)
    got_q8, got_qsc = MipsIndex._quantize_queries(torch.from_numpy(q), torch.from_numpy(col),
                                                  planes)
    np.testing.assert_array_equal(got_q8.numpy(), np.asarray(want_q8))
    np.testing.assert_array_equal(got_qsc.numpy(), np.asarray(want_qsc))
    assert got_qsc[4] == 1.0
