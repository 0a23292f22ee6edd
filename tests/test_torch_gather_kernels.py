"""The port's posting gather-score plain versions against the JAX package's
three Pallas scorers, run in interpret mode on the CPU (patched as
tests/test_gather_kernels.py does), and the port's stream-decision helpers
against the JAX ones.

Inputs are made with numpy and handed to both. bf16 postings are the same
values on both sides (both round fp32 to nearest even). Tolerance: fp32
5e-5, bf16 5e-2 (atol and rtol), the JAX suite's own; the kernels
themselves are held to their plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 11).
"""
import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dpr_scale_tpu.index import inverted_device as jdev
from dpr_scale_tpu.index.inverted_device import DeviceExpertIndex as JaxDeviceIndex
from dpr_scale_tpu_torch.index import inverted_device as tdev
from dpr_scale_tpu_torch.ops import gather_score as gs

CASES = [
    # (n_experts, L, D, E, dtype) — tests/test_gather_kernels.py's CASES
    (6, 512, 256, 4, "float32"),
    (6, 256, 768, 3, "float32"),
    (9, 1024, 128, 9, "bfloat16"),
]
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _run_interpreted(fn, *args):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return fn(*args)
    finally:
        pl.pallas_call = orig


def _tol(dtype):
    return 5e-5 if dtype == "float32" else 5e-2


def _inputs(n_exp, L, D, E, seed):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n_exp, L, D)).astype(np.float32)
    slots = rng.permutation(n_exp)[:E].astype(np.int32)
    q = rng.standard_normal((E, D)).astype(np.float32)
    return vecs, slots, q


@pytest.mark.parametrize("scorer", ["serial", "pipelined"])
@pytest.mark.parametrize("n_exp,L,D,E,dtype", CASES)
def test_plain_scorer_matches_jax_kernel(scorer, n_exp, L, D, E, dtype):
    vecs, slots, q = _inputs(n_exp, L, D, E, n_exp * L + D)
    jfn = {"serial": JaxDeviceIndex._scores_pallas_serial,
           "pipelined": JaxDeviceIndex._scores_pallas}[scorer]
    want = np.asarray(_run_interpreted(
        jfn, jnp.asarray(vecs, _JAX[dtype]), jnp.asarray(slots), jnp.asarray(q)))
    fn = {"serial": gs.gather_score_serial, "pipelined": gs.gather_score_pipelined}[scorer]
    got = fn(torch.from_numpy(vecs).to(_TORCH[dtype]), torch.from_numpy(slots),
             torch.from_numpy(q))
    assert got.dtype == torch.float32 and got.shape == (E, L)
    np.testing.assert_allclose(got.numpy(), want, atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("n_exp,L,D,E,dtype", CASES)
def test_streamed_plain_scorer_matches_jax_kernel(n_exp, L, D, E, dtype):
    """The JAX streamed kernel over slot-sorted, padded entries with its own
    step table; pad entries (slot n_exp) score 0 on both sides."""
    vecs, _slots, q = _inputs(n_exp, L, D, E, 7 * L + D)
    rng = np.random.default_rng(D)
    slots = np.sort(rng.integers(0, n_exp, size=E)).astype(np.int32)  # repeats allowed
    itemsize = 4 if dtype == "float32" else 2
    G, _TL = jdev._stream_cfg(n_exp, L, D, itemsize)
    n_pad = jdev._pad_2bit(E, minimum=jdev.STREAM_M, multiple=jdev.STREAM_M)
    slots_p = np.full((n_pad,), n_exp, np.int32)
    slots_p[:E] = slots
    q_p = np.zeros((n_pad, D), np.float32)
    q_p[:E] = q
    steps = jdev._stream_steps(slots_p, E, n_pad, G)
    want = np.asarray(JaxDeviceIndex._scores_streamed(
        jnp.asarray(vecs, _JAX[dtype]), jnp.asarray(q_p), jnp.asarray(slots_p),
        jnp.asarray(steps)))
    got = gs.gather_score_streamed(torch.from_numpy(vecs).to(_TORCH[dtype]),
                                   torch.from_numpy(q_p), torch.from_numpy(slots_p))
    np.testing.assert_allclose(got.numpy(), want, atol=_tol(dtype), rtol=_tol(dtype))
    assert (got[E:] == 0).all()


def test_plain_scorer_rounds_q_to_the_postings_dtype():
    vecs, slots, q = _inputs(4, 64, 32, 3, 1)
    v = torch.from_numpy(vecs).bfloat16()
    got = gs.gather_score_plain(v, torch.from_numpy(slots), torch.from_numpy(q))
    qb = torch.from_numpy(q).bfloat16().double()
    want = torch.einsum("eld,ed->el", v[torch.from_numpy(slots).long()].double(), qb)
    torch.testing.assert_close(got.double(), want, atol=1e-4, rtol=1e-5)
    with pytest.raises(ValueError, match=r"\(E, D\)"):
        gs.gather_score_plain(v, torch.from_numpy(slots), torch.from_numpy(q[:, :8]))


@pytest.mark.parametrize("slots,cap,want", [
    ([], 4, [0]),
    ([3], 4, [0, 1]),
    ([0, 0, 0, 1, 2, 2], 4, [0, 3, 4, 6]),
    ([5] * 9 + [7], 4, [0, 4, 8, 9, 10]),
    ([1, 2, 3], 1, [0, 1, 2, 3]),
])
def test_stream_pieces_cut_runs_of_equal_slot(slots, cap, want):
    got = gs.stream_pieces(np.asarray(slots, np.int32), cap)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_stream_decision_helpers_equal_jax():
    """Over a grid of bucket shapes and routings both packages take the
    same per-bucket scorer decision."""
    for L, D, itemsize, n_exp in itertools.product(
        (128, 512, 2048, 8192, 32768, 131072), (32, 96, 128, 768), (2, 4), (1, 8, 64, 3000, 8000)
    ):
        assert tdev._stream_group_target(L, D, itemsize) == jdev._stream_group_target(L, D, itemsize)
        assert tdev._stream_cfg(n_exp, L, D, itemsize) == jdev._stream_cfg(n_exp, L, D, itemsize)
        assert tdev._stream_shape_ok(n_exp, L, D, itemsize) == jdev._stream_shape_ok(
            n_exp, L, D, itemsize)
    for n, m, mult in itertools.product((0, 1, 7, 33, 100, 2752, 10**6), (1, 8, 32), (1, 32)):
        assert tdev._pad_2bit(n, m, mult) == jdev._pad_2bit(n, m, mult)
    for n in (1, 128, 129, 600, 131072, 200000):
        assert tdev._bucket_for(n) == jdev._bucket_for(n)
    assert (tdev.STREAM_MODE, tdev.STREAM_M, tdev.STREAM_CHUNK, tdev.STREAM_BW_RATIO,
            tdev.STREAM_MIN_GROUP, tdev.BUCKET_SIZES) == (
        jdev.STREAM_MODE, jdev.STREAM_M, jdev.STREAM_CHUNK, jdev.STREAM_BW_RATIO,
        jdev.STREAM_MIN_GROUP, jdev.BUCKET_SIZES)

    rng = np.random.default_rng(0)
    decisions = set()
    for bsize, D, n_exp, n, spread in itertools.product(
        (128, 512, 2048), (32, 128), (512, 3000, 8000), (5, 256, 2752), (1, 64, None)
    ):
        if spread is None:
            slots = rng.integers(0, n_exp, size=n)
        else:
            slots = (rng.integers(0, spread, size=n) * 7) % n_exp
        # the JAX package's inline decision (inverted_device.py:1183-1203)
        want = jdev._stream_shape_ok(n_exp, bsize, D, 2)
        if want:
            G, TL = jdev._stream_cfg(n_exp, bsize, D, 2)
            n_pad = jdev._pad_2bit(n, minimum=jdev.STREAM_M, multiple=jdev.STREAM_M)
            padded = np.full((n_pad,), n_exp, np.int32)
            padded[:n] = np.sort(slots)
            want = jdev._stream_auto_wins(jdev._stream_steps(padded, n, n_pad, G), G, TL,
                                          bsize, D, 2, n)
        got = tdev._choose_stream(slots, n_exp, bsize, D, 2, capable=True)
        assert got == want, (bsize, D, n_exp, n, spread)
        decisions.add(got)
    assert decisions == {True, False}  # the grid reaches both scorers
