"""Port MIPS sweeps (dpr_scale_tpu_torch.ops.mips_kernels) against the JAX kernels.

The JAX kernels run in interpret mode at the JAX tests' shapes. Thresholds
sit at midpoints between adjacent sorted scores, so no score ties one and the
counts must be equal exactly; maxima agree within rtol 1e-4 / atol 1e-5 (the
same fp32 products summed in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.ops.mips_kernels import GMAX_TILE_ROWS, TILE_ROWS
from dpr_scale_tpu.ops.mips_kernels import count_above_groups_kernel as jax_count
from dpr_scale_tpu.ops.mips_kernels import count_above_kernel as jax_count_above
from dpr_scale_tpu.ops.mips_kernels import groupmax_kernel as jax_groupmax
from dpr_scale_tpu.ops.mips_kernels import tile_max_scores as jax_tile_max
from dpr_scale_tpu_torch.ops import mips_kernels as port


def _inputs(seed, B, N, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, D)).astype(np.float32)
    c = rng.normal(size=(N, D)).astype(np.float32)
    s = np.sort((q.astype(np.float64) @ c.T.astype(np.float64)), axis=1)
    return q, c, _midpoint_tau(s).astype(np.float32)


def _midpoint_tau(s, lo=0.5, hi=0.95):
    """Per row of sorted scores, the midpoint of the widest gap between
    ranks lo*N and hi*N: every score stays half that gap away from tau,
    far beyond fp32 summation-order noise."""
    N = s.shape[1]
    a, b = int(lo * N), int(hi * N)
    j = a + (s[:, a + 1 : b + 1] - s[:, a:b]).argmax(1)
    r = np.arange(s.shape[0])
    return (s[r, j] + s[r, j + 1]) / 2


@pytest.mark.parametrize("B,N,D", [(8, 4096, 16), (3, 2048, 40)])
def test_plain_matches_jax_kernel_group256(B, N, D):
    q, c, tau = _inputs(N + B, B, N, D)
    ref = np.asarray(
        jax_count(jnp.asarray(q), jnp.asarray(c), jnp.asarray(tau), interpret=True)
    )
    out = port.count_above_groups(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(tau), 256
    )
    assert out.dtype == torch.int32 and out.shape == (B, N // 256)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("N", [1152, 300])
def test_plain_single_group(N):
    """The fused index's single-group case (rows not a multiple of 256):
    the JAX pipeline counts with a plain dot there; so does numpy."""
    q, c, tau = _inputs(N, 5, N, 24)
    s = jnp.dot(jnp.asarray(q), jnp.asarray(c).T, preferred_element_type=jnp.float32)
    ref = np.asarray(jnp.sum((s > jnp.asarray(tau)[:, None]).astype(jnp.int32), axis=1))
    out = port.count_above_groups(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(tau), N
    )
    assert out.shape == (5, 1)
    np.testing.assert_array_equal(out.numpy()[:, 0], ref)
    np.testing.assert_array_equal(out.numpy()[:, 0], (q @ c.T > tau[:, None]).sum(1))


def test_plain_casts_queries_to_corpus_dtype():
    q, c, tau = _inputs(1, 4, 512, 32)
    qt, ct, tt = torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(tau)
    out = port.count_above_groups(qt, ct.bfloat16(), tt, 256)
    s = qt.bfloat16().float() @ ct.bfloat16().float().T
    ref = (s > tt[:, None]).view(4, 2, 256).sum(2)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_rejects_group_not_dividing_rows():
    q, c, tau = (torch.from_numpy(a) for a in _inputs(2, 2, 512, 8))
    with pytest.raises(ValueError, match="divide"):
        port.count_above_groups(q, c, tau, 384)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, c, tau = (torch.from_numpy(a) for a in _inputs(2, 2, 512, 8))
    with pytest.raises(ValueError, match="CUDA"):
        port.count_above_groups_kernel(q, c, tau, 256)


def test_constants_keep_their_jax_values():
    from dpr_scale_tpu.ops import mips_kernels as jax_mk

    for name in ("GROUP_ROWS", "GMAX_ROWS", "GMAX_TIER2", "TILE_ROWS"):
        assert getattr(port, name) == getattr(jax_mk, name), name


@pytest.mark.parametrize("B,N,D", [(8, 2 * TILE_ROWS, 128), (3, TILE_ROWS, 40)])
def test_count_above_plain_matches_jax_kernel(B, N, D):
    q, c, tau = _inputs(N + 7 * B, B, N, D)
    ref = np.asarray(
        jax_count_above(jnp.asarray(q), jnp.asarray(c), jnp.asarray(tau), interpret=True)
    )
    out = port.count_above(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(tau))
    assert out.dtype == torch.int32 and out.shape == (B,)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), (q @ c.T > tau[:, None]).sum(1))


def test_count_above_plain_takes_any_row_count():
    q, c, tau = _inputs(9, 4, 1000 + 77, 24)
    out = port.count_above(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(tau))
    np.testing.assert_array_equal(out.numpy(), (q @ c.T > tau[:, None]).sum(1))


@pytest.mark.parametrize("B,N,D", [(8, 2 * GMAX_TILE_ROWS, 128), (5, GMAX_TILE_ROWS, 24)])
def test_groupmax_plain_matches_jax_kernel(B, N, D):
    q, c, _tau = _inputs(N + B, B, N, D)
    r1, r2 = jax_groupmax(jnp.asarray(q), jnp.asarray(c), interpret=True)
    t1, t2 = port.groupmax(torch.from_numpy(q), torch.from_numpy(c))
    assert t1.shape == (N // 8, B) and t2.shape == (N // 128, B)
    assert t1.dtype == t2.dtype == torch.float32
    np.testing.assert_allclose(t1.numpy(), np.asarray(r1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), np.asarray(r2), rtol=1e-4, atol=1e-5)


def test_groupmax_plain_takes_rows_in_128s_across_chunks(monkeypatch):
    """Any N % 128 == 0 (the index pads to that), also when the plain
    version's chunks end inside a tier-2 group's span of t1."""
    monkeypatch.setattr(port, "PLAIN_CHUNK_ROWS", 384)
    q, c, _tau = _inputs(3, 6, 13 * 128, 16)
    t1, t2 = port.groupmax(torch.from_numpy(q), torch.from_numpy(c))
    s = q @ c.T
    e1 = s.reshape(6, -1, 8).max(2).T
    np.testing.assert_allclose(t1.numpy(), e1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), e1.reshape(13, 16, 6).max(1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,N,D", [(8, 2 * TILE_ROWS, 128), (2, 3 * TILE_ROWS, 16)])
def test_tile_max_plain_matches_jax_kernel(B, N, D):
    q, c, _tau = _inputs(N + 3 * B, B, N, D)
    ref = np.asarray(jax_tile_max(jnp.asarray(q), jnp.asarray(c), interpret=True))
    out = port.tile_max_scores(torch.from_numpy(q), torch.from_numpy(c))
    assert out.shape == (B, N // TILE_ROWS) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_tile_max_plain_takes_a_tile_argument():
    q, c, _tau = _inputs(4, 3, 900, 8)
    out = port.tile_max_scores(torch.from_numpy(q), torch.from_numpy(c), 300)
    np.testing.assert_allclose(out.numpy(), (q @ c.T).reshape(3, 3, 300).max(2), rtol=1e-5)


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float()


def test_scans_cast_queries_to_the_corpus_dtype():
    """fp32 queries over a bf16 corpus: the scores of the bf16-rounded
    queries against the bf16 rows, summed in fp32."""
    q, c, tau = _inputs(11, 4, 1024, 32)
    qt, ct, tt = torch.from_numpy(q), torch.from_numpy(c).bfloat16(), torch.from_numpy(tau)
    s = _bf16(q) @ _bf16(c).T
    np.testing.assert_array_equal(port.count_above(qt, ct, tt).numpy(),
                                  (s > tt[:, None]).sum(1).numpy())
    t1, t2 = port.groupmax(qt, ct)
    np.testing.assert_allclose(t1.numpy(), s.view(4, -1, 8).amax(2).T.numpy(), rtol=1e-6)
    np.testing.assert_allclose(t2.numpy(), s.view(4, -1, 128).amax(2).T.numpy(), rtol=1e-6)
    np.testing.assert_allclose(port.tile_max_scores(qt, ct, 512).numpy(),
                               s.view(4, 2, 512).amax(2).numpy(), rtol=1e-6)


def _scan_calls():
    q, c, tau = (torch.from_numpy(a) for a in _inputs(2, 3, 512, 8))
    return {
        "count_above": (port.count_above_kernel, (q, c, tau)),
        "groupmax": (port.groupmax_kernel, (q, c)),
        "tile_max_scores": (port.tile_max_scores_kernel, (q, c, 256)),
    }


@pytest.mark.parametrize("name", ["count_above", "groupmax", "tile_max_scores"])
def test_scan_kernel_wrappers_refuse_cpu_and_bad_inputs(name):
    kernel, args = _scan_calls()[name]
    q, c = args[:2]
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*args)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        kernel(q, c.half(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        kernel(q, c.T.contiguous().T, *args[2:])
    with pytest.raises(ValueError, match="do not agree"):
        kernel(q[:, :5], c, *args[2:])
    assert kernel.launches == 0


def test_scan_wrappers_refuse_rows_they_cannot_split():
    q, c, tau = (torch.from_numpy(a) for a in _inputs(3, 2, 1000, 8))
    with pytest.raises(ValueError, match="128 must divide"):
        port.groupmax_kernel(q, c)
    with pytest.raises(ValueError, match="128 must divide"):
        port.groupmax(q, c)
    with pytest.raises(ValueError, match="4096 must divide"):
        port.tile_max_scores(q, c)
    with pytest.raises(ValueError, match="thresholds"):
        port.count_above(q, c, tau[:1])


def test_dispatchers_refuse_other_devices():
    q = torch.zeros(2, 8, device="meta")
    c = torch.zeros(256, 8, device="meta")
    for call in (lambda: port.count_above(q, c, torch.zeros(2, device="meta")),
                 lambda: port.groupmax(q, c), lambda: port.tile_max_scores(q, c, 128),
                 lambda: port.count_above_groups(q, c, torch.zeros(2, device="meta"))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
