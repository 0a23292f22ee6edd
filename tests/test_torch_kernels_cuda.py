"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode) and
skip without one. This file imports no jax, so it also runs where jax is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.ops import attention, mips_kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,nh,L,hd",
    [(4, 12, 40, 64), (2, 12, 256, 64), (2, 4, 512, 64), (3, 2, 33, 16),
     (8, 12, 16, 64), (8, 12, 32, 64), (4, 2, 1, 128), (4, 2, 48, 128),
     (3, 4, 63, 64), (3, 4, 65, 64), (2, 4, 129, 64), (2, 4, 255, 64), (2, 4, 257, 64),
     (2, 2, 511, 64), (3, 2, 65, 16), (2, 2, 257, 16), (3, 2, 63, 32), (2, 2, 129, 32),
     (2, 2, 511, 32)],
)
def test_attention_kernel_matches_plain(cuda_device, B, nh, L, hd):
    """bf16, ragged key masks: within 1e-2 + 1e-2 |ref| (two bf16 ulps at
    |x| ~ 1; the kernel and the plain version sum in different orders).
    Sequences shorter than head_dim (L = 1 .. 48 here) are the ones whose
    output tile is wider than their score tile; lengths one past or short of
    a 64-key tile (63, 65, 129, 255, 257, 511) exercise the tile tails."""
    g = torch.Generator(device=cuda_device).manual_seed(L)
    q, k, v = (
        torch.randn(B, nh, L, hd, generator=g, device=cuda_device).bfloat16()
        for _ in range(3)
    )
    lens = torch.randint(1, L + 1, (B,), generator=g, device=cuda_device)
    lens[0] = L
    bias = (torch.arange(L, device=cuda_device)[None, :] >= lens[:, None]).float() * -1e9
    bias = bias[:, None, :].contiguous()
    before = attention.attention_fwd_kernel.launches
    out = attention.fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert attention.attention_fwd_kernel.launches == before + 1
    ref = attention.attention_plain(q, k, v, bias)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
def test_attention_kernel_refuses_what_it_cannot_run(cuda_device):
    q = torch.zeros(1, 1, 600, 64, device=cuda_device, dtype=torch.bfloat16)
    bias = torch.zeros(1, 1, 600, device=cuda_device)
    with pytest.raises(ValueError, match="L <= 512"):
        attention.fused_attention(q, q, q, bias)
    with pytest.raises(ValueError, match="bf16"):
        attention.fused_attention(q.float(), q.float(), q.float(), bias)
    with pytest.raises(ValueError, match="bf16"):
        attention.attention_bwd_kernel(q.float(), q.float(), q.float(), bias, q.float())


def _attention_inputs(dev, B, nh, L, hd, seed, full_mask_row=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, go = (
        torch.randn(B, nh, L, hd, generator=g, device=dev).bfloat16() for _ in range(4)
    )
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    lens[0] = L
    bias = (torch.arange(L, device=dev)[None, :] >= lens[:, None]).float() * -1e9
    if full_mask_row:
        bias[-1] = -1e9  # every key of the last sequence dropped
    return q, k, v, bias[:, None, :].contiguous(), go


_LENGTHS = [1, 16, 32, 48, 63, 65, 129, 255, 256, 257, 511, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("L", _LENGTHS)
def test_attention_fwd_dropout_matches_plain(cuda_device, L, hd, rate):
    """The forward at rates 0 and 0.1, the same seed for kernel and plain
    (the same keep bits): within 1e-2 + 1e-2 |ref|, as at rate 0."""
    B, nh = (2, 2) if L >= 256 else (4, 3)
    q, k, v, bias, _ = _attention_inputs(cuda_device, B, nh, L, hd, L + hd)
    out = attention.attention_fwd_kernel(q, k, v, bias, 1234, rate)
    torch.cuda.synchronize()
    ref = attention.attention_plain(q, k, v, bias, 1234, rate)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


def _assert_grads_close(got, ref):
    """Each of dq, dk, dv within 2e-2 of its max |ref| everywhere: ds is
    rounded to bf16 at the same point in both, but from fp32 values summed
    in other orders, so single entries may round one bf16 ulp apart."""
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * scale + 1e-6, f"{name}: max err {err} vs max |ref| {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("L", _LENGTHS)
def test_attention_bwd_matches_plain(cuda_device, L, hd, rate):
    B, nh = (2, 2) if L >= 256 else (4, 3)
    q, k, v, bias, go = _attention_inputs(cuda_device, B, nh, L, hd, 7 * L + hd)
    before = attention.attention_bwd_kernel.launches
    got = attention.attention_bwd_kernel(q, k, v, bias, go, 99, rate)
    torch.cuda.synchronize()
    assert attention.attention_bwd_kernel.launches == before + 1
    _assert_grads_close(got, attention.attention_bwd_plain(q, k, v, bias, go, 99, rate))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_bwd_is_bitwise_repeatable(cuda_device, rate):
    """No floating-point atomics: two calls on the same inputs give the same
    dq, dk and dv bits."""
    q, k, v, bias, go = _attention_inputs(cuda_device, 8, 12, 256, 64, 17)
    first = attention.attention_bwd_kernel(q, k, v, bias, go, 7, rate)
    again = attention.attention_bwd_kernel(q, k, v, bias, go, 7, rate)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_fully_masked_row_is_finite_both_ways(cuda_device, rate):
    q, k, v, bias, go = _attention_inputs(cuda_device, 3, 2, 40, 64, 5, full_mask_row=True)
    out = attention.attention_fwd_kernel(q, k, v, bias, 3, rate)
    grads = attention.attention_bwd_kernel(q, k, v, bias, go, 3, rate)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), attention.attention_plain(q, k, v, bias, 3, rate).float(),
        atol=1e-2, rtol=1e-2,
    )
    _assert_grads_close(grads, attention.attention_bwd_plain(q, k, v, bias, go, 3, rate))


@pytest.mark.cuda
def test_fused_attention_autograd_launches_both_kernels(cuda_device):
    q, k, v, bias, go = _attention_inputs(cuda_device, 2, 12, 64, 64, 11)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fwd, bwd = attention.attention_fwd_kernel.launches, attention.attention_bwd_kernel.launches
    out = attention.fused_attention(q, k, v, bias, 5, 0.1)
    out.backward(go)
    torch.cuda.synchronize()
    assert attention.attention_fwd_kernel.launches == fwd + 1
    assert attention.attention_bwd_kernel.launches == bwd + 1
    ref = attention.attention_bwd_plain(q.detach(), k.detach(), v.detach(), bias, go, 5, 0.1)
    _assert_grads_close((q.grad, k.grad, v.grad), ref)


@pytest.mark.cuda
def test_attention_dropout_seed_repeats_and_varies(cuda_device):
    q, k, v, bias, _ = _attention_inputs(cuda_device, 2, 2, 64, 64, 13)
    a = attention.attention_fwd_kernel(q, k, v, bias, 21, 0.1)
    b = attention.attention_fwd_kernel(q, k, v, bias, 21, 0.1)
    c = attention.attention_fwd_kernel(q, k, v, bias, 22, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and not torch.equal(a, c)


def _midpoint_tau(s, lo=0.5, hi=0.95):
    """Per row of sorted scores, the midpoint of the widest gap between the
    ranks lo * N and hi * N (by default the 50th and 95th percentiles): no
    score lies near tau."""
    N = s.shape[1]
    a, b = int(lo * N), int(hi * N)
    j = a + (s[:, a + 1 : b + 1] - s[:, a:b]).argmax(1)
    r = np.arange(s.shape[0])
    return (s[r, j] + s[r, j + 1]) / 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,N,D,group", [(70, 8192, 768, 256), (5, 1152, 100, 1152), (1, 4096, 768, 256)]
)
def test_count_kernel_matches_plain(cuda_device, dtype, B, N, D, group):
    """Exact equality, thresholds at midpoints of the scores of the inputs
    as cast (far from any score, beyond fp32 summation-order noise)."""
    rng = np.random.default_rng(N + D)
    q, c = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device).to(dtype)
        for shape in ((B, D), (N, D))
    )
    s = torch.sort(q.double() @ c.double().T, dim=1).values.cpu().numpy()
    tau = torch.from_numpy(_midpoint_tau(s).astype(np.float32)).to(cuda_device)
    before = mips_kernels.count_above_groups_kernel.launches
    out = mips_kernels.count_above_groups(q, c, tau, group)
    torch.cuda.synchronize()
    assert mips_kernels.count_above_groups_kernel.launches == before + 1
    ref = mips_kernels.count_above_groups_plain(q, c, tau, group)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def _scan_inputs(dev, B, N, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).to(dtype)
        for shape in ((B, D), (N, D))
    )


_SCAN_CASES = [(B, D, dtype) for B in (1, 7, 64, 512) for D in (16, 100, 768)
               for dtype in (torch.bfloat16, torch.float32)]
_SCAN_IDS = [f"B{B}-D{D}-{str(t)[6:]}" for B, D, t in _SCAN_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,dtype", _SCAN_CASES, ids=_SCAN_IDS)
def test_count_above_kernel_matches_plain(cuda_device, B, D, dtype):
    """N = 3 spans of 2,048 rows + 77 (a ragged last tile): exact counts, the
    thresholds at midpoints of the scores of the inputs as cast."""
    q, c = _scan_inputs(cuda_device, B, 3 * 2048 + 77, D, dtype, B + D)
    s = torch.sort(q.double() @ c.double().T, dim=1).values.cpu().numpy()
    tau = torch.from_numpy(_midpoint_tau(s).astype(np.float32)).to(cuda_device)
    before = mips_kernels.count_above_kernel.launches
    out = mips_kernels.count_above(q, c, tau)
    torch.cuda.synchronize()
    assert mips_kernels.count_above_kernel.launches == before + 1
    torch.testing.assert_close(out, mips_kernels.count_above_plain(q, c, tau), atol=0, rtol=0)


def _sorted_scores(q, c):
    return torch.sort(q.double() @ c.double().T, dim=1).values.cpu().numpy()


# (B, N, lo, hi, group): D = 768 bf16 at the CLI's batch sizes over five
# 2,048-row spans (count_above: + 77 rows, a ragged last tile), a serving
# batch over three spans and a ragged one (count_above_groups: + 768 rows),
# thresholds between the 10th and 40th percentiles (negative: the rows past
# N, which score 0, would count) over a ragged span and query tile, and
# 1,152-row groups across tiles and spans
_WGMMA_COUNT_CASES = [(256, 5 * 2048, 0.5, 0.95, 256), (512, 5 * 2048, 0.5, 0.95, 256),
                      (64, 3 * 2048 + 768, 0.5, 0.95, 256), (130, 2048 + 768, 0.1, 0.4, 256),
                      (70, 4 * 1152, 0.5, 0.95, 1152)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,lo,hi,group", _WGMMA_COUNT_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-p{int(100 * c[2])}-g{c[4]}"
                              for c in _WGMMA_COUNT_CASES])
@pytest.mark.parametrize("name", ["count_above_groups", "count_above"])
def test_count_wgmma_route_equals_plain(cuda_device, name, B, N, lo, hi, group):
    """D = 768 bf16, thresholds at midpoints of the scores: the wgmma route,
    every count exactly equal to plain, the same bits again."""
    if name == "count_above":
        N = N // 256 * 256 + 77  # any N: a ragged last tile
    q, c = _scan_inputs(cuda_device, B, N, 768, torch.bfloat16, B + N)
    tau = torch.from_numpy(_midpoint_tau(_sorted_scores(q, c), lo, hi).astype(np.float32))
    tau = tau.to(cuda_device)
    if lo < 0.5:
        assert (tau < 0).all()
    kernel, plain = (getattr(mips_kernels, f"{name}_{kind}") for kind in ("kernel", "plain"))
    args = (q, c, tau) + ((group,) if name == "count_above_groups" else ())
    before = kernel.launches_by_route["wgmma"]
    out, again = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches_by_route["wgmma"] == before + 2
    torch.testing.assert_close(out, plain(*args), atol=0, rtol=0)
    assert torch.equal(out, again)


# (kernel, D, dtype, group, route); count_above has no groups (None)
_COUNT_ROUTES = [(name, D, dtype, None if name == "count_above" else 256, route)
                 for name in ("count_above_groups", "count_above")
                 for D, dtype, route in ((768, torch.bfloat16, "wgmma"),
                                         (100, torch.bfloat16, "wgmma_cp_async"),
                                         (101, torch.bfloat16, "score_tile"),
                                         (768, torch.float32, "score_tile"))] + [
    ("count_above_groups", 768, torch.bfloat16, 128, "wgmma"),
    ("count_above_groups", 768, torch.bfloat16, 1152, "wgmma"),
    ("count_above_groups", 768, torch.bfloat16, 192, "score_tile")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,D,dtype,group,route", _COUNT_ROUTES,
                         ids=[f"{c[0]}-D{c[1]}-{str(c[2])[6:]}-g{c[3]}" for c in _COUNT_ROUTES])
def test_count_route_follows_the_shape(cuda_device, name, D, dtype, group, route):
    """bf16 rows in groups of a multiple of 128 rows take the wgmma kernel,
    fed by TMA where it can address them, by cp.async at D = 100; D = 101,
    fp32 and other groups the score-tile kernel (count_above has no
    groups); each route counts its own launches."""
    q, c = _scan_inputs(cuda_device, 64, 2304, D, dtype, D + (group or 0))
    args = (q, c, torch.zeros(64, device=cuda_device)) + ((group,) if group else ())
    kernel = getattr(mips_kernels, f"{name}_kernel")
    before = dict(kernel.launches_by_route)
    kernel(*args)
    torch.cuda.synchronize()
    after = kernel.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in mips_kernels.ROUTES}


def _assert_max_close(name, got, want):
    """Maxima of the same fp32 products summed in another order: within 2e-5
    of max |ref| (the COUNT_MARGIN_REL bound)."""
    assert got.shape == want.shape and torch.isfinite(got).all(), name
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= 2e-5 * scale, f"{name}: max err {err} vs max |ref| {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,dtype", _SCAN_CASES, ids=_SCAN_IDS)
def test_groupmax_kernel_matches_plain(cuda_device, B, D, dtype):
    """N = 37 x 128 rows (the last 2,048-row span ragged); repeated calls
    give the same bits."""
    q, c = _scan_inputs(cuda_device, B, 37 * 128, D, dtype, 3 * B + D)
    before = mips_kernels.groupmax_kernel.launches
    t1, t2 = mips_kernels.groupmax(q, c)
    again = mips_kernels.groupmax(q, c)
    torch.cuda.synchronize()
    assert mips_kernels.groupmax_kernel.launches == before + 2
    r1, r2 = mips_kernels.groupmax_plain(q, c)
    _assert_max_close("t1", t1, r1)
    _assert_max_close("t2", t2, r2)
    assert torch.equal(t1, again[0]) and torch.equal(t2, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [256, 512])
def test_groupmax_wgmma_route_over_full_spans(cuda_device, B):
    """D = 768 bf16 over 5 spans of 2,048 rows + 640 (the last span ragged,
    its last 256-row tile half filled), at the CLI's batch sizes: the wgmma
    route, within 2e-5 of max |ref|, the same bits again."""
    q, c = _scan_inputs(cuda_device, B, 5 * 2048 + 640, 768, torch.bfloat16, B)
    before = dict(mips_kernels.groupmax_kernel.launches_by_route)
    t1, t2 = mips_kernels.groupmax(q, c)
    again = mips_kernels.groupmax(q, c)
    torch.cuda.synchronize()
    assert mips_kernels.groupmax_kernel.launches_by_route["wgmma"] == before["wgmma"] + 2
    r1, r2 = mips_kernels.groupmax_plain(q, c)
    _assert_max_close("t1", t1, r1)
    _assert_max_close("t2", t2, r2)
    assert torch.equal(t1, again[0]) and torch.equal(t2, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype,route", [(768, torch.bfloat16, "wgmma"),
                                           (100, torch.bfloat16, "wgmma_cp_async"),
                                           (101, torch.bfloat16, "score_tile"),
                                           (768, torch.float32, "score_tile")])
def test_groupmax_route_follows_the_shape(cuda_device, D, dtype, route):
    """TMA-addressable bf16 rows take the wgmma kernel fed by TMA, D = 100
    the same fed by cp.async, D = 101 and fp32 the score-tile kernel; each
    route counts its own launches."""
    q, c = _scan_inputs(cuda_device, 64, 256, D, dtype, D)
    before = dict(mips_kernels.groupmax_kernel.launches_by_route)
    mips_kernels.groupmax(q, c)
    torch.cuda.synchronize()
    after = mips_kernels.groupmax_kernel.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in mips_kernels.ROUTES}


@pytest.mark.cuda
@pytest.mark.parametrize("tile,n_tiles", [(4096, 3), (300, 5)])
@pytest.mark.parametrize("B,D,dtype", _SCAN_CASES, ids=_SCAN_IDS)
def test_tile_max_kernel_matches_plain(cuda_device, B, D, dtype, tile, n_tiles):
    """The default 4,096-row tile, and a 300-row tile that ends mid score tile."""
    q, c = _scan_inputs(cuda_device, B, tile * n_tiles, D, dtype, 5 * B + D)
    before = mips_kernels.tile_max_scores_kernel.launches
    out = mips_kernels.tile_max_scores(q, c, tile)
    torch.cuda.synchronize()
    assert mips_kernels.tile_max_scores_kernel.launches == before + 1
    _assert_max_close("tile max", out, mips_kernels.tile_max_scores_plain(q, c, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("B,tile,last_row", [(512, 4096, False), (64, 4096, False),
                                             (130, 256, True), (7, 4096, True)])
def test_tile_max_wgmma_route(cuda_device, B, tile, last_row):
    """D = 768 bf16 over 5 x 2,048 rows + the rest of a tile, at the
    retrieval batch, a serving batch, 256-row tiles (eight a block) and a
    ragged query tile; with ``last_row`` positive queries and each tile's
    last row all 3, so every maximum lies there: the wgmma route, within
    2e-5 of max |ref|, the same bits again."""
    N = (5 * 2048 // tile + 1) * tile
    q, c = _scan_inputs(cuda_device, B, N, 768, torch.float32, B + tile)
    if last_row:
        q, c[tile - 1 :: tile] = q.abs() + 0.1, 3.0
    q, c = q.bfloat16(), c.bfloat16()
    before = dict(mips_kernels.tile_max_scores_kernel.launches_by_route)
    out = mips_kernels.tile_max_scores(q, c, tile)
    again = mips_kernels.tile_max_scores(q, c, tile)
    torch.cuda.synchronize()
    assert mips_kernels.tile_max_scores_kernel.launches_by_route["wgmma"] == before["wgmma"] + 2
    want = mips_kernels.tile_max_scores_plain(q, c, tile)
    if last_row:
        assert torch.equal(want, q.float() @ c[tile - 1 :: tile].float().T)
    _assert_max_close("tile max", out, want)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype,tile,route", [(768, torch.bfloat16, 4096, "wgmma"),
                                                (768, torch.bfloat16, 256, "wgmma"),
                                                (768, torch.bfloat16, 300, "score_tile"),
                                                (100, torch.bfloat16, 4096, "wgmma_cp_async"),
                                                (101, torch.bfloat16, 4096, "score_tile"),
                                                (768, torch.float32, 4096, "score_tile")])
def test_tile_max_route_follows_the_shape(cuda_device, D, dtype, tile, route):
    """bf16 rows in tiles of whole 256-row units take the wgmma kernel (fed
    by TMA at D = 768, by cp.async at D = 100), other tiles, D = 101 and
    fp32 the score-tile kernel; each route counts its own launches."""
    q, c = _scan_inputs(cuda_device, 64, 2 * tile, D, dtype, D + tile)
    before = dict(mips_kernels.tile_max_scores_kernel.launches_by_route)
    mips_kernels.tile_max_scores(q, c, tile)
    torch.cuda.synchronize()
    after = mips_kernels.tile_max_scores_kernel.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in mips_kernels.ROUTES}


@pytest.mark.cuda
def test_scan_kernels_refuse_what_they_cannot_run(cuda_device):
    q = torch.zeros(4, 64, device=cuda_device, dtype=torch.bfloat16)
    c = torch.zeros(256, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        mips_kernels.groupmax_kernel(q.half(), c.half())
    with pytest.raises(ValueError, match="contiguous"):
        mips_kernels.count_above_kernel(q, c.T.contiguous().T, torch.zeros(4, device=cuda_device))
    with pytest.raises(ValueError, match="one CUDA device"):
        mips_kernels.tile_max_scores_kernel(q.cpu(), c, 128)


def _ffn_inputs(dev, N, H, F, seed):
    """bf16 x and bf16-cast weights at the model's scales (weights std 0.05)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape, s: (torch.randn(*shape, generator=g, device=dev) * s).bfloat16()  # noqa: E731
    return rn(N, H, s=1.0), rn(H, F, s=0.05), rn(F, s=0.05), rn(F, H, s=0.05), rn(H, s=0.05)


def _assert_rel_close(name, got, want, rel=1e-2):
    """max |err| within rel of max |ref| (bf16 outputs whose fp32 sums run
    in another order may round one ulp apart)."""
    assert torch.isfinite(got.float()).all(), name
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * scale, f"{name}: max err {err} vs max |ref| {scale}"


# ragged N, N one short of, at and one past the 128-row tile (and two
# tiles), both tile widths (BN = 128: H = 128; 256 elsewhere) and bert_base
_FFN_SHAPES = [(1, 128, 256), (200, 128, 256), (700, 256, 512), (4133, 768, 3072)] + [
    (N, H, F) for H, F in ((256, 512), (768, 3072)) for N in (127, 128, 129, 255, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N,H,F", _FFN_SHAPES)
def test_ffn_kernel_matches_plain(cuda_device, N, H, F, rate):
    """Ragged N (not a multiple of the 128-row tile): y and the saved pre
    within 1e-2 of max |ref|, and at rate 0.1 the same kept entries."""
    from dpr_scale_tpu_torch.ops import ffn

    args = _ffn_inputs(cuda_device, N, H, F, N + H)
    before = ffn.ffn_fwd_kernel.launches
    y, pre = ffn.ffn_fwd_kernel(*args, 4321, rate)
    torch.cuda.synchronize()
    assert ffn.ffn_fwd_kernel.launches == before + 1
    ref_y, ref_pre = ffn.ffn_fwd_plain(*args, 4321, rate)
    _assert_rel_close("y", y, ref_y)
    _assert_rel_close("pre", pre, ref_pre)
    if rate:
        assert torch.equal(y != 0, ref_y != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N,H,F", _FFN_SHAPES)
def test_ffn_ln_kernel_matches_plain(cuda_device, N, H, F, rate):
    from dpr_scale_tpu_torch.ops import ffn

    r, w1, b1, w2, b2 = _ffn_inputs(cuda_device, N, H, F, N + F)
    g = torch.Generator(device=cuda_device).manual_seed(N)
    lnp = [torch.randn(H, generator=g, device=cuda_device) * 0.1 + m for m in (1.0, 0.0, 1.0, 0.0)]
    before = ffn.ffn_ln_fwd_kernel.launches
    got = ffn.ffn_ln_fwd_kernel(r, w1, b1, w2, b2, *lnp, 99, rate, 1e-12)
    torch.cuda.synchronize()
    assert ffn.ffn_ln_fwd_kernel.launches == before + 1
    want = ffn.ffn_ln_fwd_plain(r, w1, b1, w2, b2, *lnp, 99, rate, 1e-12)
    for name, a, b in zip(("out", "x1", "pre", "z"), got, want):
        _assert_rel_close(name, a, b)
    if rate:
        assert torch.equal(got[3] != 0, want[3] != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_kernels_are_bitwise_repeatable(cuda_device, rate):
    """Each output tile's fp32 sums run in one fixed order (no atomics, no
    split K): two calls on the same inputs give the same bits."""
    from dpr_scale_tpu_torch.ops import ffn

    x, w1, b1, w2, b2 = _ffn_inputs(cuda_device, 1000, 768, 3072, 5)
    lnp = [torch.full((768,), m, device=cuda_device) for m in (1.0, 0.0, 1.0, 0.0)]
    first = ffn.ffn_fwd_kernel(x, w1, b1, w2, b2, 3, rate) + ffn.ffn_ln_fwd_kernel(
        x, w1, b1, w2, b2, *lnp, 3, rate)
    second = ffn.ffn_fwd_kernel(x, w1, b1, w2, b2, 3, rate) + ffn.ffn_ln_fwd_kernel(
        x, w1, b1, w2, b2, *lnp, 3, rate)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ffn_kernels_refuse_what_they_cannot_run(cuda_device):
    from dpr_scale_tpu_torch.ops import ffn

    x, w1, b1, w2, b2 = _ffn_inputs(cuda_device, 256, 128, 256, 1)
    with pytest.raises(ValueError, match="bf16"):
        ffn.ffn_fwd_kernel(x.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="bf16"):
        ffn.ffn_fwd_kernel(x, w1.float(), b1, w2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        ffn.ffn_fwd_kernel(x.view(128, 256).t(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        ffn.ffn_fwd_kernel(*(t.cpu() for t in (x, w1, b1, w2, b2)))
    small = _ffn_inputs(cuda_device, 16, 64, 256, 2)
    with pytest.raises(ValueError, match="multiples of 128"):
        ffn.ffn_fwd_kernel(*small)
    lnp = [torch.ones(128, device=cuda_device)] * 4
    with pytest.raises(ValueError, match="fp32"):
        ffn.ffn_ln_fwd_kernel(x, w1, b1, w2, b2, lnp[0].bfloat16(), *lnp[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ffn_autograd_on_card_matches_cpu(cuda_device, rate):
    """Through autograd on the card (the kernel forward, the plain backward
    with fp32-output GEMMs) against the same bf16 inputs on the CPU: y, dx
    and the fp32 weight and bias gradients within 2% of max |ref|."""
    from dpr_scale_tpu_torch.ops import ffn

    x, w1, b1, w2, b2 = _ffn_inputs(cuda_device, 300, 256, 512, 3)
    go = torch.randn(300, 256, device=cuda_device).bfloat16()
    params = [t.float() for t in (w1, b1, w2, b2)]

    def run(dev):
        xs = x.detach().to(dev).clone().requires_grad_()
        ps = [p.detach().to(dev).clone().requires_grad_() for p in params]
        y = ffn.fused_ffn(xs, *ps, 7, rate)
        y.backward(go.to(dev))
        return [y.detach()] + [t.grad for t in [xs] + ps]

    before = ffn.ffn_fwd_kernel.launches
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert ffn.ffn_fwd_kernel.launches == before + 1
    assert got[1].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[2:])
    for name, a, b in zip(("y", "dx", "dw1", "db1", "dw2", "db2"), got, run("cpu")):
        _assert_rel_close(name, a.cpu(), b, rel=2e-2)


def _gather_inputs(dev, n_exp, L, D, E, dtype, case, seed):
    """Postings, slots and queries of one bucket: entries spread over the
    experts, all on one expert, or with pad slots (n_exp) mixed in."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vecs = (torch.randn(n_exp, L, D, generator=g, device=dev) * 0.3).to(dtype)
    q = torch.randn(E, D, generator=g, device=dev)
    if case == "one_slot":
        slots = torch.full((E,), n_exp // 2, dtype=torch.int32, device=dev)
    else:
        slots = torch.randint(0, n_exp, (E,), generator=g, device=dev, dtype=torch.int32)
        if case == "pad":
            slots[::3] = n_exp
    return vecs, torch.sort(slots).values, q


_GATHER_SHAPES = [(40, 512, 32, 301), (9, 1024, 128, 9), (6, 256, 768, 3), (5, 2048, 32, 64),
                  (3, 131072, 32, 5), (7, 100, 7, 13), (4, 96, 100, 10)]


def _assert_scores_close(name, got, want):
    """max |err| within 1e-4 of max |ref|: both sides sum fp32 products of
    the same rounded operands, only in another order."""
    assert got.shape == want.shape and got.dtype == torch.float32, name
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * scale + 1e-30, f"{name}: max err {err} vs max |ref| {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spread", "one_slot", "pad"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_exp,L,D,E", _GATHER_SHAPES)
def test_gather_score_kernels_match_plain(cuda_device, n_exp, L, D, E, dtype, case):
    from dpr_scale_tpu_torch.ops import gather_score as gs

    vecs, slots, q = _gather_inputs(cuda_device, n_exp, L, D, E, dtype, case, L + D + E)
    want = gs.gather_score_plain(vecs, slots, q)
    for name, kernel, fn in (
        ("serial", gs.gather_score_serial_kernel, lambda: gs.gather_score_serial(vecs, slots, q)),
        ("pipelined", gs.gather_score_pipelined_kernel,
         lambda: gs.gather_score_pipelined(vecs, slots, q)),
        ("streamed", gs.gather_score_streamed_kernel,
         lambda: gs.gather_score_streamed(vecs, q, slots)),
    ):
        before = kernel.launches
        got = fn()
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, name
        _assert_scores_close(name, got, want)
    if case == "pad":
        assert (want[slots == n_exp] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spread", "one_slot", "pad"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_exp,L,D,E", _GATHER_SHAPES + [(16, 128, 32, 301), (4, 8192, 32, 9),
                                                          (16, 131072, 128, 13)])
def test_gather_pipelined_gives_the_serial_bits(cuda_device, n_exp, L, D, E, dtype, case):
    """The pipelined kernel takes the bulk-copy route where a row is a
    multiple of 16 bytes (else element copies), and on either route gives
    the serial kernel's scores bit for bit: the same lane split and sums.
    The last shape walks ~200 work items a block, where consumer groups
    sharing one ring once read stages before their copies had landed."""
    from dpr_scale_tpu_torch.ops import gather_score as gs

    vecs, slots, q = _gather_inputs(cuda_device, n_exp, L, D, E, dtype, case, 2 * L + D + E)
    route = "bulk_copy" if D * vecs.element_size() % 16 == 0 else "element_copy"
    before = dict(gs.gather_score_pipelined_kernel.launches_by_route)
    got = gs.gather_score_pipelined_kernel(vecs, slots, q)
    want = gs.gather_score_serial_kernel(vecs, slots, q)
    torch.cuda.synchronize()
    after = gs.gather_score_pipelined_kernel.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {k: int(k == route) for k in gs.PIPE_ROUTES}
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_gather_score_streamed_pieces_split_long_runs(cuda_device):
    """An expert hit by more entries than one piece holds, with the pieces
    passed from the host: the same scores as without them."""
    from dpr_scale_tpu_torch.ops import gather_score as gs

    vecs, slots, q = _gather_inputs(cuda_device, 8, 512, 32, 200, torch.bfloat16, "one_slot", 3)
    pieces = gs.stream_pieces(slots.cpu().numpy())
    assert len(pieces) - 1 == -(-200 // gs.STREAM_PIECE)
    _assert_scores_close("pieces", gs.gather_score_streamed(vecs, q, slots, pieces),
                         gs.gather_score_plain(vecs, slots, q))


@pytest.mark.cuda
def test_gather_score_kernels_refuse_what_they_cannot_run(cuda_device):
    from dpr_scale_tpu_torch.ops import gather_score as gs

    vecs, slots, q = _gather_inputs(cuda_device, 4, 64, 32, 5, torch.bfloat16, "spread", 1)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        gs.gather_score_serial_kernel(vecs.half(), slots, q)
    with pytest.raises(ValueError, match="CUDA"):
        gs.gather_score_pipelined_kernel(vecs.cpu(), slots.cpu(), q.cpu())
    with pytest.raises(ValueError, match=r"\(E, D\)"):
        gs.gather_score_streamed_kernel(vecs, q[:, :8], slots)
    with pytest.raises(ValueError, match="contiguous"):
        gs.gather_score_serial_kernel(vecs.transpose(1, 2), slots,
                                      torch.zeros(5, 64, device=cuda_device))
    wide = torch.zeros(2, 8, 300, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="limit"):
        gs.gather_score_serial_kernel(wide, slots[:2], torch.zeros(2, 300, device=cuda_device))


def _run_max_bucket(rng, n_exp, L, D, run_lens, fill=0.8):
    """One bucket in the index's layout: per expert, doc-sorted runs of the
    lengths ``run_lens`` draws over the first ``fill`` of the rows (zero pad
    rows after, joining the last run); (vecs fp32, run_id, run_doc,
    start_pos, max_run_len)."""
    vecs = np.zeros((n_exp, L, D), np.float32)
    run_id = np.zeros((n_exp, L), np.int32)
    starts_of, mrl = [], 1
    for s in range(n_exp):
        n = max(1, int(L * fill * rng.uniform(0.5, 1.0)))
        lens = rng.choice(run_lens, size=n)
        ends = np.cumsum(lens)
        lens = lens[: int(np.searchsorted(ends, n)) + 1]
        lens[-1] -= int(lens.sum()) - n
        rid = np.repeat(np.arange(len(lens)), lens)
        vecs[s, :n] = rng.standard_normal((n, D)) * 0.3
        run_id[s, :n], run_id[s, n:] = rid, rid[-1]
        starts_of.append(np.cumsum(lens) - lens)
        mrl = max(mrl, int(lens.max()))
    nr = max(len(x) for x in starts_of)
    R = min(L, max(8, 1 << (nr - 1).bit_length()))
    run_doc = np.full((n_exp, R), -1, np.int64)
    start_pos = np.zeros((n_exp, R), np.int64)
    for s, starts in enumerate(starts_of):
        run_doc[s, : len(starts)] = np.sort(rng.choice(10**6, len(starts), replace=False))
        start_pos[s, : len(starts)] = starts
    return vecs, run_id, run_doc, start_pos, mrl


def _run_max_parts(dev, seed, D, dtype, specs):
    """gather_run_max's parts and piece table for ``specs`` (L, experts,
    run lengths, entries, streamed); a streamed bucket's last entry sits on
    the pad slot n_exp."""
    from dpr_scale_tpu_torch.ops import gather_score as gs

    rng = np.random.default_rng(seed)
    parts, tables, n = [], [], 0
    for L, n_exp, run_lens, E, streamed in specs:
        vecs, run_id, run_doc, start_pos, mrl = _run_max_bucket(rng, n_exp, L, D, run_lens)
        bucket = {"vecs": torch.from_numpy(vecs).to(dev, dtype), "max_run_len": mrl,
                  "run_id": torch.from_numpy(run_id).to(dev),
                  "run_doc": torch.from_numpy(run_doc).to(dev),
                  "start_pos": torch.from_numpy(start_pos).to(dev)}
        slots = np.sort(rng.integers(0, n_exp, E))
        if streamed:
            slots[-1] = n_exp
        t = gs.run_max_table(slots, run_id[:, -1] + 1, streamed,
                             gs.run_max_piece_cap(D, bucket["vecs"].element_size()))
        q = torch.from_numpy(rng.standard_normal((E, D)).astype(np.float32)).to(dev, dtype)
        qrows = torch.from_numpy(rng.integers(0, 64, E).astype(np.int32)).to(dev)
        parts.append(gs.RunMaxPart(bucket, q, qrows, n, n + len(t),
                                   int((t[:, 1] - t[:, 0]).max()),
                                   "streamed" if streamed else "serial"))
        tables.append(t)
        n += len(t)
    return parts, torch.from_numpy(np.concatenate(tables)).to(dev)


# (D, dtype, buckets, route): phase 13's five bucket sizes in one launch
# (bf16 D = 32, runs across tile edges, two streamed buckets), D = 128 bf16
# and 32 fp32 with run 0 over many tiles, D = 100 bf16 (200-byte rows: the
# lanes' copies)
_RUN_MAX_CASES = [
    (32, torch.bfloat16, [(512, 40, (1, 1, 2, 3), 300, False), (2048, 12, (1, 2, 700), 60, True),
                          (8192, 6, (1, 1, 5), 20, False), (32768, 3, (1, 3), 5, True),
                          (131072, 2, (1, 2, 9), 3, False)], "bulk_copy"),
    (128, torch.bfloat16, [(128, 30, (1,), 100, True), (2048, 4, (300, 1), 9, False)],
     "bulk_copy"),
    (32, torch.float32, [(512, 9, (1, 2), 40, False), (8192, 3, (2000, 1), 5, True)],
     "bulk_copy"),
    (100, torch.bfloat16, [(512, 9, (1, 2, 40), 30, False), (2048, 4, (1, 3), 12, True)],
     "element_copy"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype,specs,route", _RUN_MAX_CASES,
                         ids=[f"D{c[0]}-{str(c[1])[6:]}-{c[3]}" for c in _RUN_MAX_CASES])
def test_gather_run_max_gives_the_per_bucket_bits(cuda_device, D, dtype, specs, route):
    """One launch over several buckets: its (rows, docs, vals) triples equal
    the per-bucket route's (the serial or streamed kernel, then the eager
    suffix max) bit for bit, and the plain version's vals within 1e-4 of
    their max; on the producer route its rows select."""
    from dpr_scale_tpu_torch.ops import gather_score as gs

    parts, table = _run_max_parts(cuda_device, D + len(specs), D, dtype, specs)
    before = dict(gs.gather_run_max_kernel.launches_by_route)
    got = gs.gather_run_max(parts, table)
    torch.cuda.synchronize()
    after = gs.gather_run_max_kernel.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {k: int(k == route)
                                                        for k in gs.RUN_MAX_ROUTES}
    want = []
    for part in parts:
        slots = gs._part_slots(part, table).to(torch.int32)
        if part.scorer == "streamed":
            scores = gs.gather_score_streamed(part.bucket["vecs"], part.q, slots)
        else:
            scores = gs.gather_score_serial(part.bucket["vecs"], slots, part.q)
        want.append(gs.run_max_epilogue(part.bucket, slots, scores, part.qrows))
    for j, name in enumerate(("rows", "docs", "vals")):
        assert torch.equal(got[j], torch.cat([w[j] for w in want])), name
    plain = gs.gather_run_max_plain(parts, table)
    _assert_scores_close("plain", got[2], plain[2])


@pytest.mark.cuda
def test_gather_run_max_refuses_what_it_cannot_run(cuda_device):
    from dpr_scale_tpu_torch.ops import gather_score as gs

    parts, table = _run_max_parts(cuda_device, 1, 32, torch.bfloat16,
                                  [(128, 4, (1,), 5, False)])
    with pytest.raises(ValueError, match="int32"):
        gs.gather_run_max_kernel(parts, table.long())
    with pytest.raises(ValueError, match="postings' dtype"):
        gs.gather_run_max_kernel([parts[0]._replace(q=parts[0].q.float())], table)
    with pytest.raises(ValueError, match="at most"):
        gs.gather_run_max_kernel(parts * (gs.RUN_MAX_BUCKETS + 1), table)
    # a largest piece past the stage's query rows, a range past the table
    cap = gs.run_max_piece_cap(32, 2)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        gs.gather_run_max_kernel([parts[0]._replace(max_piece=cap + 1)], table)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        gs.gather_run_max_kernel([parts[0]._replace(p1=table.shape[0] + 1)], table)


def _int_inputs(dev, B, N, D, packed, planes, seed):
    """Random int8 query planes, random corpus bytes (packed: every nibble,
    -8 included), row scales U(0.5, 1.5), query scales U(0.01, 0.1)."""
    rng = np.random.default_rng(seed)
    W = D // 2 if packed else D
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(planes * B, D), dtype=np.int8)).to(dev)
    c = torch.from_numpy(rng.integers(-128, 128, size=(N, W), dtype=np.int8)).to(dev)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, size=N).astype(np.float32)).to(dev)
    qsc = torch.from_numpy(rng.uniform(0.01, 0.1, size=B).astype(np.float32)).to(dev)
    return q8, c, sc, qsc


_INT_CASES = [(B, D) for B in (1, 7, 64, 130) for D in (16, 100, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("B,D", _INT_CASES, ids=[f"B{B}-D{D}" for B, D in _INT_CASES])
def test_int_groupmax_kernel_equals_plain(cuda_device, B, D, packed, planes):
    """N = 17 x 128 rows (the last 2,048-row span ragged): values and rows
    exactly equal to the plain version (both sum exactly and scale in one
    order), repeated calls the same bits, and without rows the same values."""
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    q8, c, sc, qsc = _int_inputs(cuda_device, B, 17 * 128, D, packed, planes, B + D + planes)
    before = ik.int_groupmax_kernel.launches
    vals, rows = ik.int_groupmax(q8, c, sc, qsc, packed=packed, planes=planes)
    again, _none = ik.int_groupmax(q8, c, sc, qsc, packed=packed, planes=planes, want_rows=False)
    torch.cuda.synchronize()
    assert ik.int_groupmax_kernel.launches == before + 2 and _none is None
    want_v, want_r = ik.int_groupmax_plain(q8, c, sc, qsc, packed=packed, planes=planes)
    assert torch.equal(vals, want_v) and torch.equal(rows, want_r)
    assert torch.equal(vals, again)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("B", [256, 512])
def test_int_groupmax_wgmma_route_over_full_spans(cuda_device, B, packed, planes):
    """D = 768 over 3 spans of 2,048 rows + 384 (the last span ragged): the
    wgmma route, values and rows exactly equal to plain, without rows the
    same values."""
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    q8, c, sc, qsc = _int_inputs(cuda_device, B, 3 * 2048 + 384, 768, packed, planes, B + planes)
    before = ik.int_groupmax_kernel.launches_by_route["wgmma"]
    vals, rows = ik.int_groupmax(q8, c, sc, qsc, packed=packed, planes=planes)
    bare, _none = ik.int_groupmax(q8, c, sc, qsc, packed=packed, planes=planes, want_rows=False)
    torch.cuda.synchronize()
    assert ik.int_groupmax_kernel.launches_by_route["wgmma"] == before + 2
    want_v, want_r = ik.int_groupmax_plain(q8, c, sc, qsc, packed=packed, planes=planes)
    assert torch.equal(vals, want_v) and torch.equal(rows, want_r)
    assert torch.equal(bare, want_v)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("B,D", [(9, 768), (130, 768), (9, 100)])
def test_int_groupmax_ties_go_to_the_first_row(cuda_device, B, D, packed, planes):
    """Every 8-row group repeats three of its rows (bytes and scale), so its
    maximum is held by two or three rows: both routes return the first, as
    jnp.argmax and the plain version do."""
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    q8, c, sc, qsc = _int_inputs(cuda_device, B, 2048 + 640, D, packed, planes, B + D)
    r = torch.arange(c.shape[0], device=cuda_device)
    src = r // 8 * 8 + r % 8 % 3
    c, sc = c[src].contiguous(), sc[src].contiguous()
    vals, rows = ik.int_groupmax(q8, c, sc, qsc, packed=packed, planes=planes)
    torch.cuda.synchronize()
    want_v, want_r = ik.int_groupmax_plain(q8, c, sc, qsc, packed=packed, planes=planes)
    assert torch.equal(vals, want_v) and torch.equal(rows, want_r)
    assert (rows % 8 < 3).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D,packed,route", [(768, False, "wgmma"), (768, True, "wgmma"),
                                            (100, False, "int_tile"), (48, True, "int_tile")])
def test_int_groupmax_route_follows_the_shape(cuda_device, D, packed, route):
    """Rows and queries TMA can address take the wgmma kernel; D = 100, and
    packed rows of 24 bytes, the int8-tile kernel; each route counts its own
    launches."""
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    q8, c, sc, qsc = _int_inputs(cuda_device, 64, 256, D, packed, 1, D)
    before = dict(ik.int_groupmax_kernel.launches_by_route)
    ik.int_groupmax(q8, c, sc, qsc, packed=packed)
    torch.cuda.synchronize()
    after = ik.int_groupmax_kernel.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {k: int(k == route) for k in ik.ROUTES}


@pytest.mark.cuda
@pytest.mark.parametrize("tile,n_tiles", [(2048, 3), (300, 5), (256, 9), (4096, 2)])
@pytest.mark.parametrize("B,D", _INT_CASES, ids=[f"B{B}-D{D}" for B, D in _INT_CASES])
def test_int8_tile_max_kernel_equals_plain(cuda_device, B, D, tile, n_tiles):
    """The tool's 2,048-row tile, a 300-row tile that ends mid score tile,
    256-row tiles (eight a block on the wgmma route, the last span of one)
    and 4,096-row tiles (a block walks two spans' worth of rows)."""
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    q8, c, _sc, _qsc = _int_inputs(cuda_device, B, tile * n_tiles, D, False, 1, 3 * B + D)
    before = ik.int8_tile_max_kernel.launches
    out = ik.int8_tile_max(q8, c, tile)
    torch.cuda.synchronize()
    assert ik.int8_tile_max_kernel.launches == before + 1
    assert torch.equal(out, ik.int8_tile_max_plain(q8, c, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("B,tile,kind", [(512, 2048, "rand"), (256, 2048, "neg"),
                                         (64, 2048, "last"), (130, 256, "last"),
                                         (7, 4096, "neg")])
def test_int8_tile_max_wgmma_route(cuda_device, B, tile, kind):
    """D = 768 over 5 x 2,048 rows + the rest of a tile, at the retrieval
    batch, the tool's batch, a serving batch, 256-row tiles (eight a block)
    and a ragged query tile; ``neg``: positive queries against negative
    rows (every maximum below 0), ``last``: positive queries and each
    tile's last row all 127 (every maximum there): the wgmma route, exactly
    the plain version, the same bits again."""
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    N = (5 * 2048 // tile + 1) * tile
    q8, c, _sc, _qsc = _int_inputs(cuda_device, B, N, 768, False, 1, B + tile)
    if kind != "rand":
        q8 = q8.abs().clamp(min=1)
    if kind == "neg":
        c = -(c.abs().clamp(min=1))
    if kind == "last":
        c[tile - 1 :: tile] = 127
    before = ik.int8_tile_max_kernel.launches_by_route["wgmma"]
    out = ik.int8_tile_max(q8, c, tile)
    again = ik.int8_tile_max(q8, c, tile)
    torch.cuda.synchronize()
    assert ik.int8_tile_max_kernel.launches_by_route["wgmma"] == before + 2
    want = ik.int8_tile_max_plain(q8, c, tile)
    if kind == "neg":
        assert (want < 0).all()
    if kind == "last":
        assert torch.equal(want, (c[tile - 1 :: tile].double() @ q8.double().T).int())
    assert torch.equal(out, want) and torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("D,tile,route", [(768, 2048, "wgmma"), (768, 256, "wgmma"),
                                          (768, 4096, "wgmma"), (768, 300, "int_tile"),
                                          (100, 2048, "int_tile")])
def test_int8_tile_max_route_follows_the_shape(cuda_device, D, tile, route):
    """TMA-addressable int8 rows in tiles of whole 256-row units take the
    wgmma kernel, a 300-row tile and D = 100 the int8-tile kernel; each
    route counts its own launches."""
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    q8, c, _sc, _qsc = _int_inputs(cuda_device, 64, 2 * tile, D, False, 1, D + tile)
    before = dict(ik.int8_tile_max_kernel.launches_by_route)
    ik.int8_tile_max(q8, c, tile)
    torch.cuda.synchronize()
    after = ik.int8_tile_max_kernel.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {k: int(k == route) for k in ik.ROUTES}


@pytest.mark.cuda
def test_int_kernels_refuse_what_they_cannot_run(cuda_device):
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    q8, c, sc, qsc = _int_inputs(cuda_device, 4, 256, 64, True, 1, 0)
    with pytest.raises(ValueError, match="int8"):
        ik.int_groupmax_kernel(q8.float(), c, sc, qsc, packed=True)
    with pytest.raises(ValueError, match="do not agree"):
        ik.int_groupmax_kernel(q8, c, sc, qsc, packed=False)
    with pytest.raises(ValueError, match="one CUDA device"):
        ik.int_groupmax_kernel(q8, c, sc.cpu(), qsc, packed=True)
    with pytest.raises(ValueError, match="fp32 scales"):
        ik.int_groupmax_kernel(q8, c, sc.double(), qsc, packed=True)
    with pytest.raises(ValueError, match="must divide"):
        ik.int8_tile_max_kernel(q8, c[:, :32].repeat(1, 2), 100)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["int8", "int4"])
@pytest.mark.parametrize("planes", [1, 2])
def test_quantised_search_launches_the_kernel_and_equals_plain(cuda_device, method, planes):
    """MipsIndex int8 / int4 on the card sweeps with int_groupmax_kernel and
    returns what the same index returns on the CPU (the plain versions):
    equal score lists, equal rows where the k-th and (k+1)-th differ."""
    from dpr_scale_tpu_torch.index.mips import MipsIndex
    from dpr_scale_tpu_torch.ops import int_kernels as ik

    rng = np.random.default_rng(planes)
    blocks = [rng.normal(size=(n, 96)).astype(np.float32) for n in (3000, 1100)]
    queries = rng.normal(size=(9, 96)).astype(np.float32)
    got, want = MipsIndex(cuda_device, method=method), MipsIndex("cpu", method=method)
    for index in (got, want):
        index.int8_query_planes = planes
        for b in blocks:
            index.add(b)
    before = ik.int_groupmax_kernel.launches
    s, i = got.search(queries, k=12)
    assert ik.int_groupmax_kernel.launches == before + 2
    ws, wi = want.search(queries, k=12)
    np.testing.assert_array_equal(s, ws)
    for row in range(len(queries)):
        above = s[row] > s[row, -1]  # rows tied with the k-th may differ
        assert set(i[row][above]) == set(wi[row][above])


def _wide_vectors(cuda_device, kind, n, D, g):
    x = torch.randn(n, D, generator=g, device=cuda_device)
    return torch.relu(x) * 2 + 0.1 * (x > 0) if kind == "dense_non_negative" else x


def _clear_counts_equal_plain(cuda_device, kind, D, route, seed):
    """count_above at D over 1,280 rows, B = 64: on ``route``, the counts
    equal plain wherever the threshold is clear of every score by twice
    COUNT_MARGIN_REL x |tau|."""
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    B, N, k, margin = 64, 1280, 100, 2e-5
    q = _wide_vectors(cuda_device, kind, B, D, g).to(torch.bfloat16)
    c = _wide_vectors(cuda_device, kind, N, D, g).to(torch.bfloat16)
    best = torch.topk(q.float() @ c.float().T, k + 1, dim=1).values
    tau = ((best[:, k - 1] + best[:, k]) / 2).contiguous()
    clear = (best[:, k - 1] - best[:, k]) > 2 * margin * tau.abs()
    before = dict(mips_kernels.count_above_kernel.launches_by_route)
    out = mips_kernels.count_above_kernel(q, c, tau)
    torch.cuda.synchronize()
    after = mips_kernels.count_above_kernel.launches_by_route
    assert {r: n - before[r] for r, n in after.items()} == {
        r: int(r == route) for r in mips_kernels.ROUTES}
    ref = mips_kernels.count_above_plain(q, c, tau)
    assert clear.sum() > B // 2 and (ref[clear] == k).all()
    torch.testing.assert_close(out[clear], ref[clear], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense_non_negative", "normal"])
def test_score_tile_counts_at_splade_width_equal_plain(cuda_device, kind):
    """D = 30,522 (SPLADE's vocab, even but not a multiple of 8: the wgmma
    route fed by cp.async, which promotes each 64-column stage into fp32
    adds past PROMOTE_D): the counts equal plain wherever the threshold is
    clear of every score by twice COUNT_MARGIN_REL x |tau|. Carried through
    the tensor cores over all of D, the sums drifted ~1e-4 of their size,
    one-sided, and every count of dense non-negative vectors differed."""
    _clear_counts_equal_plain(cuda_device, kind, 30522, "wgmma_cp_async", 5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense_non_negative", "normal"])
def test_score_tile_counts_at_odd_wide_d_equal_plain(cuda_device, kind):
    """D = 30,521 (odd: the score tile, which adds each 64-column stage into
    the running sum with fp32 adds): the same check."""
    _clear_counts_equal_plain(cuda_device, kind, 30521, "score_tile", 5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense_non_negative", "normal"])
@pytest.mark.parametrize("name", ["groupmax", "tile_max_scores"])
def test_maxima_at_splade_width_match_plain(cuda_device, name, kind):
    """D = 30,522 over 1,280 rows, B = 64, on the cp.async route: the 8-row
    group maxima (groupmax's t1) and the 256-row tile maxima within eight
    times plain's error from fp64 plus MAX_REL of the largest score (phase
    22 (a)'s bound at D = 30,528), t2 the maximum of its 16 t1 entries."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, N, D = 64, 1280, 30522
    q = _wide_vectors(cuda_device, kind, B, D, g).to(torch.bfloat16)
    c = _wide_vectors(cuda_device, kind, N, D, g).to(torch.bfloat16)
    exact = q.double() @ c.double().T
    kernel, plain = (getattr(mips_kernels, f"{name}_{part}") for part in ("kernel", "plain"))
    before = dict(kernel.launches_by_route)
    if name == "groupmax":
        (got, t2), (ref, _t2) = kernel(q, c), plain(q, c)
        got, ref, want = got.T, ref.T, exact.view(B, -1, 8).amax(2)
        assert torch.equal(t2, got.T.reshape(-1, 16, B).amax(1))
    else:
        got, ref, want = kernel(q, c, 256), plain(q, c, 256), exact.view(B, -1, 256).amax(2)
    torch.cuda.synchronize()
    after = kernel.launches_by_route
    assert {r: n - before[r] for r, n in after.items()} == {
        r: int(r == "wgmma_cp_async") for r in mips_kernels.ROUTES}
    assert got.shape == want.shape and torch.isfinite(got).all()
    err, err_plain = ((x.double() - want).abs().max().item() for x in (got, ref))
    assert err <= 8 * err_plain + 2e-5 * want.abs().max().item(), (err, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 130])
@pytest.mark.parametrize("kind", ["dense_non_negative", "normal"])
def test_wgmma_counts_at_wide_d_equal_plain(cuda_device, kind, B):
    """D = 30,528 (a multiple of 8: the wgmma route of gmax_sweep.cuh):
    count_above's counts, and count_above_groups' over 256-row groups,
    equal plain wherever the threshold is clear of every score by twice
    COUNT_MARGIN_REL x |tau|. Carried through the tensor cores over all of
    D, the sums drifted ~1e-4 of their size, one-sided, and 106 of 150
    clear counts of dense non-negative vectors were wrong; past PROMOTE_D
    each 64-column stage now adds into the running score with fp32 adds
    (B = 130: the QM = 64 layout that width takes at any batch)."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    N, D, k, margin = 1280, 30528, 100, 2e-5

    def make(n):
        x = torch.randn(n, D, generator=g, device=cuda_device)
        return torch.relu(x) * 2 + 0.1 * (x > 0) if kind == "dense_non_negative" else x

    q, c = make(B).to(torch.bfloat16), make(N).to(torch.bfloat16)
    exact = q.double() @ c.double().T
    best = torch.topk(exact, k + 1, dim=1).values
    tau = ((best[:, k - 1] + best[:, k]) / 2).float().contiguous()
    clear = (best[:, k - 1] - best[:, k]) > 2 * margin * tau.abs().double()
    # every group's count is clear where no score of the row lies near tau
    near = ((exact - tau.double()[:, None]).abs() <= 2 * margin * tau.abs().double()[:, None])
    before = (mips_kernels.count_above_kernel.launches_by_route["wgmma"],
              mips_kernels.count_above_groups_kernel.launches_by_route["wgmma"])
    out = mips_kernels.count_above_kernel(q, c, tau)
    groups = mips_kernels.count_above_groups_kernel(q, c, tau, 256)
    torch.cuda.synchronize()
    assert (mips_kernels.count_above_kernel.launches_by_route["wgmma"],
            mips_kernels.count_above_groups_kernel.launches_by_route["wgmma"]) == (
                before[0] + 1, before[1] + 1)
    ref = mips_kernels.count_above_plain(q, c, tau)
    assert clear.sum() > B // 2 and (ref[clear] == k).all()
    torch.testing.assert_close(out[clear], ref[clear], atol=0, rtol=0)
    ref_groups = mips_kernels.count_above_groups_plain(q, c, tau, 256)
    clear_groups = ~near.view(B, -1, 256).any(dim=2)
    torch.testing.assert_close(groups[clear_groups], ref_groups[clear_groups], atol=0, rtol=0)


def _int_rows(dev, B, N, D, seed, lo=-3):
    """Integer-valued bf16 queries and rows: every score exact in fp32."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(lo, 4, size=shape).astype(np.float32)).to(dev)
                 .bfloat16() for shape in ((B, D), (N, D)))


def _assert_same_candidates(got, want):
    """The same scores, and the same rows strictly above each query's kc-th
    (rows tied with it may differ)."""
    (s, i), (ws, wi) = got, want
    torch.testing.assert_close(s, ws, atol=0, rtol=0)
    for b in range(s.shape[0]):
        above = s[b] > s[b, -1]
        assert set(i[b][above].tolist()) == set(wi[b][ws[b] > ws[b, -1]].tolist())


# (B, N rows, D, n_valid, kc, route): the CLI's batch and a serving batch
# over a ragged n_valid (a threshold from 4,096- and 256-row tiles); 128
# queries at kc 512 and 1,000 (exact_sort at k = 1,000); fewer than kc
# whole tiles (every valid row a candidate); D = 100 and SPLADE's 30,522 on
# the cp.async route
_TOPK_CASES = [(512, 1 << 19, 768, (1 << 19) - 77, 128, "wgmma"),
               (64, 65536, 768, 65000, 128, "wgmma"),
               (128, 1 << 19, 768, 1 << 19, 512, "wgmma"),
               (128, 1 << 19, 768, 1 << 19, 1000, "wgmma"),
               (70, 20224, 768, 20000, 128, "wgmma"),
               (9, 65536, 100, 65536, 16, "wgmma_cp_async"),
               (256, 8192, 30522, 8192, 16, "wgmma_cp_async")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,n_valid,kc,route", _TOPK_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-v{c[3]}-kc{c[4]}" for c in _TOPK_CASES])
def test_topk_candidates_kernel_equals_plain(cuda_device, B, N, D, n_valid, kc, route):
    """Integer-valued inputs: the kernel's candidates are plain's (exact
    scores, the same rows above the kc-th), no pad row, the same bits
    again, at least one emit launch a call on its route."""
    q, c = _int_rows(cuda_device, B, N, D, B + D + kc)
    kernel = mips_kernels.topk_candidates_kernel
    before = dict(kernel.launches_by_route)
    got, again = mips_kernels.topk_candidates(q, c, n_valid, kc), kernel(q, c, n_valid, kc)
    torch.cuda.synchronize()
    assert kernel.launches_by_route[route] - before[route] >= 2
    _assert_same_candidates(got, mips_kernels.topk_candidates_plain(q, c, n_valid, kc))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert ((got[1] >= 0) & (got[1] < n_valid)).all()


@pytest.mark.cuda
def test_topk_candidates_are_the_count_kernels_bits(cuda_device):
    """Random normal rows: at the j-th candidate's score, count_above_groups
    counts over the block exactly the candidates above it (j where it ties
    with none): pass 1's sums are pass 2's bits."""
    q, c = _scan_inputs(cuda_device, 512, 1 << 19, 768, torch.bfloat16, 41)
    s, _i = mips_kernels.topk_candidates(q, c, c.shape[0], 128)
    for j in (0, 1, 63, 127):
        cnt = mips_kernels.count_above_groups(q, c, s[:, j].contiguous(), 256).sum(dim=1)
        assert torch.equal(cnt, (s > s[:, j : j + 1]).sum(dim=1).to(cnt.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,offset", [(torch.float32, 768, 0), (torch.bfloat16, 101, 0),
                                            (torch.bfloat16, 768, 1)])
def test_topk_score_tile_route_equals_plain(cuda_device, dtype, D, offset):
    """fp32 blocks, odd D and a bf16 base 2 bytes into its buffer take the
    kernel on the score tile: plain's candidates (integer-valued: exact
    scores, the rows above the kc-th). The index's exact_sort launches it
    there on fp32 and odd D; the index copies the unaligned rows into a
    block of its own, which takes the wgmma loop."""
    from dpr_scale_tpu_torch.index.mips import MipsIndex

    q, c = _int_rows(cuda_device, 8, 4096, D, D)
    q, c = q.to(dtype), c.to(dtype)
    if offset:
        buf = torch.zeros(c.numel() + offset, dtype=dtype, device=cuda_device)
        buf[offset:] = c.flatten()
        c = buf[offset:].view(c.shape)
    kernel = mips_kernels.topk_candidates_kernel
    before = dict(kernel.launches_by_route)
    got = kernel(q, c, 4000, 128)
    _assert_same_candidates(got, mips_kernels.topk_candidates_plain(q, c, 4000, 128))
    index = MipsIndex(cuda_device, dtype=dtype, method="exact_sort")
    index.add(c)
    s, _i = index.search(q, k=10)
    after = kernel.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        "score_tile": 1 + (not offset), "wgmma": int(offset), "wgmma_cp_async": 0}
    ws, _wi = mips_kernels.topk_candidates_plain(q, c, 4096, 10)
    np.testing.assert_array_equal(s, ws.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fused", "auto", "approx", "exact_sort"])
def test_pass1_searches_launch_the_kernel_and_equal_the_cpu(cuda_device, method):
    """MipsIndex bf16 blocks (one of fewer rows than kc) on the card: pass 1
    on the kernel route only, and the CPU index's answers (integer-valued
    rows: exact scores; the rows above the k-th)."""
    from dpr_scale_tpu_torch.index.mips import MipsIndex

    rng = np.random.default_rng(len(method))
    blocks = [rng.integers(-3, 4, size=(n, 96)).astype(np.float32) for n in (70000, 100)]
    queries = rng.integers(-3, 4, size=(9, 96)).astype(np.float32)
    got, want = MipsIndex(cuda_device, method=method), MipsIndex("cpu", method=method)
    for index in (got, want):
        for b in blocks:
            index.add(b)
    before = dict(mips_kernels.topk_candidates_kernel.launches_by_route)
    s, i = got.search(queries, k=20)
    after = mips_kernels.topk_candidates_kernel.launches_by_route
    assert after["wgmma"] > before["wgmma"] and after["score_tile"] == before["score_tile"]
    ws, wi = want.search(queries, k=20)
    np.testing.assert_array_equal(s, ws)
    for row in range(len(queries)):
        above = s[row] > s[row, -1]
        assert set(i[row][above]) == set(wi[row][above])
