"""The port's MultiVecEncoder (all four variants) against the Flax module.

The Flax params (perturbed so every bias and LayerNorm parameter matters)
cross through ``from_jax_params``; both sides run fp32 at a tiny width on
the same token ids with ragged masks. Tolerance 1e-5 absolute on every
float output (they are O(1) or below; the sides differ by summation order
only). ``expert_ids`` are compared where the weight is > 0 and the k-th and
(k+1)-th router values differ by more than the tolerance: elsewhere
``topk`` may break a tie either way.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.models.multivec import MultiVecEncoder as JaxMultiVec
from dpr_scale_tpu.models.transformer import TransformerConfig as JaxConfig
from dpr_scale_tpu_torch.models.convert import from_jax_params, init_params
from dpr_scale_tpu_torch.models.multivec import MultiVecEncoder
from dpr_scale_tpu_torch.models.transformer import LayerNorm, TransformerConfig

TOL = 1e-5
VOCAB = 48


def _configs():
    jcfg = dataclasses.replace(JaxConfig.tiny(vocab_size=VOCAB), dtype=jnp.float32)
    fields = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype"}
    tcfg = TransformerConfig(
        dtype=torch.float32,
        **{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields},
    )
    return jcfg, tcfg


def _batch(seed, B=5, L=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, VOCAB, size=(B, L)).astype(np.int32)
    lens = rng.integers(3, L + 1, size=B)
    lens[0] = L
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, 0).astype(np.int32), mask


@functools.lru_cache(maxsize=None)
def _pair(variant, tok_dim, cls_dim, seed=0):
    jcfg, tcfg = _configs()
    ids, mask = _batch(seed)
    jmod = JaxMultiVec(jcfg, variant=variant, tok_projection_dim=tok_dim,
                       cls_projection_dim=cls_dim)
    params = jmod.init(jax.random.PRNGKey(seed), ids, mask, topk=3, add_cls=True)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0.0, 0.05, size=p.shape).astype(np.float32), params
    )
    tmod = MultiVecEncoder(tcfg, variant, tok_dim, cls_dim)
    tmod.load_state_dict(from_jax_params(params))  # strict: the same tree
    return jmod, params, tmod.eval(), ids, mask


def _router(tmod, ids, mask):
    """The port's full (B, T, V) router, for the tie rule."""
    with torch.no_grad():
        hidden = tmod.transformer(torch.from_numpy(ids), torch.from_numpy(mask))
        logits = tmod.mlm_head(hidden[:, 1:]).float()
        return (torch.log1p(torch.relu(logits)) * torch.from_numpy(mask[:, 1:, None])).numpy()


@pytest.mark.parametrize("routing_stats", [True, False])
@pytest.mark.parametrize("add_cls", [True, False])
@pytest.mark.parametrize(
    "variant,tok_dim,cls_dim",
    [("citadel", 8, 8), ("citadel", None, None), ("coil", 8, None), ("coil", None, 8),
     ("colbert", 8, 8), ("splade", None, 8)],
)
def test_multivec_encoder_matches_flax(variant, tok_dim, cls_dim, add_cls, routing_stats):
    jmod, params, tmod, ids, mask = _pair(variant, tok_dim, cls_dim)
    topk = 3
    want = jmod.apply({"params": params}, ids, mask, topk=topk, add_cls=add_cls,
                      routing_stats=routing_stats)
    with torch.no_grad():
        got = tmod(torch.from_numpy(ids), torch.from_numpy(mask), topk=topk, add_cls=add_cls,
                   routing_stats=routing_stats)
    assert set(got) == set(want)
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        assert g.shape == w.shape, key
        if key != "expert_ids":
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=key)
    if "expert_ids" not in want:
        return
    w, g = np.asarray(want["expert_ids"]), got["expert_ids"].numpy()
    assert g.dtype == w.dtype
    if variant == "coil":
        np.testing.assert_array_equal(g, w)
        return
    srt = -np.sort(-_router(tmod, ids, mask), axis=-1)[..., : topk + 1]
    clear = (srt[..., :topk] - srt[..., 1 : topk + 1] > TOL) & (np.asarray(want["expert_weights"]) > 0)
    assert clear.sum() > 0.5 * clear.size * mask[:, 1:].mean()
    np.testing.assert_array_equal(g[clear], w[clear])
    np.testing.assert_array_equal(g[mask[:, 1:] == 0], -1)


def test_inference_mode_router_equals_the_autograd_one():
    """Without autograd the router saturates the fp32 logits in place (one
    live copy of the (B, T, vocab) plane): the same outputs either way."""
    _jmod, _params, tmod, ids, mask = _pair("citadel", 8, 8)
    args = (torch.from_numpy(ids), torch.from_numpy(mask))
    with torch.inference_mode():
        a = tmod(*args, topk=2, add_cls=True)
    b = tmod(*args, topk=2, add_cls=True)
    for key in a:
        torch.testing.assert_close(a[key], b[key].detach(), atol=0, rtol=0)


def test_init_params_seeds_every_multivec_parameter():
    _jcfg, tcfg = _configs()
    model = MultiVecEncoder(tcfg, "citadel", 8, 8)
    sd = init_params(model, torch.Generator().manual_seed(0))
    assert set(sd) == set(model.state_dict())
    assert {"mlm_head.transform.weight", "mlm_head.transform_ln.weight",
            "mlm_head.decoder.weight", "tok_project.weight", "cls_project.weight"} <= set(sd)
    lns = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, LayerNorm)}
    assert "mlm_head.transform_ln.weight" in lns
    assert torch.equal(sd["mlm_head.transform_ln.weight"], torch.ones(tcfg.hidden_size))
    assert abs(sd["mlm_head.decoder.weight"].std().item() - 0.02) < 0.005
    with pytest.raises(ValueError, match="variant"):
        MultiVecEncoder(tcfg, "dense")
