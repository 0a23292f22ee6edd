"""The port's exporter (``utils.export``) against the JAX package's and
against the model it exports, on the CPU.

* weight-only int8: quantize -> dequantize equals the JAX module's bit for
  bit on the same Flax weights (the merged q/k/v weight scaled per Flax
  kernel, over its rows and heads), and touches exactly the Flax kernels;
* ``torch.export``: the loaded program equals the model (1e-6 abs); with
  ``fused_attention`` / ``fused_ffn`` its graph holds the port's custom ops
  (``dpr_scale_tpu_torch::attention_fwd``, ``::ffn_ln_fwd``), which run the
  plain versions on CPU tensors and the kernels on the card;
* a JAX StableHLO export or a JAX quantized pickle raises, naming its format.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.models import BiEncoder as JaxBiEncoder
from dpr_scale_tpu.models import TransformerConfig as JaxConfig
from dpr_scale_tpu.models.encoder import SpladeBiEncoder as JaxSpladeBiEncoder
from dpr_scale_tpu.utils import export as jax_export
from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder
from dpr_scale_tpu_torch.models.convert import from_jax_params, init_params
from dpr_scale_tpu_torch.models.encoder import BiEncoder, SpladeBiEncoder
from dpr_scale_tpu_torch.models.transformer import TransformerConfig
from dpr_scale_tpu_torch.utils import export

JCFG = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32, hidden_size=64, num_heads=4,
                           intermediate_size=128)
TCFG = TransformerConfig(vocab_size=32, hidden_size=64, num_layers=2, num_heads=4,
                         intermediate_size=128, max_position_embeddings=64,
                         hidden_dropout=0.0, attention_dropout=0.0, dtype=torch.float32)


def _batch(B=4, L=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 32, size=(B, L)).astype(np.int32)
    mask = (np.arange(L)[None, :] < rng.integers(3, L + 1, size=(B, 1))).astype(np.int32)
    return torch.from_numpy(ids), torch.from_numpy(mask)


@pytest.mark.parametrize("family", ["dense", "splade"])
def test_int8_round_trip_equals_jax_bit_for_bit(family):
    ids = jnp.ones((2, 8), jnp.int32)
    if family == "splade":
        jmodel, model = JaxSpladeBiEncoder(JCFG, shared=False), SpladeBiEncoder(TCFG, shared=False)
    else:
        jmodel = JaxBiEncoder(JCFG, projection_dim=16, shared=False)
        model = BiEncoder(TCFG, projection_dim=16, shared=False)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3), ids, ids, ids, ids)["params"])
    model.load_state_dict(from_jax_params(params))
    want = from_jax_params(jax.device_get(jax_export.dequantize_params(
        jax_export.quantize_params(params))))
    quantized = export.quantize_params(model)
    got = export.dequantize_params(quantized)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], want[name]), name
    # exactly the Flax kernels (every Dense weight, q/k/v merged) are int8
    int8 = {n for n, e in quantized["leaves"].items() if "int8" in e}
    assert int8 == {n for n in want if n.endswith(".weight") and want[n].ndim == 2
                    and "embeddings" not in n}
    assert all(quantized["leaves"][n]["int8"].dtype == torch.int8 for n in int8)


def test_saved_quantized_weights_load_and_a_jax_pickle_is_refused(tmp_path):
    model = BiEncoder(TCFG)
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    path = export.save_quantized(str(tmp_path / "q.pt"), model)
    assert export.load_quantized(path).keys() == model.state_dict().keys()
    params = JaxBiEncoder(JCFG).init(jax.random.PRNGKey(0), *(jnp.ones((1, 4), jnp.int32),) * 4)
    jax_path = jax_export.save_quantized(str(tmp_path / "jax_q.pkl"), params["params"])
    with pytest.raises(ValueError, match="not a port int8 checkpoint"):
        export.load_quantized(jax_path)


@pytest.mark.parametrize("fused", [False, True], ids=["matmuls", "custom_ops"])
def test_exported_encoder_equals_the_model(tmp_path, fused):
    cfg = dataclasses.replace(TCFG, fused_attention=fused, fused_ffn=fused)
    model = BiEncoder(cfg)
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(1)))
    model.eval()
    export.export_encoder(export.EncoderTower(model), 4, 12, str(tmp_path / "exp"))
    program, params, meta = export.load_exported_encoder(str(tmp_path / "exp"))
    assert meta == {"batch_size": 4, "seq_len": 12, "device": "cpu"}
    assert len(params) > 0
    targets = {str(n.target) for n in torch.export.load(str(tmp_path / "exp/encoder.pt2")).graph.nodes}
    ops = {"dpr_scale_tpu_torch.attention_fwd.default", "dpr_scale_tpu_torch.ffn_ln_fwd.default"}
    assert ops <= targets if fused else not ops & targets
    ids, mask = _batch()
    with torch.no_grad():
        want = model.encode_context(ids, mask)
    np.testing.assert_allclose(program(ids, mask).numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    encoder = CorpusEncoder.from_exported(str(tmp_path / "exp"), "cpu")
    emb, _ = encoder.encode_batches([{"input_ids": ids.numpy(), "attention_mask": mask.numpy(),
                                      "pad_count": 1}])
    np.testing.assert_allclose(emb, want.numpy()[:3], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="batches of shape"):
        encoder.encode(*_batch(B=2))


def test_a_jax_stablehlo_export_is_refused_naming_its_format(tmp_path):
    model = JaxBiEncoder(JCFG)
    ids = jnp.ones((2, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids, ids, ids, ids)["params"]
    jax_export.export_encoder(
        lambda p, i, m: model.apply({"params": p}, i, m, method=model.encode_context),
        params, 2, 8, str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="JAX StableHLO export"):
        export.load_exported_encoder(str(tmp_path / "jax"))
    with pytest.raises(FileNotFoundError):
        export.load_exported_encoder(str(tmp_path / "none"))
