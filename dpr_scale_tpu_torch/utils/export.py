"""Model export for deployment: an encoder saved as a ``torch.export``
program, and weight-only int8 quantization.

Counterpart of :mod:`dpr_scale_tpu.utils.export` (the reference's
TorchScript export, ``DenseRetrieverTask.to_torchscript``,
dpr_scale/task/dpr_task.py:324-368, and ``ScriptEncoder`` with dynamic int8
quantization, utils/utils.py:94-161):

  * :func:`export_encoder` — ``torch.export`` of an encode module
    ``(input_ids, attention_mask) -> embeddings`` at the fixed
    ``(batch_size, seq_len)`` that ``meta`` records, as the JAX exporter
    fixes its shapes; ``<path>/encoder.pt2`` holds the program and its
    weights, ``<path>/meta.pkl`` the shapes and the device. The port's
    kernels on the encode path are ``torch.library`` custom ops
    (``dpr_scale_tpu_torch::attention_fwd``, ``::ffn_ln_fwd``), so the
    program keeps them: on the card it launches the hand-written kernels;
  * :func:`load_exported_encoder` — the program as a callable module (no
    model code needed), its weights and ``meta``. A JAX StableHLO export
    directory raises, naming its format;
  * :func:`quantize_params` / :func:`dequantize_params` — weight-only int8,
    symmetric per output channel, on exactly the parameters that are Flax
    ``kernel``\\ s of two or more dimensions (every ``Dense`` weight; not the
    embeddings, LayerNorm scales or biases), each scaled over every axis but
    the last of its Flax layout, as the JAX module does with numpy: the
    merged ``attention.qkv`` weight ``(H, 3H)`` is Flax's three ``(H, nh,
    hd)`` kernels, so a column's scale is the maximum over its projection's
    rows and heads; the output kernel ``(nh, hd, H)`` reduces to the port's
    per-column scale. The dequantized weights equal the JAX module's bit for
    bit.
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

PROGRAM_FILE = "encoder.pt2"
META_FILE = "meta.pkl"
QUANT_FORMAT = "dpr_scale_tpu_torch.int8"


class EncoderTower(torch.nn.Module):
    """A bi-encoder's context tower as a module ``(input_ids,
    attention_mask) -> (B, D) embeddings``: what :func:`export_encoder`
    exports for ``generate_embeddings``."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, input_ids, attention_mask):
        return self.model.encode_context(input_ids, attention_mask)


# --------------------------------------------------------------------- #
# torch.export


def export_encoder(encoder: torch.nn.Module, batch_size: int, seq_len: int, path: str) -> str:
    """Export ``encoder`` (a module ``(input_ids, attention_mask) ->
    embeddings``, e.g. :class:`EncoderTower`) in eval mode without
    gradients at fixed ``(batch_size, seq_len)`` int32 inputs on its
    parameters' device, to ``<path>/encoder.pt2`` + ``<path>/meta.pkl``."""
    os.makedirs(path, exist_ok=True)
    device = next(encoder.parameters()).device
    ids = torch.ones((batch_size, seq_len), dtype=torch.int32, device=device)
    encoder.eval()
    with torch.no_grad():
        program = torch.export.export(encoder, (ids, torch.ones_like(ids)))
    torch.export.save(program, os.path.join(path, PROGRAM_FILE))
    with open(os.path.join(path, META_FILE), "wb") as f:
        pickle.dump({"batch_size": batch_size, "seq_len": seq_len, "device": str(device)}, f)
    return path


def load_exported_encoder(path: str) -> Tuple[Callable, Dict[str, torch.Tensor], Dict]:
    """Load an export of :func:`export_encoder`; returns (callable, params,
    meta). ``callable(input_ids, attention_mask)`` runs the saved program
    on ``meta["device"]`` with its own weights (``params``, its state
    dict); inputs must have the recorded shapes."""
    # the program names the port's custom ops: register them first
    from dpr_scale_tpu_torch.ops import attention, ffn  # noqa: F401

    program_path = os.path.join(path, PROGRAM_FILE)
    if not os.path.isfile(program_path):
        if os.path.isfile(os.path.join(path, "encoder.stablehlo")):
            raise ValueError(
                f"{path} is a JAX StableHLO export (encoder.stablehlo + params.pkl, "
                "dpr_scale_tpu.utils.export); the port reads torch.export programs "
                f"({PROGRAM_FILE}): export the encoder with the port's export_encoder"
            )
        raise FileNotFoundError(f"no exported encoder at {path!r}: expected {PROGRAM_FILE}")
    program = torch.export.load(program_path)
    with open(os.path.join(path, META_FILE), "rb") as f:
        meta = pickle.load(f)
    module = program.module()

    def call(input_ids, attention_mask):
        with torch.no_grad():
            return module(input_ids, attention_mask)

    return call, dict(program.state_dict), meta


# --------------------------------------------------------------------- #
# int8 weight-only quantization


def _kernel_groups(model: torch.nn.Module) -> Dict[str, int]:
    """{state-dict name of each Flax ``kernel``: its number of column
    groups}: 3 for a merged q/k/v weight (three Flax kernels side by side),
    1 for every other ``Dense`` weight."""
    from dpr_scale_tpu_torch.models.transformer import Dense, SelfAttention

    groups = {f"{name}.weight" if name else "weight": 1
              for name, mod in model.named_modules() if isinstance(mod, Dense)}
    groups.update({f"{name}.qkv.weight": 3
                   for name, mod in model.named_modules() if isinstance(mod, SelfAttention)})
    return groups


def _qkv_heads(model: torch.nn.Module) -> Dict[str, int]:
    from dpr_scale_tpu_torch.models.transformer import SelfAttention

    return {f"{name}.qkv.weight": mod.cfg.num_heads
            for name, mod in model.named_modules() if isinstance(mod, SelfAttention)}


def quantize_params(model: torch.nn.Module) -> Dict:
    """``model``'s parameters as ``{"format", "leaves": {name: entry}}``:
    ``{"int8": q, "scale": s}`` (s per output column, fp32) for each Flax
    kernel of two or more dimensions, ``{"dense": tensor}`` for every other
    parameter. The numpy arithmetic of the JAX module on the Flax layout."""
    groups, heads = _kernel_groups(model), _qkv_heads(model)
    leaves = {}
    for name, p in model.state_dict().items():
        leaf = p.detach().cpu().float().numpy()
        if name not in groups or leaf.ndim < 2:
            leaves[name] = {"dense": torch.from_numpy(leaf.copy())}
            continue
        if groups[name] == 3:  # (H, 3H) = three Flax kernels (H, nh, hd)
            nh = heads[name]
            H = leaf.shape[0]
            flax = leaf.reshape(H, 3, nh, -1)  # (H, q|k|v, nh, hd)
            scale = np.maximum(np.abs(flax).max(axis=(0, 2), keepdims=True), 1e-12) / 127.0
            q = np.clip(np.round(flax / scale), -127, 127).astype(np.int8).reshape(leaf.shape)
            scale = np.broadcast_to(scale, (1, 3, nh, flax.shape[-1])).reshape(-1)
        else:  # (in, out): Flax's kernel layout; reduce all but the output channel
            scale = np.maximum(np.abs(leaf).max(axis=0), 1e-12) / 127.0
            q = np.clip(np.round(leaf / scale), -127, 127).astype(np.int8)
        leaves[name] = {"int8": torch.from_numpy(np.ascontiguousarray(q)),
                        "scale": torch.from_numpy(np.ascontiguousarray(scale, np.float32))}
    return {"format": QUANT_FORMAT, "leaves": leaves}


def dequantize_params(quantized: Mapping, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A state dict from :func:`quantize_params`' output: each int8 kernel
    times its column scales in fp32 (then ``dtype``), the rest as stored."""
    out = {}
    for name, entry in quantized["leaves"].items():
        if "dense" in entry:
            out[name] = entry["dense"]
        else:
            deq = entry["int8"].numpy().astype(np.float32) * entry["scale"].numpy()
            out[name] = torch.from_numpy(deq).to(dtype)
    return out


def save_quantized(path: str, model: torch.nn.Module) -> str:
    torch.save(quantize_params(model), path)
    return path


def load_quantized(path: str, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The dequantized state dict of a :func:`save_quantized` file. A JAX
    quantized pickle (a Flax tree) raises, naming its format."""
    try:
        quantized = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} is not a port int8 checkpoint ({QUANT_FORMAT}; a JAX "
            "dpr_scale_tpu.utils.export pickle holds a Flax tree): quantize the port's "
            "weights with save_quantized"
        ) from e
    if not isinstance(quantized, Mapping) or quantized.get("format") != QUANT_FORMAT:
        raise ValueError(f"{path} is not a port int8 checkpoint ({QUANT_FORMAT})")
    return dequantize_params(quantized, dtype)
