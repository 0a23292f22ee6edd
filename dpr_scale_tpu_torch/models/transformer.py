"""BERT-family transformer encoder in PyTorch (inference and training).

Counterpart of :mod:`dpr_scale_tpu.models.transformer`: post-LN BERT with
merged q/k/v, the additive -1e9 key bias, the einsum-style or fused FFN and
the RoBERTa position offset. Parameters follow Flax's layout and dtypes: every
parameter is stored in fp32 (the optimizer updates fp32 master weights) and
matmul kernels and embedding rows are cast to the activation dtype at every
call, as Flax's ``nn.Dense`` / ``nn.Embed`` with ``dtype=bf16`` do.
LayerNorm normalises in fp32 with the fast variance E[x^2] - E[x]^2, as
``flax.linen.LayerNorm`` does.

Dropout sits where the JAX module puts it: after the embedding LayerNorm,
on the attention output and the FFN output (``hidden_dropout``) and on the
attention probabilities (``attention_dropout``; inside the kernel on the
fused path). A forward is deterministic unless it is given a
:class:`DropoutRng`, the counterpart of Flax's ``deterministic=False`` with
a ``dropout`` rng. Each layer draws from its own fold of that rng, so a
second forward of one layer (GradCache's re-encode, remat's recompute)
draws the same masks and kernel seeds as the first.

With ``cfg.remat`` each layer of a forward that takes gradients runs under
``torch.utils.checkpoint`` (JAX: ``nn.remat``): its activations are
recomputed in the backward, from generators the layer rebuilds inside the
checkpointed function, so remat changes no value at any dropout rate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0
    position_offset: int = 0  # RoBERTa uses 2 (positions start at pad+1)
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    remat: bool = False  # recompute each layer's activations in the backward
    fused_attention: bool = False  # ops.attention kernel instead of matmuls
    fused_ffn: bool = False  # ops.ffn kernels for the FFN half of each layer

    @staticmethod
    def tiny(vocab_size: int = 32) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=vocab_size,
            hidden_size=16,
            num_layers=2,
            num_heads=1,
            intermediate_size=4,
            max_position_embeddings=64,
            hidden_dropout=0.0,
            attention_dropout=0.0,
        )

    @staticmethod
    def bert_base() -> "TransformerConfig":
        return TransformerConfig()

    @staticmethod
    def bert_large() -> "TransformerConfig":
        return TransformerConfig(
            hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096
        )

    @staticmethod
    def roberta_base() -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=50265,
            max_position_embeddings=514,
            type_vocab_size=1,
            layer_norm_eps=1e-5,
            pad_token_id=1,
            position_offset=2,
        )


class DropoutRng:
    """The dropout randomness of one training step, a pure function of
    ``(seed, step)`` as JAX's ``fold_in(dropout_rng, step)`` is, and of the
    ``path`` of :meth:`fold` calls that led to it.

    Hidden and unfused-attention masks are drawn from a generator on the
    activations' device; the fused kernels take one int seed per call,
    drawn from a CPU generator, so no seed needs a device sync. Both
    generators are made anew for each object: two objects of one
    ``(seed, step, path)`` draw the same sequence."""

    def __init__(self, seed: int, step: int, device, path=()):
        self.seed, self.step, self.path = int(seed), int(step), tuple(int(i) for i in path)
        self._device = torch.device(device)
        # the path's length first: (s, t) and (s, t, 0) would otherwise mix
        # into the same state (SeedSequence pads its entropy with zeros)
        entropy = (self.seed, self.step, len(self.path), *self.path)
        state = np.random.SeedSequence(entropy).generate_state(2, np.uint64)
        self.cpu = torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))
        self.device = torch.Generator(device=self._device).manual_seed(
            int(state[1] >> np.uint64(1))
        )

    def fold(self, i: int) -> "DropoutRng":
        """A fresh rng whose state is a function of ``(seed, step, *path,
        i)`` alone (``jax.random.fold_in``), whatever was drawn from this
        one."""
        if i < 0:
            raise ValueError(f"fold index must be >= 0, got {i}")
        return DropoutRng(self.seed, self.step, self._device, self.path + (i,))

    def kernel_seed(self) -> int:
        return int(torch.randint(0, 2**32, (), generator=self.cpu))


def fold(rng: Optional[DropoutRng], i: int) -> Optional[DropoutRng]:
    """``rng.fold(i)``, or None for a deterministic forward."""
    return None if rng is None else rng.fold(i)


def dropout(x, rate: float, rng: Optional[DropoutRng]):
    """Flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    entries by 1 / (1 - rate) in ``x``'s dtype; identity without ``rng``."""
    if rng is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=rng.device, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """``x @ weight + bias`` with Flax's ``(in, out)`` kernel layout; fp32
    parameters cast to ``dtype`` at every call."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_in, d_out, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(d_out, dtype=torch.float32))
        self.dtype = dtype

    def forward(self, x):
        return torch.matmul(x.to(self.dtype), self.weight.to(self.dtype)) + self.bias.to(
            self.dtype
        )


class LayerNorm(nn.Module):
    """Flax LayerNorm: fp32 statistics with the fast variance, output in
    ``dtype``."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(features, dtype=torch.float32))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv = Dense(h, 3 * h, cfg.dtype)  # query | key | value columns
        self.output = Dense(h, h, cfg.dtype)

    def forward(self, x, attn_bias, rng: Optional[DropoutRng] = None):
        """x (B, L, H); attn_bias (B, 1, L) fp32 additive key mask."""
        cfg = self.cfg
        B, L, H = x.shape
        nh = cfg.num_heads
        hd = H // nh
        rate = 0.0 if rng is None else cfg.attention_dropout
        qkv = self.qkv(x)
        # (B, L, 3, nh, hd) -> three contiguous (B, nh, L, hd)
        q, k, v = (
            t.transpose(1, 2).contiguous()
            for t in qkv.view(B, L, 3, nh, hd).unbind(dim=2)
        )
        if cfg.fused_attention:
            from dpr_scale_tpu_torch.ops.attention import fused_attention

            seed = rng.kernel_seed() if rate > 0.0 else 0
            ctx = fused_attention(q, k, v, attn_bias, seed, rate)
        else:
            # the JAX einsum path: logits in the activation dtype, then fp32
            logits = torch.matmul(q, k.transpose(-1, -2)).float()
            logits = logits / math.sqrt(hd) + attn_bias[:, :, None, :]
            probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
            probs = dropout(probs, rate, rng)
            ctx = torch.matmul(probs, v)
        return self.output(ctx.transpose(1, 2).reshape(B, L, H))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.attention = SelfAttention(cfg)
        self.attention_ln = LayerNorm(h, cfg.layer_norm_eps, cfg.dtype)
        self.intermediate = Dense(h, f, cfg.dtype)
        self.ffn_output = Dense(f, h, cfg.dtype)
        self.output_ln = LayerNorm(h, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, x, attn_bias, rng: Optional[DropoutRng] = None):
        cfg = self.cfg
        rate = cfg.hidden_dropout
        attn = dropout(self.attention(x, attn_bias, rng), rate, rng)
        if cfg.fused_ffn:
            return self._fused_ffn_half(x, attn, rng)
        x = self.attention_ln(x + attn)
        ffn = self.ffn_output(F.gelu(self.intermediate(x)))  # exact erf GELU
        return self.output_ln(x + dropout(ffn, rate, rng))

    def _fused_ffn_half(self, x, attn, rng: Optional[DropoutRng]):
        """The JAX layer's two fused branches, on the unfused layer's
        parameters (one parameter tree for both flags): a deterministic
        forward runs the whole half-layer (attention_ln, FFN, output_ln and
        both residual adds) as ``fused_ffn_ln``; a training forward runs
        ``fused_ffn`` with its dropout between two LayerNorms."""
        from dpr_scale_tpu_torch.ops.ffn import fused_ffn, fused_ffn_ln

        cfg = self.cfg
        B, L, H = x.shape
        w = (self.intermediate.weight, self.intermediate.bias,
             self.ffn_output.weight, self.ffn_output.bias)
        if rng is None:
            out = fused_ffn_ln(
                (x + attn).reshape(B * L, H).to(cfg.dtype), *w,
                self.attention_ln.weight, self.attention_ln.bias,
                self.output_ln.weight, self.output_ln.bias, 0, 0.0, cfg.layer_norm_eps,
            )
            return out.view(B, L, H)
        rate = cfg.hidden_dropout
        x = self.attention_ln(x + attn)
        seed = rng.kernel_seed() if rate > 0.0 else 0
        ffn = fused_ffn(x.reshape(B * L, H).to(cfg.dtype), *w, seed, rate)
        return self.output_ln(x + ffn.view(B, L, H))


def _run_layer(layer: TransformerLayer, x, attn_bias, rng: Optional[DropoutRng], i: int):
    """Layer ``i`` on its own fold of ``rng``, made here so that remat's
    recompute of this call rebuilds the same generators."""
    return layer(x, attn_bias, fold(rng, i))


class TransformerEncoder(nn.Module):
    """Token ids -> contextual hidden states (B, L, H).

    Dropout: the embeddings draw from ``rng.fold(0)``, layer ``i`` from
    ``rng.fold(i + 1)``. ``cfg.remat``: each layer of a forward that takes
    gradients under ``torch.utils.checkpoint`` (non-reentrant), as JAX wraps
    each in ``nn.remat``; a forward without gradients runs as without it."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.embeddings_ln = LayerNorm(h, cfg.layer_norm_eps, cfg.dtype)
        self.layers = nn.ModuleList(
            TransformerLayer(cfg) for _ in range(cfg.num_layers)
        )

    def forward(
        self,
        input_ids,
        attention_mask: Optional[torch.Tensor] = None,
        rng: Optional[DropoutRng] = None,
    ):
        cfg = self.cfg
        B, L = input_ids.shape
        input_ids = input_ids.long()
        if attention_mask is None:
            attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
        if cfg.position_offset:  # RoBERTa-style: pad-aware position ids
            am = attention_mask.long()
            pos_ids = torch.cumsum(am, dim=1) * am + (cfg.position_offset - 1)
        else:
            pos_ids = torch.arange(L, device=input_ids.device).expand(B, L)
        # fp32 rows gathered then cast: the values of Flax's cast-then-take
        x = self.word_embeddings(input_ids).to(cfg.dtype)
        x = x + self.position_embeddings(pos_ids).to(cfg.dtype)
        if cfg.type_vocab_size > 0:
            x = x + self.token_type_embeddings(torch.zeros_like(input_ids)).to(cfg.dtype)
        x = dropout(self.embeddings_ln(x), cfg.hidden_dropout, fold(rng, 0))
        # additive key bias (B, 1, L): 0 keep, -1e9 drop
        attn_bias = (1.0 - attention_mask.float())[:, None, :] * -1e9
        remat = cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers, start=1):
            if remat:
                # the layer's generators live inside the function, so the
                # default generators' states need not be replayed
                x = checkpoint(_run_layer, layer, x, attn_bias, rng, i,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _run_layer(layer, x, attn_bias, rng, i)
        return x
