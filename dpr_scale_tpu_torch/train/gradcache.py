"""GradCache: exact large-batch contrastive gradients at the activation
memory of one chunk (counterpart of :mod:`dpr_scale_tpu.train.gradcache`).

Plain accumulation (``trainer.accumulate_grad_batches``) loses the
in-batch negatives of the other chunks; this keeps them:

  phase 1  encode each chunk with no autograd graph (one chunk's
           activations live at a time) and keep its encoder outputs;
  phase 2  differentiate the loss with respect to the kept float outputs
           (cheap: the loss sees only the outputs, not the trunk);
  phase 3  re-encode each chunk under autograd and back-propagate its
           slice of those gradients into the parameters, which sums the
           chunks' parameter gradients (in fp32: the parameters are fp32).

The gradients equal the monolithic step's: the loss depends on the
parameters only through the encoder outputs, integer outputs carry no
gradient there either, and chunk ``g`` encodes with ``rng.fold(g)`` in
both phases, so phases 1 and 3 draw the same dropout masks and kernel
seeds. Cost: one more forward (about 4/3 of the step's operations).

Chunking is strided, as in JAX: chunk ``g`` takes the queries
``{g, C+g, 2C+g, ...}`` and each one's contexts.

Encoder outputs are dicts a side, so that a multi-vector task can reuse
this: the loss is differentiated with respect to every float leaf with a
batch axis, integer leaves ride along as constants of the loss, and
per-chunk scalars (0-d leaves) are dropped (the loss recomputes batch
statistics from the whole planes when it needs them). Phase 3
back-propagates only the leaves that carry a gradient: a float leaf the
encoder makes from constants (a token mask, the CITADEL router's usage
counts) has no graph, and its cotangent goes nowhere, as in JAX, where
such a leaf's VJP is zero.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from dpr_scale_tpu_torch.models.transformer import DropoutRng, fold


def _diff_part(reprs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The differentiated leaves of an encoder output dict: float leaves
    with a batch axis, in sorted-key order."""
    return {k: reprs[k] for k in sorted(reprs)
            if reprs[k].is_floating_point() and reprs[k].ndim >= 1}


def grad_cache_grads(
    params: List[torch.Tensor],
    batch: Mapping[str, torch.Tensor],
    rng: Optional[DropoutRng],
    chunks: int,
    encode_chunk: Callable,  # (qi, qm, ci, cm, rng) -> (q_dict, c_dict)
    loss_on_reprs: Callable,  # (q_full_dict, c_full_dict) -> (loss, aux)
) -> Tuple[torch.Tensor, object, List[torch.Tensor]]:
    """(loss, aux, grads), the grads one per ``params`` entry, equal to the
    monolithic step's (module docstring). ``rng`` None: no dropout."""
    C = chunks
    B = batch["query_ids"].shape[0]
    nctx = batch["contexts_ids"].shape[0]
    ratio = nctx // B
    if B % C or nctx != B * ratio:
        raise ValueError(
            f"GradCache needs the batch's {B} queries to split into "
            f"task.grad_cache_chunks={C} equal chunks and the same number of "
            f"contexts a query ({nctx} contexts); set datamodule.batch_size to "
            f"a multiple of {C}"
        )

    def q_chunk(x, g):
        return x.reshape(B // C, C, *x.shape[1:])[:, g]

    def c_chunk(x, g):
        return x.reshape(B // C, C, ratio, *x.shape[1:])[:, g].reshape(-1, *x.shape[1:])

    def q_unchunk(parts):
        return torch.stack(parts, dim=1).reshape(B, *parts[0].shape[1:])

    def c_unchunk(parts):
        shape = parts[0].shape[1:]
        stacked = torch.stack([p.reshape(B // C, ratio, *shape) for p in parts], dim=1)
        return stacked.reshape(nctx, *shape)

    def encode(g):
        return encode_chunk(
            q_chunk(batch["query_ids"], g), q_chunk(batch["query_mask"], g),
            c_chunk(batch["contexts_ids"], g), c_chunk(batch["contexts_mask"], g),
            fold(rng, g),
        )

    # phase 1: the encoder outputs, no autograd graph
    with torch.no_grad():
        outs = [encode(g) for g in range(C)]

    def unchunk(side, un):
        keys = [k for k, v in outs[0][side].items() if v.ndim >= 1]
        return {k: un([o[side][k] for o in outs]) for k in keys}

    q_full, c_full = unchunk(0, q_unchunk), unchunk(1, c_unchunk)
    del outs

    # phase 2: the loss and its gradient with respect to the float leaves
    q_diff = {k: v.detach().requires_grad_(True) for k, v in _diff_part(q_full).items()}
    c_diff = {k: v.detach().requires_grad_(True) for k, v in _diff_part(c_full).items()}
    with torch.enable_grad():
        loss, aux = loss_on_reprs({**q_full, **q_diff}, {**c_full, **c_diff})
        leaves = [*q_diff.values(), *c_diff.values()]
        cotangents = torch.autograd.grad(loss, leaves, allow_unused=True)
    cot = [torch.zeros_like(v) if d is None else d for v, d in zip(leaves, cotangents)]
    dq, dc = dict(zip(q_diff, cot[:len(q_diff)])), dict(zip(c_diff, cot[len(q_diff):]))
    del q_full, c_full, q_diff, c_diff, leaves

    # phase 3: re-encode each chunk under autograd against its cotangent
    # slice; backward sums the chunks' gradients into .grad
    saved = [p.grad for p in params]
    for p in params:
        p.grad = None
    try:
        for g in range(C):
            with torch.enable_grad():
                q_repr, c_repr = encode(g)
                q_out, c_out = _diff_part(q_repr), _diff_part(c_repr)
                pairs = [(v, q_chunk(dq[k], g)) for k, v in q_out.items()]
                pairs += [(v, c_chunk(dc[k], g)) for k, v in c_out.items()]
                pairs = [(v, d) for v, d in pairs if v.requires_grad]
                outputs = [v for v, _ in pairs]
                grads_out = [d for _, d in pairs]
                if outputs:
                    torch.autograd.backward(outputs, grads_out, inputs=params)
            del q_repr, c_repr, q_out, c_out, pairs, outputs, grads_out
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    finally:
        for p, s in zip(params, saved):
            p.grad = s
    return loss.detach(), aux, grads
