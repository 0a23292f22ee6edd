"""Reranking: rescore the candidates of a TREC run with a model, on one
device.

Counterpart of :mod:`dpr_scale_tpu.retrieve.rerank`:
  * :func:`rerank_dense` — the rowwise q . ctx dot of a bi-encoder
    (``RerankDenseRetrieverTask``, dpr_scale/task/dpr_rerank_task.py:37-71);
  * :func:`rerank_multivec` — pairwise late interaction
    (``RerankMultiVecRetrieverTask``, task/citadel_eval_task.py:215-313): the
    blocked ``train.multivec.expert_sim_score`` with ``pairwise=True``, plus
    the CLS dot under ``add_cls``;
  * :func:`rerank_cross_encoder` — the max over a cross-encoder's logits of
    the concatenated text (``RerankCrossEncoderTask``,
    task/cross_encoder_eval_task.py:21-57).

Outputs, the JAX package's bytes for the same scores: per-shard pickles
(``scores/qids/ctx_ids_{shard:04}.pkl``, the reference's format) and / or a
TREC run re-sorted by score within each query.
"""
from __future__ import annotations

import os
import pickle
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dpr_scale_tpu_torch.data.tokenize import HFTokenizer
from dpr_scale_tpu_torch.retrieve.writers import write_trec_run
from dpr_scale_tpu_torch.utils.prefetch import prefetch


def _pair_batches(dataset, tokenizer: HFTokenizer, batch_size: int, concat: bool,
                  use_title: bool, sep: Optional[str] = None):
    """Fixed-size batches of candidate pairs, the tail padded with its last
    pair; yields (items, pad, numpy batch). ``concat`` tokenizes each pair
    as one ``text_pairs`` sequence (the cross-encoder's input)."""
    sep = sep if sep is not None else tokenizer.sep_token

    def ctx_text(item):
        ctx = item["ctx"]
        text = ctx.get("text", "")
        if use_title and ctx.get("title"):
            return f"{ctx['title']} {sep} {text}"
        return text

    def gen():
        buf = []
        for idx in range(len(dataset)):
            buf.append(dataset[idx])
            if len(buf) == batch_size:
                yield buf, 0
                buf = []
        if buf:
            pad = batch_size - len(buf)
            yield buf + [buf[-1]] * pad, pad

    for items, pad in prefetch(gen(), 2):
        questions = [it["question"] for it in items]
        ctxs = [ctx_text(it) for it in items]
        if concat:
            ids, mask = tokenizer(questions, text_pairs=ctxs)
            batch = {"pair_ids": ids, "pair_mask": mask}
        else:
            q_ids, q_mask = tokenizer(questions)
            c_ids, c_mask = tokenizer(ctxs)
            batch = {"query_ids": q_ids, "query_mask": q_mask,
                     "contexts_ids": c_ids, "contexts_mask": c_mask}
        yield items, pad, batch


def _run_rerank(
    dataset,
    tokenizer: HFTokenizer,
    score_batch: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    device,
    batch_size: int,
    concat: bool,
    use_title: bool,
    output_trec_path: Optional[str] = None,
    output_pickle_dir: Optional[str] = None,
    shard_id: int = 0,
    run_name: str = "dpr_scale_tpu_rerank",
) -> Dict[str, List]:
    """Score every candidate pair with ``score_batch`` (a batch of tensors
    on ``device`` -> (batch_size,) scores), without autograd; write the
    outputs asked for; returns {"qids", "ctx_ids", "scores"} in run order."""
    qids: List[str] = []
    docids: List[str] = []
    scores: List[float] = []
    device = torch.device(device)
    for items, pad, batch in _pair_batches(dataset, tokenizer, batch_size, concat, use_title):
        with torch.inference_mode():
            tensors = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            s = score_batch(tensors).float().cpu().numpy().astype(np.float32)
        n = len(items) - pad
        for it, sc in zip(items[:n], s[:n]):
            qids.append(it["qid"])
            docids.append(it["docid"])
            scores.append(float(sc))

    if output_pickle_dir:
        os.makedirs(output_pickle_dir, exist_ok=True)
        for name, payload in (("scores", scores), ("qids", qids), ("ctx_ids", docids)):
            with open(os.path.join(output_pickle_dir, f"{name}_{shard_id:04}.pkl"), "wb") as f:
                pickle.dump(payload, f, protocol=4)

    if output_trec_path:
        by_qid: Dict[str, List] = defaultdict(list)
        for qid, docid, sc in zip(qids, docids, scores):
            by_qid[qid].append((sc, docid))
        out_qids, out_docs, out_scores = [], [], []
        for qid, entries in by_qid.items():
            entries.sort(key=lambda x: -x[0])
            out_qids.append(qid)
            out_docs.append([d for _s, d in entries])
            out_scores.append([s for s, _d in entries])
        write_trec_run(output_trec_path, out_qids, out_docs, out_scores, run_name)
    return {"qids": qids, "ctx_ids": docids, "scores": scores}


def rerank_dense(model, tokenizer, dataset, device, batch_size=64, use_title=True, **kw):
    """Rowwise dot(q, ctx) of a bi-encoder (dpr_rerank_task.py:37-42)."""

    def score(b):
        q = model.encode_query(b["query_ids"], b["query_mask"])
        c = model.encode_context(b["contexts_ids"], b["contexts_mask"])
        return torch.sum(q * c, dim=-1)

    return _run_rerank(dataset, tokenizer, score, device, batch_size, concat=False,
                       use_title=use_title, **kw)


def rerank_multivec(model, tokenizer, dataset, device, batch_size=16, use_title=True,
                    query_topk=1, context_topk=1, add_cls=False, query_pool="sum", **kw):
    """Pairwise late-interaction rerank of a ``MultiVecEncoder``
    (citadel_eval_task.py:234-265)."""
    from dpr_scale_tpu_torch.train.multivec import dot_score, expert_sim_score

    def score(b):
        q_repr = model(b["query_ids"], b["query_mask"], topk=query_topk, add_cls=add_cls,
                       routing_stats=False)
        c_repr = model(b["contexts_ids"], b["contexts_mask"], topk=context_topk,
                       add_cls=add_cls, routing_stats=False)
        s = expert_sim_score(q_repr, c_repr, pairwise=True, query_pool=query_pool)
        if add_cls:
            s = s + dot_score(q_repr["cls_repr"], c_repr["cls_repr"], pairwise=True)
        return s[:, 0]  # one context per query row

    return _run_rerank(dataset, tokenizer, score, device, batch_size, concat=False,
                       use_title=use_title, **kw)


def rerank_cross_encoder(model, tokenizer, dataset, device, batch_size=64, use_title=True,
                         **kw):
    """Concatenated-text scoring, the max over the class logits
    (cross_encoder_eval_task.py:21-26)."""

    def score(b):
        return torch.amax(model(b["pair_ids"], b["pair_mask"]), dim=-1)

    return _run_rerank(dataset, tokenizer, score, device, batch_size, concat=True,
                       use_title=use_title, **kw)
