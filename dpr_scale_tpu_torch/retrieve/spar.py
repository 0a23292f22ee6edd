"""SPAR: salient-phrase-aware retrieval, a base dense retriever combined
with a lexical (Lambda) model at the embedding level.

Counterpart of :mod:`dpr_scale_tpu.retrieve.spar`:
  * ``SalientPhraseAwareDenseRetrieverTask`` (dpr_scale/task/spar_task.py:25-58):
    the query embedding is concat(q_base, w * q_lexical), the passage
    embedding concat(p_base, p_lexical): the weight on queries ONLY;
  * ``spar/spar_retrieval.py:101-222``: the offline combination of two
    precomputed embedding directories with pooling in {concat, mean, sum},
    an optional re-save of the combined embeddings as 8 reference-format
    shards, the exact top-k search (the port's ``MipsIndex`` with its default
    method, on the card) and DPR JSON;
  * ``spar/spar_weight_tuning.py`` / ``utils/tune_spar_weights.py``: a grid
    search over the concat weight that re-scores the union of the two
    models' top-k with the combined score (host numpy, as in JAX).
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from dpr_scale_tpu_torch.encode.embeddings import load_embedding_shards, save_embedding_shard
from dpr_scale_tpu_torch.index.mips import MipsIndex
from dpr_scale_tpu_torch.retrieve.retrieval import retrieve

INDEX_BLOCK = 2_000_000  # rows per index block, as the JAX module adds them


def combine_query_vectors(q1: np.ndarray, q2: np.ndarray, weight: float = 1.0,
                          pooling: str = "concat") -> np.ndarray:
    pooling = pooling.lower()
    if pooling == "concat":
        return np.concatenate([q1, weight * q2], axis=-1)
    if pooling == "mean":
        return (q1 + weight * q2) / (1.0 + weight)
    if pooling == "sum":
        return q1 + weight * q2
    raise ValueError(pooling)


def combine_passage_vectors(p1: np.ndarray, p2: np.ndarray, pooling: str = "concat") -> np.ndarray:
    pooling = pooling.lower()
    if pooling == "concat":
        return np.concatenate([p1, p2], axis=-1)
    if pooling == "mean":
        return (p1 + p2) / 2.0
    if pooling == "sum":
        return p1 + p2
    raise ValueError(pooling)


def load_dir_embeddings(ctx_embeddings_dir: str) -> np.ndarray:
    shards = load_embedding_shards(ctx_embeddings_dir)
    return np.concatenate([emb for _n, emb in shards], axis=0)


def load_query_embeddings(ctx_embeddings_dir: str, name: str = "query_reps.pkl") -> np.ndarray:
    with open(os.path.join(ctx_embeddings_dir, name), "rb") as f:
        obj = pickle.load(f)
    if hasattr(obj, "numpy"):
        obj = obj.float().numpy()
    return np.asarray(obj, dtype=np.float32)


def run_spar_retrieval(
    questions_list: Sequence[Sequence[dict]],
    passages_path: str,
    ctx_embeddings_dir_1: str,
    ctx_embeddings_dir_2: str,
    output_dir: str,
    output_filenames: Sequence[str],
    device=None,
    query_emb_names: Sequence[str] = ("query_reps.pkl",),
    weights: Optional[Sequence[float]] = None,
    save_embeddings: bool = False,
    topk: int = 100,
    pooling: str = "concat",
) -> List[str]:
    """Combine two embedding sets and retrieve for each query set on
    ``device`` (default ``cuda:0``); returns the written DPR JSON paths."""
    from dpr_scale_tpu_torch.device import resolve_device

    if not weights:
        weights = [1.0] * len(query_emb_names)
    if not (len(questions_list) == len(query_emb_names) == len(output_filenames) == len(weights)):
        # a short list would silently zip-drop query sets
        raise ValueError("questions, query embedding names, output names and weights differ "
                         "in length")
    device = resolve_device(device)

    p1 = load_dir_embeddings(ctx_embeddings_dir_1)
    p2 = load_dir_embeddings(ctx_embeddings_dir_2)
    if p1.shape[0] != p2.shape[0]:
        raise ValueError(f"passage sets differ between models: {p1.shape[0]} vs {p2.shape[0]}")
    p = combine_passage_vectors(p1, p2, pooling)
    del p1, p2

    os.makedirs(output_dir, exist_ok=True)
    if save_embeddings:
        num_shards = 8
        per = p.shape[0] // num_shards + 1
        for i in range(num_shards):
            save_embedding_shard(os.path.join(output_dir, f"reps_{i:04}"),
                                 p[i * per : (i + 1) * per], "pickle")

    index = MipsIndex(device)
    for lo in range(0, p.shape[0], INDEX_BLOCK):
        index.add(p[lo : lo + INDEX_BLOCK])
    del p

    out_paths = []
    for questions, emb_name, weight, out_name in zip(
        questions_list, query_emb_names, weights, output_filenames
    ):
        q1 = load_query_embeddings(ctx_embeddings_dir_1, emb_name)
        q2 = load_query_embeddings(ctx_embeddings_dir_2, emb_name)
        q = combine_query_vectors(q1, q2, weight, pooling)
        if save_embeddings:
            with open(os.path.join(output_dir, emb_name), "wb") as f:
                pickle.dump(q, f, protocol=4)
        out_path = os.path.join(output_dir, out_name)
        retrieve(q, questions, passages_path=passages_path, ctx_embeddings_dir=".",
                 device=device, k=topk, output_json_path=out_path, index=index)
        out_paths.append(out_path)
    return out_paths


def tune_spar_weight(
    q1: np.ndarray,
    q2: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    judge_fn,
    weights: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9, 1.0, 1.25, 1.43, 2.0),
    topk: int = 100,
) -> dict:
    """Grid-search the concat weight by joint-pool reranking: for each
    weight, score every query against the UNION of the two models' top-k
    passages with the combined score, take the new top-k and let
    ``judge_fn(weight, topk_indices)`` return a quality scalar (e.g. answer
    recall@k). spar_weight_tuning.py's protocol, without a search of the
    whole corpus per weight."""
    s1 = q1 @ p1.T
    s2 = q2 @ p2.T
    top1 = np.argsort(-s1, axis=1)[:, :topk]
    top2 = np.argsort(-s2, axis=1)[:, :topk]
    results = {}
    for w in weights:
        per_query = []
        for qi in range(q1.shape[0]):
            pool = np.unique(np.concatenate([top1[qi], top2[qi]]))
            combined = s1[qi, pool] + w * s2[qi, pool]
            per_query.append(pool[np.argsort(-combined)][:topk])
        results[w] = judge_fn(w, per_query)
    best = max(results, key=results.get)
    return {"best_weight": best, "scores": results}
