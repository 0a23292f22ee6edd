"""Inverted expert index for CITADEL / COIL multi-vector retrieval (host).

The port's copy of :mod:`dpr_scale_tpu.index.inverted` (numpy only), the
host search and the oracle of the device index
(:mod:`dpr_scale_tpu_torch.index.inverted_device`):

  * storage: per expert id, posting lists of (corpus_row, weight,
    weight-premultiplied token vector) — written/read in the reference's
    shard format ``{dir}/expert_{shard:04}/{expert_id}.pkl`` holding the
    tuple (ids, weights, vecs), plus dense ``cls_{shard:04}.pkl``
    (citadel_eval_task.py:75-118); the pickles are numpy arrays, so shards
    written by either package load in the other;
  * scoring: for every query token routed to expert e with weight w, the
    contribution to document d is ``max over d's postings in e of
    (w * q) . (w_d * v_d)`` with a zero floor, summed over the query's
    routed tokens, plus the CLS dot product (citadel_task.py:191-228);
  * optional posting pruning by ``weight_threshold``
    (citadel_eval_task.py:67), ``portion`` (keep the largest posting lists
    covering that fraction of postings) and per-row int8 quantization of
    posting vectors (``quantizer="pq"``/``"int8"``,
    citadel_retrieval_task.py:57-63);
  * ``expert_shards``: load only some emission shards (expert-parallel
    loading).
"""
from __future__ import annotations

import collections
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class _ExpertPostings:
    __slots__ = ("doc_ids", "weights", "vecs", "sort_order", "group_starts", "group_docs", "scale")

    def __init__(self, doc_ids, weights, vecs, scale=None):
        self.doc_ids = doc_ids  # (n,) int64 corpus rows
        self.weights = weights  # (n,) fp32
        self.vecs = vecs  # (n, D) fp32/int8 weight-premultiplied
        self.scale = scale  # int8 dequant scale per posting, or None
        order = np.argsort(doc_ids, kind="stable")
        self.sort_order = order
        sorted_docs = doc_ids[order]
        starts = np.flatnonzero(
            np.concatenate([[True], sorted_docs[1:] != sorted_docs[:-1]])
        )
        self.group_starts = starts
        self.group_docs = sorted_docs[starts]

    def dense_vecs(self) -> np.ndarray:
        if self.scale is None:
            return self.vecs
        return self.vecs.astype(np.float32) * self.scale[:, None]


def _maybe_quantize(vecs: np.ndarray, quantizer: Optional[str]):
    """Per-row symmetric int8 for posting vectors (quantizer "pq"/"int8"
    — the reference's IVFPQ option, citadel_retrieval_task.py:12); one
    definition shared by finalize() and load() so build and load cannot
    diverge."""
    if quantizer not in ("pq", "int8"):
        return vecs, None
    scale = np.maximum(np.abs(vecs).max(axis=1) / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(vecs / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


class InvertedExpertIndex:
    def __init__(self, dim: int, num_docs: int, cls_dim: Optional[int] = None):
        self.dim = dim
        self.num_docs = num_docs
        self.cls_dim = cls_dim
        # per add_batch: (expert ids, corpus rows, weights, weighted vectors)
        self._building: List[Tuple[np.ndarray, ...]] = []
        self._cls_chunks: List[Tuple[np.ndarray, np.ndarray]] = []
        self.experts: Dict[int, _ExpertPostings] = {}
        self.cls: Optional[np.ndarray] = None
        self.latency: Dict[str, float] = collections.defaultdict(float)

    # ------------------------------------------------------------- #
    # building (GenerateMultiVecEmbeddingsTask, citadel_eval_task.py:43-70)

    def add_batch(
        self,
        corpus_rows: Sequence[int],
        encoder_out: Dict[str, np.ndarray],
        weight_threshold: float = 0.0,
    ) -> None:
        """Consume a MultiVecEncoder output dict for a batch of contexts.

        Vectorized over the (row, token, k) routing grid; the postings of
        each expert keep the JAX package's order (row, then token, then k),
        and the experts the order of their first posting."""
        expert_ids = np.asarray(encoder_out["expert_ids"])
        expert_repr = np.asarray(encoder_out["expert_repr"], dtype=np.float32)
        attn = np.asarray(encoder_out["attention_mask"])
        weights = encoder_out.get("expert_weights")
        weights = None if weights is None else np.asarray(weights, dtype=np.float32)
        rows = np.asarray(list(corpus_rows), np.int64)
        if "cls_repr" in encoder_out:
            # rows tracked explicitly: postings address docs by corpus_rows,
            # so the CLS plane must too
            self._cls_chunks.append((rows, np.asarray(encoder_out["cls_repr"], np.float32)))

        n = len(rows)
        citadel = expert_ids.ndim == 3  # else COIL / lexical: expert id = token id
        eid = (expert_ids if citadel else expert_ids[..., None])[:n]
        if weights is None:  # weight 1
            w = np.ones(eid.shape, np.float32)
        else:
            w = (weights if citadel else weights[..., None])[:n]
        live = (attn[:n, :, None] > 0) & (eid >= 0) & (w > weight_threshold)
        b, t, k = np.nonzero(live)
        ws = w[b, t, k]
        self._building.append(
            (eid[b, t, k].astype(np.int64), rows[b], ws, ws[:, None] * expert_repr[b, t])
        )

    def finalize(self, quantizer: Optional[str] = None) -> None:
        if self._building:
            e, ids, ws, vecs = (np.concatenate(parts) for parts in zip(*self._building))
            order = np.argsort(e, kind="stable")
            experts, first, counts = np.unique(e[order], return_index=True, return_counts=True)
            # experts in the order of their first posting (the JAX dict order)
            for j in np.argsort(order[first], kind="stable"):
                sel = order[first[j] : first[j] + counts[j]]
                v, scale = _maybe_quantize(vecs[sel], quantizer)
                self.experts[int(experts[j])] = _ExpertPostings(ids[sel], ws[sel], v, scale)
        self._building = []
        if self._cls_chunks:
            dc = self._cls_chunks[0][1].shape[1]
            self.cls = np.zeros((self.num_docs, dc), np.float32)
            for rows, chunk in self._cls_chunks:
                self.cls[rows] = chunk
            self._cls_chunks = []

    # ------------------------------------------------------------- #
    # reference-format IO (citadel_eval_task.py:75-118)

    def save(self, ctx_embeddings_dir: str, shard_id: int = 0) -> None:
        out_dir = os.path.join(ctx_embeddings_dir, f"expert_{shard_id:04}")
        os.makedirs(out_dir, exist_ok=True)
        for e, p in self.experts.items():
            with open(os.path.join(out_dir, f"{e}.pkl"), "wb") as f:
                pickle.dump((p.doc_ids, p.weights, p.dense_vecs()), f, protocol=4)
        if self.cls is not None:
            with open(
                os.path.join(ctx_embeddings_dir, f"cls_{shard_id:04}.pkl"), "wb"
            ) as f:
                pickle.dump(self.cls, f, protocol=4)

    @classmethod
    def load(
        cls,
        ctx_embeddings_dir: str,
        num_docs: int,
        portion: float = 1.0,
        quantizer: Optional[str] = None,
        expert_shards: Optional[Sequence[int]] = None,
    ) -> "InvertedExpertIndex":
        """Load reference-format shards. ``portion`` keeps only the largest
        posting lists covering that fraction of postings
        (citadel_retrieval_task.py ``portion`` arg); ``expert_shards``
        restricts to given shard dirs (expert-parallel loading)."""
        shard_dirs = sorted(
            d
            for d in os.listdir(ctx_embeddings_dir)
            if d.startswith("expert_") and os.path.isdir(os.path.join(ctx_embeddings_dir, d))
        )
        if expert_shards is not None:
            keep = {f"expert_{s:04}" for s in expert_shards}
            shard_dirs = [d for d in shard_dirs if d in keep]
        merged: Dict[int, List[Tuple]] = collections.defaultdict(list)
        dim = None
        for sd in shard_dirs:
            full = os.path.join(ctx_embeddings_dir, sd)
            for name in os.listdir(full):
                if not name.endswith(".pkl"):
                    continue
                with open(os.path.join(full, name), "rb") as f:
                    ids, ws, vecs = pickle.load(f)
                ids = _to_numpy(ids).astype(np.int64)
                ws = _to_numpy(ws).astype(np.float32)
                vecs = _to_numpy(vecs).astype(np.float32)
                dim = vecs.shape[1]
                merged[int(name[:-4])].append((ids, ws, vecs))

        cls_parts = []
        for name in sorted(os.listdir(ctx_embeddings_dir)):
            if name.startswith("cls_") and name.endswith(".pkl"):
                with open(os.path.join(ctx_embeddings_dir, name), "rb") as f:
                    cls_parts.append(_to_numpy(pickle.load(f)).astype(np.float32))

        index = cls(dim or 0, num_docs, cls_parts[0].shape[1] if cls_parts else None)
        entries = []
        for e, parts in merged.items():
            ids = np.concatenate([p[0] for p in parts])
            ws = np.concatenate([p[1] for p in parts])
            vecs = np.concatenate([p[2] for p in parts])
            entries.append((e, ids, ws, vecs))
        if portion < 1.0:
            entries.sort(key=lambda x: -len(x[1]))
            total = sum(len(x[1]) for x in entries)
            budget = portion * total
            kept, acc = [], 0
            for x in entries:
                if acc >= budget:
                    break
                kept.append(x)
                acc += len(x[1])
            entries = kept
        for e, ids, ws, vecs in entries:
            vecs, scale = _maybe_quantize(vecs, quantizer)
            index.experts[e] = _ExpertPostings(ids, ws, vecs, scale)
        if cls_parts:
            index.cls = np.concatenate(cls_parts, axis=0)
            if index.cls.shape[0] != num_docs:
                raise ValueError(
                    f"cls shards cover {index.cls.shape[0]} rows but the index "
                    f"holds {num_docs} docs — shards must be contiguous in "
                    "corpus order (reference emission format)"
                )
        return index

    # ------------------------------------------------------------- #
    # search (CITADELRetrievalTask._eval_step + missing IVF index API)

    def search(
        self,
        query_out: Dict[str, np.ndarray],
        topk: int = 100,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Search a batch of encoded queries.

        query_out is a MultiVecEncoder output dict (query side). Returns
        (scores (B, topk), doc_rows (B, topk)).
        """
        tic = time.perf_counter()
        expert_ids = np.asarray(query_out["expert_ids"])
        expert_repr = np.asarray(query_out["expert_repr"], dtype=np.float32)
        attn = np.asarray(query_out["attention_mask"])
        weights = query_out.get("expert_weights")
        weights = None if weights is None else np.asarray(weights, np.float32)
        B = expert_repr.shape[0]
        citadel = expert_ids.ndim == 3

        # flatten routed query entries, grouped by expert
        by_expert: Dict[int, List[Tuple[int, np.ndarray]]] = collections.defaultdict(list)
        for b in range(B):
            for t in np.flatnonzero(attn[b] > 0):
                vec = expert_repr[b, t]
                if citadel:
                    for kk in range(expert_ids.shape[2]):
                        e = int(expert_ids[b, t, kk])
                        w = float(weights[b, t, kk])
                        if e >= 0 and w > 0 and e in self.experts:
                            by_expert[e].append((b, w * vec))
                else:
                    e = int(expert_ids[b, t])
                    w = 1.0 if weights is None else float(weights[b, t])
                    if e >= 0 and w > 0 and e in self.experts:
                        by_expert[e].append((b, w * vec))
        self.latency["routing_time"] += time.perf_counter() - tic

        tic = time.perf_counter()
        acc = np.zeros((B, self.num_docs), dtype=np.float32)
        for e, entries in by_expert.items():
            posts = self.experts[e]
            qmat = np.stack([v for _b, v in entries])  # (nq_e, D)
            rows = np.asarray([b for b, _v in entries])
            sims = qmat @ posts.dense_vecs().T  # (nq_e, n_post)
            sims_sorted = sims[:, posts.sort_order]
            group_max = np.maximum.reduceat(
                sims_sorted, posts.group_starts, axis=1
            )  # (nq_e, n_docs_e)
            # zero floor: the training objective's MaxSim runs over gated
            # scores where non-matching pairs contribute 0 (citadel_task.py
            # :207-228), so an all-negative expert match scores 0 there too
            group_max = np.maximum(group_max, 0.0)
            np.add.at(acc, (rows[:, None], posts.group_docs[None, :]), group_max)
        self.latency["search_time"] += time.perf_counter() - tic

        if self.cls is not None and "cls_repr" in query_out:
            tic = time.perf_counter()
            acc += np.asarray(query_out["cls_repr"], np.float32) @ self.cls.T
            self.latency["cls_time"] += time.perf_counter() - tic

        tic = time.perf_counter()
        k = min(topk, self.num_docs)
        part = np.argpartition(-acc, k - 1, axis=1)[:, :k]
        part_scores = np.take_along_axis(acc, part, axis=1)
        order = np.argsort(-part_scores, kind="stable", axis=1)
        self.latency["topk_time"] += time.perf_counter() - tic
        return (
            np.take_along_axis(part_scores, order, axis=1),
            np.take_along_axis(part, order, axis=1),
        )

    # ------------------------------------------------------------- #

    def stats(self) -> Dict[str, float]:
        n_posts = sum(len(p.doc_ids) for p in self.experts.values())
        return {
            "num_experts": len(self.experts),
            "num_postings": n_posts,
            "avg_postings_per_expert": n_posts / max(1, len(self.experts)),
        }


def _to_numpy(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if hasattr(x, "numpy"):
        return x.numpy()
    return np.asarray(x)
