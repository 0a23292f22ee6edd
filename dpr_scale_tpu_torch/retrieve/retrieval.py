"""End-to-end retrieval: query embeddings + embedding shards -> top-k results.

Counterpart of :mod:`dpr_scale_tpu.retrieve.retrieval`: load every
``reps_*`` shard into one :class:`~dpr_scale_tpu_torch.index.mips.MipsIndex`
(global row order = shard order = corpus order), search the queries in
batches, join (scores, global row ids) with the passages and write DPR JSON
and/or a TREC run. ``rerank_oversample`` attaches the host exact-rerank tier
over the shards' original rows (``ShardRowReader``) to a lossy index;
``int8_query_planes`` sets the quantised tiers' query planes.
``host_resident`` keeps every block in host memory and streams it through
the device at each search; ``index_store`` (int8 only) serves from the
prequantised store of :mod:`dpr_scale_tpu_torch.index.store`, built first
when it is absent or stale, with the device tier capped at ``device_rows``
rows and the rest streamed from the host.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dpr_scale_tpu_torch.data.datasets import CSVDataset
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.encode.embeddings import ShardRowReader, load_embedding_shards
from dpr_scale_tpu_torch.index.mips import LOSSY, MipsIndex
from dpr_scale_tpu_torch.retrieve.writers import write_dpr_json, write_trec_run


def rows_to_ctxs(passages, scores, indices) -> List[List[Dict]]:
    """Join (B, k) scores / global row ids with the passage TSV into DPR ctx
    dicts; row -1 (a masked pad row) is skipped."""
    results: List[List[Dict]] = []
    for qi in range(scores.shape[0]):
        ctxs = []
        for score, row in zip(scores[qi], indices[qi]):
            if row < 0:
                continue
            p = passages[int(row)]
            ctxs.append(
                {
                    "id": p.get("id", str(int(row))),
                    "title": p.get("title", ""),
                    "text": p.get("text", ""),
                    "score": float(score),
                }
            )
        results.append(ctxs)
    return results


def build_index(
    ctx_embeddings_dir: str,
    device,
    dtype=torch.bfloat16,
    max_block_rows: int = 2_000_000,
    host_resident: bool = False,
    method: str = "fused",
    index_store: Optional[str] = None,
    device_rows: Optional[int] = None,
) -> MipsIndex:
    """Every ``reps_*`` shard of a directory in one index; shards larger than
    ``max_block_rows`` split into several blocks. ``index_store`` (int8
    only): load the store there, (re)built from the shards first when it is
    absent or stale; ``device_rows`` caps its device tier."""
    index = MipsIndex(device, dtype=dtype, method=method, host_resident=host_resident)
    if index_store is not None:
        if method != "int8":
            raise ValueError("index_store requires mips_method=int8")
        from dpr_scale_tpu_torch.index.store import (
            build_int8_store,
            load_int8_store,
            store_is_current,
        )

        if not store_is_current(index_store, ctx_embeddings_dir):
            print(f"Building int8 index store at {index_store}")
            build_int8_store(ctx_embeddings_dir, index_store, max_block_rows=max_block_rows)
        load_int8_store(index, index_store, device_rows=device_rows)
        return index
    shards = load_embedding_shards(ctx_embeddings_dir)
    if not shards:
        raise FileNotFoundError(f"no reps_* shards in {ctx_embeddings_dir}")
    for _name, emb in shards:
        for lo in range(0, emb.shape[0], max_block_rows):
            index.add(emb[lo : lo + max_block_rows])
    return index


def retrieve(
    query_embeddings: np.ndarray,  # (B, D)
    questions: Sequence[dict],  # rows with "question"/"answers" or "id"
    passages_path: str,
    ctx_embeddings_dir: str,
    device=None,
    k: int = 100,
    output_json_path: Optional[str] = None,
    output_trec_path: Optional[str] = None,
    query_batch: int = 512,
    ignore_identical_ids: bool = False,
    index: Optional[MipsIndex] = None,
    host_resident: bool = False,
    method: str = "fused",
    int8_query_planes: Optional[int] = None,
    index_store: Optional[str] = None,
    device_rows: Optional[int] = None,
    rerank_oversample: Optional[int] = None,
) -> List[List[Dict]]:
    """Per-question context lists; optionally writes the output files.

    Without ``index`` one is built from the shards on ``device`` (default
    ``cuda:0``) with ``method``; a given index is searched with its own
    method. The last query batch is padded with zero queries up to
    ``query_batch`` and the pads' results dropped.

    ``rerank_oversample`` (a lossy index only: int8, int4, approx): the
    device search fetches ``rerank_oversample * k`` candidates and the host
    rescores them against the shards' rows. ``int8_query_planes`` applies
    to a given index too; None leaves its setting alone."""
    if index is None:
        index = build_index(
            ctx_embeddings_dir, resolve_device(device), host_resident=host_resident,
            method=method, index_store=index_store, device_rows=device_rows,
        )
    if rerank_oversample:
        # the index searched decides: a given one ignores ``method``
        if index.method not in LOSSY:
            raise ValueError(
                f"rerank_oversample requires a lossy mips_method (index.method={index.method!r})"
            )
        index.set_rerank(ShardRowReader(ctx_embeddings_dir), oversample=int(rerank_oversample))
    if int8_query_planes is not None:
        index.int8_query_planes = int(int8_query_planes)
    passages = CSVDataset(passages_path)

    nq = query_embeddings.shape[0]
    if nq == 0:  # empty query set: empty outputs
        if output_json_path:
            with open(output_json_path, "w") as f:
                json.dump([], f)
        if output_trec_path:
            open(output_trec_path, "w").close()
        return []
    all_scores, all_indices = [], []
    for lo in range(0, nq, query_batch):
        q = query_embeddings[lo : lo + query_batch]
        pad = query_batch - q.shape[0]
        s, i = index.search(np.pad(q, ((0, pad), (0, 0))) if pad else q, k)
        all_scores.append(s[: q.shape[0]])
        all_indices.append(i[: q.shape[0]])
    results = rows_to_ctxs(
        passages, np.concatenate(all_scores, 0), np.concatenate(all_indices, 0)
    )

    if output_json_path:
        write_dpr_json(output_json_path, questions, results)
    if output_trec_path:
        qids = [str(q.get("id", i)) for i, q in enumerate(questions)]
        write_trec_run(
            output_trec_path,
            qids,
            [[c["id"] for c in ctxs] for ctxs in results],
            [[c["score"] for c in ctxs] for ctxs in results],
            ignore_identical_ids=ignore_identical_ids,
        )
    return results
