"""Retrieval output writers.

The port's copy of ``dpr_scale_tpu/retrieve/writers.py``; the formats stay
byte-equal to the JAX package's (SURVEY.md §1 data formats):
  * DPR JSON — ``{"question","answers","ctxs":[{"id","title","text","score"}],"id"}``
    (reference run_retrieval.py:17-45 merge_results);
  * TREC run — ``qid Q0 docid rank score runname``
    (reference run_retrieval_pytorch.py:284-291), with the BEIR
    ``ignore_identical_ids`` option to drop a doc matching its query id.
"""
from __future__ import annotations

import json
from typing import Sequence


def write_dpr_json(
    out_path: str,
    questions: Sequence[dict],  # {"question", "answers", optional "id"}
    results: Sequence[Sequence[dict]],  # per question: [{"id","title","text","score"}]
) -> None:
    payload = []
    for i, (q, ctxs) in enumerate(zip(questions, results)):
        item = {
            "question": q["question"],
            "answers": q.get("answers", []),
            "ctxs": list(ctxs),
        }
        item["id"] = q.get("id", i)
        payload.append(item)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=4)


def write_trec_run(
    out_path: str,
    qids: Sequence[str],
    docids_per_query: Sequence[Sequence[str]],
    scores_per_query: Sequence[Sequence[float]],
    run_name: str = "dpr_scale_tpu",
    ignore_identical_ids: bool = False,
) -> None:
    with open(out_path, "w") as f:
        for qid, docids, scores in zip(qids, docids_per_query, scores_per_query):
            rank = 1
            for docid, score in zip(docids, scores):
                if ignore_identical_ids and str(docid) == str(qid):
                    continue
                f.write(f"{qid} Q0 {docid} {rank} {score:.6f} {run_name}\n")
                rank += 1
