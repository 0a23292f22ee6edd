"""MS MARCO / TREC-style ranking evaluation.

Parity with reference dpr_scale/msmarco_eval.py:
  * MRR@10 with the duplicate-pid quality check (:118-178);
  * qrels TSV (``qid 0 pid rel``), candidate TSV (``qid pid rank``),
    DPR-JSON candidates (:21-92), plus TREC run files (6 columns);
  * the second-pass TREC metrics (map_cut / ndcg_cut / recip_rank /
    recall@{20,50,100,1000}) — the reference shells out to pytrec_eval
    (C++); here they are computed natively (pure Python/numpy) and
    validated against hand-computed values in the test suite
    (tests/test_index_retrieve.py::test_msmarco_eval_metrics,
    ::test_trec_metrics_ndcg).

The port's copy of ``dpr_scale_tpu.eval.msmarco`` (the port imports nothing
of the JAX package):

    python -m dpr_scale_tpu_torch.eval.msmarco qrels.tsv run.trec
"""
from __future__ import annotations

import json
import math
import sys
from collections import Counter
from typing import Dict, List, Mapping, Sequence, Tuple

MAX_MRR_RANK = 10


# --------------------------------------------------------------------- #
# loading

def load_qrels(path: str) -> Dict[str, Dict[str, int]]:
    """qrels TSV ``qid <it> pid rel`` (whitespace or tab separated)."""
    ref: Dict[str, Dict[str, int]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            qid, pid, rel = parts[0], parts[2], int(parts[3]) if len(parts) > 3 else 1
            ref.setdefault(qid, {})[pid] = rel
    return ref


def load_candidates(path: str) -> Dict[str, List[str]]:
    """Ranked candidate pids per qid from TSV / TREC run / DPR JSON."""
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        return {str(row["id"]): [str(c["id"]) for c in row["ctxs"]] for row in data}
    out: Dict[str, Dict[int, str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 6:  # TREC run: qid Q0 pid rank score run
                qid, pid, rank = parts[0], parts[2], int(parts[3])
            else:  # MS MARCO: qid pid rank
                qid, pid, rank = parts[0], parts[1], int(parts[2])
            out.setdefault(qid, {})[rank] = pid
    return {
        qid: [pid for _rank, pid in sorted(ranks.items())] for qid, ranks in out.items()
    }


# --------------------------------------------------------------------- #
# metrics

def quality_check(candidates: Mapping[str, Sequence[str]]) -> Tuple[bool, str]:
    """No passage may be ranked twice for one query (msmarco_eval.py:118-145)."""
    for qid, pids in candidates.items():
        dupes = {p for p, c in Counter(pids).items() if c > 1} - {"0"}
        if dupes:
            return False, (
                f"Cannot rank a passage multiple times for a single query. "
                f"QID={qid}, PID={next(iter(dupes))}"
            )
    return True, ""


def mrr_at_10(
    qrels: Mapping[str, Mapping[str, int]], candidates: Mapping[str, Sequence[str]]
) -> Dict[str, float]:
    mrr = 0.0
    matched = 0
    for qid, pids in candidates.items():
        if qid not in qrels:
            continue
        matched += 1
        relevant = qrels[qid]
        for i, pid in enumerate(pids[:MAX_MRR_RANK]):
            if pid in relevant:
                mrr += 1.0 / (i + 1)
                break
    if matched == 0:
        raise IOError(
            "No matching QIDs found. Are you sure you are scoring the evaluation set?"
        )
    return {
        "MRR @10": mrr / len(qrels),
        "QueriesRanked": len(candidates),
    }


def _dcg(rels: Sequence[int]) -> float:
    return sum(r / math.log2(i + 2) for i, r in enumerate(rels))


def trec_metrics(
    qrels: Mapping[str, Mapping[str, int]],
    candidates: Mapping[str, Sequence[str]],
    ndcg_cuts: Sequence[int] = (10,),
    map_cuts: Sequence[int] = (10,),
    recall_cuts: Sequence[int] = (20, 50, 100, 1000),
) -> Dict[str, float]:
    """Native ndcg_cut / map_cut / recip_rank / recall@k, averaged over the
    qrels-covered queries (trec_eval conventions: binary rel>0 for
    map/recall/recip_rank, graded gains for ndcg, log2 discounts)."""
    per_q: Dict[str, List[float]] = {}
    covered = [qid for qid in candidates if qid in qrels]
    for qid in covered:
        relevant = qrels[qid]
        pos = {p for p, r in relevant.items() if r > 0}
        ranked = list(candidates[qid])
        rels = [relevant.get(p, 0) for p in ranked]

        # recip_rank
        rr = 0.0
        for i, p in enumerate(ranked):
            if p in pos:
                rr = 1.0 / (i + 1)
                break
        per_q.setdefault("recip_rank", []).append(rr)

        # ndcg_cut
        ideal = sorted(relevant.values(), reverse=True)
        for c in ndcg_cuts:
            dcg = _dcg(rels[:c])
            idcg = _dcg(ideal[:c])
            per_q.setdefault(f"ndcg_cut_{c}", []).append(
                dcg / idcg if idcg > 0 else 0.0
            )

        # map_cut (AP over top-c, normalized by total relevant)
        for c in map_cuts:
            hits = 0
            ap = 0.0
            for i, p in enumerate(ranked[:c]):
                if p in pos:
                    hits += 1
                    ap += hits / (i + 1)
            per_q.setdefault(f"map_cut_{c}", []).append(
                ap / len(pos) if pos else 0.0
            )

        # recall@k
        for c in recall_cuts:
            got = sum(1 for p in ranked[:c] if p in pos)
            per_q.setdefault(f"recall_{c}", []).append(
                got / len(pos) if pos else 0.0
            )

    if not covered:
        return {}
    return {k: sum(v) / len(v) for k, v in per_q.items()}


def compute_metrics_from_files(
    path_to_reference: str, path_to_candidate: str, perform_checks: bool = True
) -> Dict[str, float]:
    qrels = load_qrels(path_to_reference)
    candidates = load_candidates(path_to_candidate)
    if perform_checks:
        ok, message = quality_check(candidates)
        if message:
            print(message)
    metrics = mrr_at_10(qrels, candidates)
    metrics.update(trec_metrics(qrels, candidates))
    return metrics


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("Usage: msmarco_eval <qrels.tsv> <candidate file (tsv/trec/json)>")
        return None
    metrics = compute_metrics_from_files(argv[0], argv[1])
    print("#####################")
    for name in sorted(metrics):
        print(f"{name}: {metrics[name]}")
    print("#####################")
    return metrics


if __name__ == "__main__":
    main()
