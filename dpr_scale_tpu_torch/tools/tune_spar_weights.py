"""SPAR concat-weight grid search by joint-pool reranking, one dataset or
several (the port's twin of the repo-root ``tools/tune_spar_weights.py``;
the reference's spar/spar_weight_tuning.py, grid_search_weights :101-147 and
its multiset driver :200-224, and dpr_scale/utils/tune_spar_weights.py).

For each candidate weight, the union of the two models' top-k is rescored
with the combined score and judged by answer recall (the
``evaluate_retrieval`` semantics); the best weight is chosen on
recall@valid_on_k. Host numpy, as in the JAX tool.

Usage (one dataset):
    python -m dpr_scale_tpu_torch.tools.tune_spar_weights \
        --queries nq-dev.csv \
        --tsv_passages_path psgs.tsv \
        --ctx_embeddings_dir_1 base/ --ctx_embeddings_dir_2 lambda/ \
        [--weights 0.3 0.5 0.7 1.0 1.43] [--topk 100] [--eval_on_ks 20 100]

Usage (several datasets: one query file, embedding name and regex flag each):
    python -m dpr_scale_tpu_torch.tools.tune_spar_weights \
        --queries nq-dev.csv trec-dev.csv \
        --query_emb_names query_reps_nq.pkl query_reps_trec.pkl \
        --use_regex 0 1 \
        --tsv_passages_path psgs.tsv \
        --ctx_embeddings_dir_1 base/ --ctx_embeddings_dir_2 lambda/
"""
from __future__ import annotations

import argparse
import json
import os

from dpr_scale_tpu_torch.data.datasets import CSVDataset, QueryCSVDataset
from dpr_scale_tpu_torch.eval.qa_eval import SimpleTokenizer, has_answers
from dpr_scale_tpu_torch.retrieve.spar import (
    load_dir_embeddings,
    load_query_embeddings,
    tune_spar_weight,
)


def tune_dataset(
    name,
    questions,
    passages,
    tokenizer,
    q1,
    q2,
    p1,
    p2,
    weights,
    topk,
    eval_on_ks,
    valid_on_k,
    regex,
):
    """Grid-search one dataset; returns {weight: {k: recall}} + best."""
    all_recalls = {}

    def judge(weight, per_query_indices):
        hits_at = {k: 0 for k in eval_on_ks}
        for qi, rows in enumerate(per_query_indices):
            answers = questions[qi]["answers"]
            first_hit = None
            for rank, row in enumerate(rows[: max(eval_on_ks)]):
                if has_answers(
                    passages[int(row)]["text"], answers, tokenizer, regex=regex
                ):
                    first_hit = rank
                    break
            if first_hit is not None:
                for k in eval_on_ks:
                    if first_hit < k:
                        hits_at[k] += 1
        recalls = {k: hits_at[k] / len(per_query_indices) for k in eval_on_ks}
        all_recalls[weight] = recalls
        print(
            f"[{name}] weight={weight}: "
            + " ".join(f"recall@{k}={recalls[k]:.4f}" for k in eval_on_ks)
        )
        return recalls[valid_on_k]

    out = tune_spar_weight(q1, q2, p1, p2, judge, weights=weights, topk=topk)
    out["recalls"] = all_recalls
    print(f"[{name}] best weight: {out['best_weight']}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--queries", nargs="+", required=True,
        help="query CSV(s) with answers — one per dataset",
    )
    parser.add_argument("--tsv_passages_path", required=True)
    parser.add_argument("--ctx_embeddings_dir_1", required=True)
    parser.add_argument("--ctx_embeddings_dir_2", required=True)
    parser.add_argument(
        "--query_emb_names", nargs="+", default=["query_reps.pkl"],
        help="query embedding filename per dataset (in both ctx dirs)",
    )
    parser.add_argument(
        "--use_regex", nargs="*", type=int, default=None,
        help="0/1 per dataset: regex answer matching (reference TREC flag)",
    )
    parser.add_argument(
        "--weights", nargs="+", type=float,
        default=[0.1, 0.3, 0.5, 0.7, 0.9, 1.0, 1.25, 1.43, 2.0],
    )
    parser.add_argument("--topk", type=int, default=100)
    parser.add_argument("--eval_on_ks", nargs="+", type=int, default=[20, 100])
    parser.add_argument(
        "--valid_on_k", type=int, default=None,
        help="select the best weight on recall@this-k (default: max eval k; "
        "reference valid_on_k=100)",
    )
    parser.add_argument("--output_json", default=None)
    # legacy alias for the old single-dataset flag
    parser.add_argument("--judge_k", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    n_sets = len(args.queries)
    if len(args.query_emb_names) == 1 and n_sets > 1:
        parser.error("--query_emb_names must list one file per dataset")
    assert len(args.query_emb_names) == n_sets
    regexes = args.use_regex if args.use_regex is not None else [0] * n_sets
    assert len(regexes) == n_sets
    if args.judge_k is not None:  # legacy: judge_k == eval and valid k
        args.eval_on_ks = sorted(set(args.eval_on_ks + [args.judge_k]))
        args.valid_on_k = args.judge_k
    valid_on_k = args.valid_on_k or max(args.eval_on_ks)
    assert valid_on_k in args.eval_on_ks

    passages = CSVDataset(args.tsv_passages_path)
    tokenizer = SimpleTokenizer()
    # context embeddings are shared across datasets: load once
    p1 = load_dir_embeddings(args.ctx_embeddings_dir_1)
    p2 = load_dir_embeddings(args.ctx_embeddings_dir_2)

    results = {}
    for qpath, emb_name, regex in zip(args.queries, args.query_emb_names, regexes):
        name = os.path.basename(qpath)
        queries = QueryCSVDataset(qpath)
        questions = [queries[i] for i in range(len(queries))]
        q1 = load_query_embeddings(args.ctx_embeddings_dir_1, emb_name)
        q2 = load_query_embeddings(args.ctx_embeddings_dir_2, emb_name)
        results[name] = tune_dataset(
            name, questions, passages, tokenizer, q1, q2, p1, p2,
            args.weights, args.topk, args.eval_on_ks, valid_on_k, bool(regex),
        )

    summary = {name: out["best_weight"] for name, out in results.items()}
    print("Best weights per dataset:", json.dumps(summary))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(
                {
                    name: {
                        "best_weight": out["best_weight"],
                        "recalls": {
                            str(w): r for w, r in out["recalls"].items()
                        },
                    }
                    for name, out in results.items()
                },
                f,
                indent=2,
            )
    return results


if __name__ == "__main__":
    main()
