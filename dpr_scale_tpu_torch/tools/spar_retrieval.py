"""SPAR retrieval: combine a base and a lexical embedding directory and
search them on one device (the port's twin of the repo-root
``tools/spar_retrieval.py``; the reference's spar/spar_retrieval.py:101-222).

Usage:
    python -m dpr_scale_tpu_torch.tools.spar_retrieval \
        --jsonl_dataset_paths nq-test.csv \
        --tsv_passages_path psgs.tsv \
        --ctx_embeddings_dir_1 base_embs/ --ctx_embeddings_dir_2 lambda_embs/ \
        --output_dir out/ --output_filenames nq.json \
        --weights 0.7 [--pooling concat] [--save_embeddings] [--device cuda:0]

Each embedding directory holds ``reps_*`` shards of the same passages and,
per dataset, a query embedding file (``--query_emb_names``, default
``query_reps.pkl``). See :mod:`dpr_scale_tpu_torch.retrieve.spar`.
"""
from __future__ import annotations

import argparse

from dpr_scale_tpu_torch.data.datasets import QueryCSVDataset, QueryTSVDataset
from dpr_scale_tpu_torch.retrieve.spar import run_spar_retrieval


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--jsonl_dataset_paths", nargs="+", required=True)
    parser.add_argument("--tsv_passages_path", required=True)
    parser.add_argument("--ctx_embeddings_dir_1", required=True)
    parser.add_argument("--ctx_embeddings_dir_2", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_filenames", nargs="+", required=True)
    parser.add_argument("--query_emb_names", nargs="+", default=["query_reps.pkl"])
    parser.add_argument("--weights", nargs="+", type=float, default=None)
    parser.add_argument("--pooling", default="concat", choices=["concat", "mean", "sum"])
    parser.add_argument("--save_embeddings", action="store_true")
    parser.add_argument("--topk", type=int, default=100)
    parser.add_argument("--trec_format", action="store_true")
    parser.add_argument("--device", default=None, help="default: cuda:0")
    args = parser.parse_args(argv)

    if not len(args.jsonl_dataset_paths) == len(args.output_filenames) == len(args.query_emb_names):
        parser.error("dataset / query-embedding / output lists must be the same length")
    if args.weights is not None and len(args.weights) != len(args.jsonl_dataset_paths):
        parser.error("--weights must give one weight per dataset")

    questions_list = []
    for path in args.jsonl_dataset_paths:
        ds = QueryTSVDataset(path) if args.trec_format else QueryCSVDataset(path)
        questions_list.append([ds[i] for i in range(len(ds))])

    paths = run_spar_retrieval(
        questions_list,
        args.tsv_passages_path,
        args.ctx_embeddings_dir_1,
        args.ctx_embeddings_dir_2,
        args.output_dir,
        args.output_filenames,
        device=args.device,
        query_emb_names=args.query_emb_names,
        weights=args.weights,
        save_embeddings=args.save_embeddings,
        topk=args.topk,
        pooling=args.pooling,
    )
    for p in paths:
        print(f"Wrote {p}")
    return paths


if __name__ == "__main__":
    main()
