"""Multi-dataset retrieval on one device: build the MIPS index once, search
many query sets.

Usage:
    python -m dpr_scale_tpu_torch.cli.run_retrieval_multiset --config conf/nq.yaml \
        task.ctx_embeddings_dir=/embs \
        datamodule.passages_path=psgs.tsv \
        'task.query_sets=[{query_emb_path: q1.pkl, test_path: q1.csv, output_path: out1.json}, ...]' \
        [task.mips_method=fused|groupmax|auto|approx|exact_sort|int8|int4] [--device cuda:0]

Each query set names its query embeddings (``query_emb_path``), its
questions (``test_path``, ``trec_format``) and its outputs (``output_path``,
``output_trec_path``), as in the JAX CLI.
"""
from __future__ import annotations

import argparse

import numpy as np

from dpr_scale_tpu_torch.cli.common import build_model_config, build_tokenizer, check_vocab_compat
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.data.datamodule import QueriesDataModule
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.encode.embeddings import load_embedding_shard
from dpr_scale_tpu_torch.retrieve.retrieval import build_index, retrieve


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default=None, help="default: cuda:0")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    device = resolve_device(args.device)

    tokenizer = build_tokenizer(cfg)
    check_vocab_compat(tokenizer, build_model_config(cfg))
    t = cfg.task
    index = build_index(
        t["ctx_embeddings_dir"], device,
        host_resident=t.get("host_resident_index", False),
        method=t.get("mips_method", "fused"),
    )
    outputs = []
    for qs in t["query_sets"]:
        q_emb = np.asarray(load_embedding_shard(qs["query_emb_path"]), dtype=np.float32)
        dm = QueriesDataModule(tokenizer, qs["test_path"], trec_format=qs.get("trec_format", False))
        retrieve(
            q_emb,
            dm.rows(),
            passages_path=cfg.datamodule["passages_path"],
            ctx_embeddings_dir=t["ctx_embeddings_dir"],
            k=t.get("topk", 100),
            output_json_path=qs.get("output_path"),
            output_trec_path=qs.get("output_trec_path"),
            index=index,
        )
        outputs.append(qs.get("output_path"))
        print(f"Wrote {qs.get('output_path')}")
    return outputs


if __name__ == "__main__":
    main()
