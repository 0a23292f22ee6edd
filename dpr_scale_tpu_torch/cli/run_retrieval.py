"""End-to-end retrieval on one device: load (or encode) the query
embeddings, search every ``reps_*`` shard exactly, join the passages and
write DPR JSON / a TREC run.

Usage:
    python -m dpr_scale_tpu_torch.cli.run_retrieval --config conf/nq.yaml \
        task.ctx_embeddings_dir=/out/embs \
        datamodule.test_path=nq-test.csv \
        datamodule.passages_path=psgs_w100.tsv \
        task.output_path=/out/retrieval.json \
        [task.mips_method=fused|groupmax|auto|approx|exact_sort|int8|int4] \
        [task.rerank_oversample=4] [task.int8_query_planes=2] [--device cuda:0]

The query embeddings come from ``task.query_emb_path`` or
``<ctx_embeddings_dir>/query_reps.pkl`` when that file exists (as
``cli.generate_query_embeddings`` writes it); otherwise the query tower,
initialised from a seed, encodes the questions.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from dpr_scale_tpu_torch.cli.common import (
    build_biencoder,
    build_model_config,
    build_tokenizer,
    check_vocab_compat,
)
from dpr_scale_tpu_torch.cli.generate_query_embeddings import queries_datamodule
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder, load_embedding_shard
from dpr_scale_tpu_torch.retrieve.retrieval import retrieve


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
    emb_dir = t["ctx_embeddings_dir"]
    qrep_path = t.get("query_emb_path") or os.path.join(emb_dir, "query_reps.pkl")
    dm = queries_datamodule(cfg, tokenizer)
    if os.path.exists(qrep_path):
        q_emb = np.asarray(load_embedding_shard(qrep_path), dtype=np.float32)
        print(f"Loaded query embeddings {q_emb.shape} from {qrep_path}")
    else:
        encoder = CorpusEncoder(build_biencoder(cfg, device), device, use_query_tower=True)
        q_emb, _ = encoder.encode_batches(dm.batches())
        print(f"Encoded {q_emb.shape[0]} queries")

    questions = dm.rows()
    if len(questions) != q_emb.shape[0]:
        raise ValueError(f"{len(questions)} questions vs {q_emb.shape[0]} query embeddings")

    results = retrieve(
        q_emb,
        questions,
        passages_path=cfg.datamodule["passages_path"],
        ctx_embeddings_dir=emb_dir,
        device=device,
        k=t.get("topk", 100),
        output_json_path=t.get("output_path"),
        output_trec_path=t.get("output_trec_path"),
        ignore_identical_ids=t.get("ignore_identical_ids", False),
        query_batch=t.get("query_batch", 512),
        host_resident=t.get("host_resident_index", False),
        method=t.get("mips_method", "fused"),
        int8_query_planes=t.get("int8_query_planes"),
        rerank_oversample=t.get("rerank_oversample"),
        index_store=t.get("index_store"),
        device_rows=t.get("device_rows"),
    )
    print(f"Retrieved top-{t.get('topk', 100)} for {len(results)} questions")
    if t.get("output_path"):
        print(f"Wrote {t['output_path']}")
    return results


if __name__ == "__main__":
    main()
