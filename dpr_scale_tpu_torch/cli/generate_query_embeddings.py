"""Query embedding generation on one device.

Usage:
    python -m dpr_scale_tpu_torch.cli.generate_query_embeddings --config conf/nq.yaml \
        datamodule.test_path=nq-test.csv \
        task.ctx_embeddings_dir=/out/embs [--device cuda:0]

Encodes the questions of ``datamodule.test_path`` (CSV ``question \\t
answers``, or TREC ``qid \\t query`` with ``datamodule.trec_format=true``)
with the query tower and writes ``query_reps.pkl`` into
``task.ctx_embeddings_dir`` (or ``task.query_emb_output_path``): a
protocol-4 pickle of an fp32 numpy array, which the JAX package's loader
reads. The weights are initialised from a seed (``task.checkpoint_path``
raises: orbax checkpoints need jax).
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from dpr_scale_tpu_torch.cli.common import (
    build_biencoder,
    build_model_config,
    build_tokenizer,
    check_vocab_compat,
)
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.data.datamodule import QueriesDataModule
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder


def queries_datamodule(cfg, tokenizer) -> QueriesDataModule:
    d = cfg.datamodule
    return QueriesDataModule(
        tokenizer,
        d["test_path"],
        batch_size=d.get("encode_batch_size", 128),
        trec_format=d.get("trec_format", False),
    )


def encode_queries(cfg, model, tokenizer, device, out_dir) -> str:
    """Encode the config's questions with ``model``'s query tower and write
    the pickle; returns its path."""
    encoder = CorpusEncoder(model, device, use_query_tower=True)
    emb, _ids = encoder.encode_batches(queries_datamodule(cfg, tokenizer).batches())
    os.makedirs(out_dir, exist_ok=True)
    path = cfg.task.get("query_emb_output_path") or os.path.join(out_dir, "query_reps.pkl")
    with open(path, "wb") as f:
        pickle.dump(np.ascontiguousarray(emb), f, protocol=4)
    print(f"Wrote {path} ({emb.shape[0]} queries)")
    return path


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
    model = build_biencoder(cfg, device)
    out_dir = cfg.task.get("ctx_embeddings_dir", "embeddings")
    return encode_queries(cfg, model, tokenizer, device, out_dir)


if __name__ == "__main__":
    main()
