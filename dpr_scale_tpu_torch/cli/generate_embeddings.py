"""Corpus embedding generation on one device.

Usage:
    python -m dpr_scale_tpu_torch.cli.generate_embeddings --config conf/nq.yaml \
        datamodule.passages_path=psgs_w100.tsv \
        task.ctx_embeddings_dir=/out/embs \
        task.shard=0 task.num_shards=1 [--device cuda:0]

Writes ``reps_{shard:04}.pkl`` (fp32 numpy pickle, readable by the JAX
package's loader) for the contiguous corpus rows of ``task.shard``. The
weights are initialised from a seed: ``task.checkpoint_path`` (an orbax
checkpoint) cannot be read without jax and raises; so do
``task.exported_encoder_path`` and ``task.quantized_checkpoint_path``, whose
readers are not ported (ROADMAP A8).
"""
from __future__ import annotations

import argparse

from dpr_scale_tpu_torch.cli.common import (
    build_biencoder,
    build_model_config,
    build_tokenizer,
    check_vocab_compat,
    refuse_worker_processes,
)
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.data.datamodule import PassagesDataModule, contiguous_shard
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default=None, help="default: cuda:0")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    for key in ("exported_encoder_path", "quantized_checkpoint_path"):
        if cfg.task.get(key):
            raise NotImplementedError(
                f"task.{key}={cfg.task[key]!r}: the exported and weight-only int8 "
                "encoders are not ported (ROADMAP A8)"
            )
    device = resolve_device(args.device)

    tokenizer = build_tokenizer(cfg)
    check_vocab_compat(tokenizer, build_model_config(cfg))
    model = build_biencoder(cfg, device)
    out_dtype = {"float32": "float32", "float16": "float16"}[
        cfg.task.get("embeddings_dtype", "float32")
    ]
    d = cfg.datamodule
    refuse_worker_processes(cfg)
    dm = PassagesDataModule(
        tokenizer,
        d["passages_path"],
        batch_size=d.get("encode_batch_size", 128),
        use_title=d.get("use_title", True),
        sep_token=d.get("sep_token"),
    )
    shard = cfg.task.get("shard", 0)
    num_shards = cfg.task.get("num_shards", 1)
    encoder = CorpusEncoder(model, device, out_dtype=out_dtype)
    rows = contiguous_shard(len(dm), shard, num_shards)
    try:
        path = encoder.encode_to_dir(
            dm.batches(shard, num_shards),
            cfg.task.get("ctx_embeddings_dir", "embeddings"),
            shard_id=shard,
            num_shards=num_shards,
            fmt=cfg.task.get("embeddings_format", "pickle"),
            corpus_offset=rows.start,
        )
    finally:
        dm.close()
    print(f"Wrote {path} ({len(rows)} rows)")
    return path


if __name__ == "__main__":
    main()
