"""Corpus embedding generation on one device.

Usage:
    python -m dpr_scale_tpu_torch.cli.generate_embeddings --config conf/nq.yaml \
        datamodule.passages_path=psgs_w100.tsv \
        task.ctx_embeddings_dir=/out/embs \
        task.shard=0 task.num_shards=1 [--device cuda:0] [--queries]

Writes ``reps_{shard:04}.pkl`` (fp32 numpy pickle, readable by the JAX
package's loader) for the contiguous corpus rows of ``task.shard``, with
the bi-encoder of ``task.model.family`` (vocab-sized SPLADE vectors for
``splade``). The weights come from ``task.checkpoint_path``, a params export
(``cli.train`` writes ``<dirpath>/params_best``; ``cli.convert_checkpoint``
converts HF and reference checkpoints; ``tools/orbax_params_to_npz.py``
bridges a JAX export), from ``task.quantized_checkpoint_path`` (weight-only
int8, ``utils.export.save_quantized``), or, when none is set, from a seed,
with a warning. ``task.exported_encoder_path`` drives the encode from an
exported program instead (``utils.export.export_encoder``; the reference's
TorchScript-checkpoint path). ``--queries`` encodes the questions of
``datamodule.test_path`` into ``query_reps.pkl`` instead (as
``cli.generate_query_embeddings``); an exported encoder cannot do that.
``datamodule.num_workers`` worker processes build the batches.
"""
from __future__ import annotations

import argparse

from dpr_scale_tpu_torch.cli.common import (
    build_biencoder,
    build_model_config,
    build_tokenizer,
    check_vocab_compat,
)
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.data.datamodule import PassagesDataModule, contiguous_shard
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default=None, help="default: cuda:0")
    parser.add_argument("--queries", action="store_true", help="encode queries instead")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    exported = cfg.task.get("exported_encoder_path")
    quantized = cfg.task.get("quantized_checkpoint_path")
    if args.queries and exported:
        raise ValueError(
            "--queries with task.exported_encoder_path is not supported: the exported "
            "program holds one tower at fixed shapes. Use task.checkpoint_path or "
            "task.quantized_checkpoint_path for query encoding."
        )
    device = resolve_device(args.device)

    tokenizer = build_tokenizer(cfg)
    check_vocab_compat(tokenizer, build_model_config(cfg))
    out_dir = cfg.task.get("ctx_embeddings_dir", "embeddings")
    out_dtype = {"float32": "float32", "float16": "float16"}[
        cfg.task.get("embeddings_dtype", "float32")
    ]
    if exported:
        encoder = CorpusEncoder.from_exported(exported, device, out_dtype=out_dtype)
        print(f"Using exported encoder from {exported}")
    else:
        if quantized:
            from dpr_scale_tpu_torch.utils.export import load_quantized

            model = build_biencoder(cfg, device, state_dict=load_quantized(quantized))
            print(f"Loaded int8-quantized params from {quantized}")
        else:
            model = build_biencoder(cfg, device)
        if args.queries:
            from dpr_scale_tpu_torch.cli.generate_query_embeddings import encode_queries

            return encode_queries(cfg, model, tokenizer, device, out_dir)
        encoder = CorpusEncoder(model, device, out_dtype=out_dtype)
    d = cfg.datamodule
    dm = PassagesDataModule(
        tokenizer,
        d["passages_path"],
        batch_size=d.get("encode_batch_size", 128),
        use_title=d.get("use_title", True),
        sep_token=d.get("sep_token"),
        num_workers=d.get("num_workers", 0),
    )
    shard = cfg.task.get("shard", 0)
    num_shards = cfg.task.get("num_shards", 1)
    rows = contiguous_shard(len(dm), shard, num_shards)
    try:
        path = encoder.encode_to_dir(
            dm.batches(shard, num_shards),
            out_dir,
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
