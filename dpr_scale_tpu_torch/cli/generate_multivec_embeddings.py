"""Multi-vector corpus emission on one device: encode passages and write
inverted-index shards in the reference format (GenerateMultiVecEmbeddingsTask,
dpr_scale/task/citadel_eval_task.py:16-118).

Usage:
    python -m dpr_scale_tpu_torch.cli.generate_multivec_embeddings \
        --config conf/citadel.yaml \
        datamodule.passages_path=corpus.tsv \
        task.ctx_embeddings_dir=/out/citadel_index \
        task.weight_threshold=0.0 task.shard=0 task.num_shards=1 [--device cuda:0]

Writes ``expert_{shard:04}/{expert}.pkl`` and ``cls_{shard:04}.pkl`` (numpy
pickles, readable by the JAX package's loader) for the contiguous corpus
rows of ``task.shard``. The weights come from ``task.checkpoint_path``: the
params export of the port's own training (``cli.train --config
conf/citadel.yaml`` writes ``<checkpoint_callback.dirpath>/params_best``),
or for a model trained in JAX its ``.npz`` from
``tools/orbax_params_to_npz.py``; when it is unset, from a seed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from dpr_scale_tpu_torch.cli.common import (
    build_model_config,
    build_tokenizer,
    check_vocab_compat,
    load_weights,
)
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.data.datamodule import PassagesDataModule, contiguous_shard
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.index.inverted import InvertedExpertIndex
from dpr_scale_tpu_torch.models.multivec import MultiVecEncoder


def build_multivec_model(cfg, device, seed: int = 0) -> MultiVecEncoder:
    """The task's MultiVecEncoder on ``device`` in eval mode, its weights
    from ``task.checkpoint_path`` or ``seed`` (``cli.common.load_weights``)."""
    t = cfg.task
    model = MultiVecEncoder(
        build_model_config(cfg),
        variant=t.get("variant", "citadel"),
        tok_projection_dim=t.get("tok_projection_dim"),
        cls_projection_dim=t.get("cls_projection_dim"),
    )
    return load_weights(model, cfg, seed).to(device).eval()


def encode_batch(model, batch, device, topk: int, add_cls: bool):
    """One padded batch through the encoder on ``device``: the output dict
    in numpy, cut to the batch's real rows."""
    with torch.inference_mode():
        out = model(
            torch.from_numpy(batch["input_ids"]).to(device),
            torch.from_numpy(batch["attention_mask"]).to(device),
            topk=topk, add_cls=add_cls, routing_stats=False,
        )
        out = {k: v.cpu().numpy() for k, v in out.items()}
    n = batch["input_ids"].shape[0] - int(batch["pad_count"])
    return {k: (v[:n] if np.ndim(v) > 0 else v) for k, v in out.items()}


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
    model = build_multivec_model(cfg, device)
    d = cfg.datamodule
    dm = PassagesDataModule(
        tokenizer,
        d["passages_path"],
        batch_size=d.get("encode_batch_size", 64),
        use_title=d.get("use_title", True),
        sep_token=d.get("sep_token"),
        num_workers=d.get("num_workers", 0),
    )
    shard = cfg.task.get("shard", 0)
    num_shards = cfg.task.get("num_shards", 1)
    rows = contiguous_shard(len(dm), shard, num_shards)

    topk = cfg.task.get("context_topk", 1)
    add_cls = cfg.task.get("add_cls", False)
    dim = cfg.task.get("tok_projection_dim") or build_model_config(cfg).hidden_size
    index = InvertedExpertIndex(dim=dim, num_docs=len(dm))
    row_cursor = rows.start
    threshold = cfg.task.get("weight_threshold", 0.0)
    try:
        for batch in dm.batches(shard, num_shards):
            out = encode_batch(model, batch, device, topk, add_cls)
            n = len(out["attention_mask"])
            index.add_batch(range(row_cursor, row_cursor + n), out, threshold)
            row_cursor += n
    finally:
        dm.close()

    index.finalize(quantizer=cfg.task.get("quantizer"))
    index.save(cfg.task["ctx_embeddings_dir"], shard_id=shard)
    print(
        f"Wrote expert shard {shard} to {cfg.task['ctx_embeddings_dir']}: "
        f"{index.stats()}"
    )
    return index.stats()


if __name__ == "__main__":
    main()
