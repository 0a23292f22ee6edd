"""Rerank TREC candidates with a dense bi-encoder, a multi-vector model or a
cross-encoder, on one device (the reference's rerank tasks; counterpart of
``dpr_scale_tpu.cli.rerank``).

Usage:
    python -m dpr_scale_tpu_torch.cli.rerank --config conf/nq.yaml \
        task.rerank_type=dense|multivec|cross_encoder \
        task.checkpoint_path=/ckpt/params_best \
        datamodule.trec_path=cand.trec \
        datamodule.queries_path=queries.tsv \
        datamodule.passages_path=passages.tsv \
        task.output_trec_path=reranked.trec [task.output_pickle_dir=out/] [--device cuda:0]

``conf/task/rerank_{dense,multivec,cross_encoder}.yaml`` set the type. The
candidates are the run's lines joined with the queries (``qid \\t query``)
and the passages (``id \\t text \\t title``); ``datamodule.batch_size``
pairs a batch (the last one padded). The weights come from
``task.checkpoint_path`` (a params export of the same model: a
``BiEncoder``, a ``MultiVecEncoder`` of ``task.variant``, a
``CrossEncoder``) or, when it is unset, from a seed, with a warning.
"""
from __future__ import annotations

import argparse

from dpr_scale_tpu_torch.cli.common import (
    build_model_config,
    build_tokenizer,
    check_vocab_compat,
    load_weights,
)
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.data.datasets import (
    IDCSVDataset,
    QueryTRECDataset,
    TRECCandidateDataset,
)
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.retrieve import rerank


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default=None, help="default: cuda:0")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    device = resolve_device(args.device)

    tokenizer = build_tokenizer(cfg)
    d = cfg.datamodule
    dataset = TRECCandidateDataset(
        d["trec_path"], QueryTRECDataset(d["queries_path"]), IDCSVDataset(d["passages_path"])
    )
    mcfg = build_model_config(cfg)
    check_vocab_compat(tokenizer, mcfg)
    t = cfg.task
    rerank_type = t.get("rerank_type", "dense")
    common = dict(
        batch_size=d.get("batch_size", 32),
        use_title=d.get("use_title", True),
        output_trec_path=t.get("output_trec_path"),
        output_pickle_dir=t.get("output_pickle_dir"),
        shard_id=t.get("shard", 0),
    )

    def loaded(model):
        return load_weights(model, cfg).to(device).eval()

    if rerank_type == "dense":
        from dpr_scale_tpu_torch.models.encoder import BiEncoder

        model = loaded(BiEncoder(mcfg, projection_dim=t.model.get("projection_dim", 0),
                                 shared=t.get("shared_model", True)))
        out = rerank.rerank_dense(model, tokenizer, dataset, device, **common)
    elif rerank_type == "multivec":
        from dpr_scale_tpu_torch.models.multivec import MultiVecEncoder

        model = loaded(MultiVecEncoder(mcfg, variant=t.get("variant", "citadel"),
                                       tok_projection_dim=t.get("tok_projection_dim"),
                                       cls_projection_dim=t.get("cls_projection_dim")))
        out = rerank.rerank_multivec(
            model, tokenizer, dataset, device,
            query_topk=t.get("query_topk", 1), context_topk=t.get("context_topk", 1),
            add_cls=t.get("add_cls", False), query_pool=t.get("query_pool", "sum"), **common,
        )
    elif rerank_type == "cross_encoder":
        from dpr_scale_tpu_torch.models.multivec import CrossEncoder

        model = loaded(CrossEncoder(mcfg))
        out = rerank.rerank_cross_encoder(model, tokenizer, dataset, device, **common)
    else:
        raise ValueError(f"unknown rerank_type {rerank_type!r}")

    print(f"Reranked {len(out['scores'])} candidate pairs")
    return out


if __name__ == "__main__":
    main()
