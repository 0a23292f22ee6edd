"""Retrieval serving endpoint (dense tower, exact or approximate MIPS).

Usage:
    python -m dpr_scale_tpu_torch.cli.serve --config conf/nq.yaml \
        task.ctx_embeddings_dir=/embs \
        datamodule.passages_path=psgs_w100.tsv \
        serve.port=8080 [serve.method=approx|fused|groupmax|auto|exact_sort|int8|int4] \
        [serve.int8_query_planes=2] [serve.k=10] [--device cuda:0]

    curl -XPOST localhost:8080/search -d '{"questions": ["who wrote hamlet"], "k": 5}'

``serve.method`` defaults to ``approx``, as in the JAX CLI; ``fused``,
``groupmax`` and ``auto`` serve verified-exact results; ``int8`` / ``int4``
quantise the corpus (the exact top-k of the dequantised scores), with
``serve.int8_query_planes=2`` for two-plane queries. The query tower is
initialised from a seed (``task.checkpoint_path`` raises: orbax checkpoints
need jax). The CITADEL tower (``serve_citadel``) is not ported and raises
(ROADMAP A7).
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
from dpr_scale_tpu_torch.data.datasets import CSVDataset
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder
from dpr_scale_tpu_torch.retrieve.retrieval import build_index
from dpr_scale_tpu_torch.retrieve.server import Retriever, make_server


def build_retriever(cfg, device=None) -> Retriever:
    """All the serving wiring short of binding the socket. ``device``
    defaults to ``cuda:0``."""
    s = cfg.get("serve", {})
    if cfg.get("serve_citadel"):
        raise NotImplementedError(
            "serve_citadel: the CITADEL serving tower (CitadelRetriever) is not ported "
            "(ROADMAP A7)"
        )
    device = resolve_device(device)
    tokenizer = build_tokenizer(cfg)
    check_vocab_compat(tokenizer, build_model_config(cfg))
    encoder = CorpusEncoder(build_biencoder(cfg, device), device, use_query_tower=True)
    index = build_index(
        cfg.task["ctx_embeddings_dir"],
        device,
        host_resident=cfg.task.get("host_resident_index", False),
        method=s.get("method", "approx"),  # serving default: low latency
        index_store=s.get("index_store"),
        device_rows=s.get("device_rows"),
    )
    # 2: int16-precision queries over the quantised corpus (two int8 planes)
    index.int8_query_planes = int(s.get("int8_query_planes", 1))
    retriever = Retriever(
        encoder,
        tokenizer,
        index,
        CSVDataset(cfg.datamodule["passages_path"]),
        default_k=s.get("k", 10),
        max_batch=s.get("max_batch", 64),
        serialized=not s.get("pipelined", False),
    )
    # the first request should not pay the first-use costs (kernel build,
    # allocator growth); warm at the default k real requests use
    retriever.search(["warmup"], k=retriever.default_k)
    return retriever


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default=None, help="default: cuda:0")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    s = cfg.get("serve", {})
    retriever = build_retriever(cfg, args.device)
    host, port = s.get("host", "0.0.0.0"), s.get("port", 8080)
    server = make_server(retriever, host, port)
    print(f"Serving retrieval (dense) on {host}:{port} over {retriever.num_rows} passages")
    server.serve_forever()


if __name__ == "__main__":
    main()
