"""Retrieval serving endpoint: the dense tower (exact or approximate MIPS)
on ``/search`` and / or the CITADEL tower on ``/search_citadel``.

Usage:
    python -m dpr_scale_tpu_torch.cli.serve --config conf/nq.yaml \
        task.ctx_embeddings_dir=/embs \
        datamodule.passages_path=psgs_w100.tsv \
        serve.port=8080 [serve.method=approx|fused|groupmax|auto|exact_sort|int8|int4] \
        [serve.int8_query_planes=2] [serve.k=10] [--device cuda:0]

    curl -XPOST localhost:8080/search -d '{"questions": ["who wrote hamlet"], "k": 5}'

    python -m dpr_scale_tpu_torch.cli.serve --config conf/citadel.yaml \
        task.checkpoint_path=/ckpt/params_best \
        serve_citadel.ctx_embeddings_dir=/out/citadel_index \
        datamodule.passages_path=psgs_w100.tsv [serve_citadel.device_index=false]

    curl -XPOST localhost:8080/search_citadel -d '{"questions": ["who wrote hamlet"]}'

``serve.method`` defaults to ``approx``, as in the JAX CLI; ``fused``,
``groupmax`` and ``auto`` serve verified-exact results; ``int8`` / ``int4``
quantise the corpus (the exact top-k of the dequantised scores), with
``serve.int8_query_planes=2`` for two-plane queries. The query tower's
weights come from ``task.checkpoint_path`` (a params export) or, when it is
unset, from a seed. The dense tower is built when ``task.ctx_embeddings_dir``
is set; the CITADEL tower when the ``serve_citadel`` group is (its
``ctx_embeddings_dir``, ``portion``, ``quantizer``, ``device_index``
(default true: a ``DeviceExpertIndex`` on the device, of
``device_index_dtype``), ``query_topk``, ``add_cls``, ``k``, ``max_batch``,
``pipelined``, ``expert_parallel``: the device index sharded over every
visible device of ``--device``'s kind, ``parallel.mesh.get_mesh``), its
encoder the task's ``MultiVecEncoder`` with the same weights keys. Both run
on ``cuda:0`` unless ``--device`` says otherwise.
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
from dpr_scale_tpu_torch.retrieve.server import CitadelRetriever, Retriever, make_server


def build_retriever(cfg, device=None) -> Retriever:
    """The dense tower: all its serving wiring short of binding the socket.
    ``device`` defaults to ``cuda:0``."""
    s = cfg.get("serve", {})
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


def build_citadel_retriever(cfg, device=None) -> CitadelRetriever:
    """The CITADEL tower from the ``serve_citadel`` group (the keys of
    ``cli.citadel_retrieval``'s task group), warmed at its default k.
    ``device`` defaults to ``cuda:0``."""
    from dpr_scale_tpu_torch.cli.generate_multivec_embeddings import build_multivec_model
    from dpr_scale_tpu_torch.index.inverted import InvertedExpertIndex

    sc = cfg["serve_citadel"]
    device = resolve_device(device)
    tokenizer = build_tokenizer(cfg)
    check_vocab_compat(tokenizer, build_model_config(cfg))
    model = build_multivec_model(cfg, device)
    passages = CSVDataset(cfg.datamodule["passages_path"])
    index = InvertedExpertIndex.load(
        sc["ctx_embeddings_dir"],
        num_docs=len(passages),
        portion=sc.get("portion", 1.0),
        quantizer=sc.get("quantizer"),
    )
    if sc.get("device_index", True):  # serving default: on the device
        from dpr_scale_tpu_torch.index.inverted_device import DeviceExpertIndex
        from dpr_scale_tpu_torch.parallel.mesh import get_mesh

        mesh = get_mesh(device) if sc.get("expert_parallel", False) else None
        index = DeviceExpertIndex.from_host_index(
            index, dtype=sc.get("device_index_dtype", "bfloat16"), device=device, mesh=mesh
        )
    retriever = CitadelRetriever(
        model,
        tokenizer,
        index,
        passages,
        topk_route=sc.get("query_topk", 1),
        add_cls=sc.get("add_cls", False),
        default_k=sc.get("k", 10),
        max_batch=sc.get("max_batch", 64),
        serialized=not sc.get("pipelined", False),
    )
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
    dense_configured = bool(cfg.get("task", {}).get("ctx_embeddings_dir"))
    retriever = build_retriever(cfg, args.device) if dense_configured else None
    citadel = build_citadel_retriever(cfg, args.device) if cfg.get("serve_citadel") else None
    host, port = s.get("host", "0.0.0.0"), s.get("port", 8080)
    server = make_server(retriever, host, port, citadel_retriever=citadel)
    towers = [t for t, r in (("dense", retriever), ("citadel", citadel)) if r]
    primary = retriever or citadel
    print(
        f"Serving retrieval ({'+'.join(towers)}) on {host}:{server.server_address[1]} over "
        f"{primary.num_rows} passages"
    )
    server.serve_forever()


if __name__ == "__main__":
    main()
