"""End-to-end CITADEL/COIL retrieval over the inverted expert index (reference
CITADELRetrievalTask, dpr_scale/task/citadel_retrieval_task.py).

Usage:
    python -m dpr_scale_tpu_torch.cli.citadel_retrieval --config conf/citadel.yaml \
        task.ctx_embeddings_dir=/out/citadel_index \
        datamodule.test_path=queries.tsv datamodule.trec_format=true \
        datamodule.passages_path=corpus.tsv \
        task.output_trec_path=/out/citadel.trec [--device cuda:0]

``task.device_index=true`` searches a :class:`DeviceExpertIndex` on the
device (``task.device_index_dtype``: bfloat16, the default, or float32,
which reproduces the host search); otherwise the numpy host index searches.
The encoder runs on the device under ``torch.inference_mode()``, its weights
from ``task.checkpoint_path`` (a params export, e.g. a JAX model's ``.npz``
from ``tools/orbax_params_to_npz.py``) or, when it is unset, from a seed.
``task.expert_parallel=true`` shards the device index's experts and its
accumulator over every visible device of ``--device``'s kind
(``parallel.mesh.get_mesh``; the reference's expert_parallel flag,
citadel_retrieval_task.py:29,44), with the same results.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np

from dpr_scale_tpu_torch.cli.common import (
    build_model_config,
    build_tokenizer,
    check_vocab_compat,
)
from dpr_scale_tpu_torch.cli.generate_multivec_embeddings import (
    build_multivec_model,
    encode_batch,
)
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.data.datamodule import QueriesDataModule
from dpr_scale_tpu_torch.data.datasets import CSVDataset
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.index.inverted import InvertedExpertIndex
from dpr_scale_tpu_torch.retrieve.writers import write_dpr_json, write_trec_run


def write_query_embeddings(out_dir, questions, query_dump) -> None:
    """Query-side emission (GenerateMultiVecQueryEmbeddingsTask,
    citadel_eval_task.py:120-213): query_repr/weight/id/cls pickles."""
    os.makedirs(out_dir, exist_ok=True)
    payloads = {
        "query_repr.pkl": np.concatenate([d["expert_repr"] for d in query_dump]),
        "query_weight.pkl": np.concatenate([d["expert_weights"] for d in query_dump])
        if "expert_weights" in query_dump[0] else None,
        "query_id.pkl": [q.get("id", i) for i, q in enumerate(questions)],
        "query_cls.pkl": np.concatenate([d["cls_repr"] for d in query_dump])
        if "cls_repr" in query_dump[0] else None,
    }
    for name, payload in payloads.items():
        if payload is None:
            continue
        with open(os.path.join(out_dir, name), "wb") as f:
            pickle.dump(payload, f, protocol=4)
    print(f"Wrote query-side embeddings to {out_dir}")


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
    passages = CSVDataset(d["passages_path"])
    index = InvertedExpertIndex.load(
        cfg.task["ctx_embeddings_dir"],
        num_docs=len(passages),
        portion=cfg.task.get("portion", 1.0),
        quantizer=cfg.task.get("quantizer"),
    )
    print(f"Loaded inverted index: {index.stats()}")
    if cfg.task.get("device_index", False):
        from dpr_scale_tpu_torch.index.inverted_device import DeviceExpertIndex
        from dpr_scale_tpu_torch.parallel.mesh import get_mesh

        mesh = get_mesh(device) if cfg.task.get("expert_parallel", False) else None
        # bf16 postings halve device memory (default); float32 reproduces
        # the host search (debug / tight-margin corpora)
        index = DeviceExpertIndex.from_host_index(
            index, dtype=cfg.task.get("device_index_dtype", "bfloat16"), device=device,
            mesh=mesh,
        )
        print(f"Using device-resident expert index on {device}"
              + (f" (expert-parallel over {len(mesh)} devices)" if mesh else ""))

    dm = QueriesDataModule(
        tokenizer,
        d["test_path"],
        batch_size=d.get("encode_batch_size", 32),
        trec_format=d.get("trec_format", False),
    )
    questions = dm.rows()
    topk_route = cfg.task.get("query_topk", 1)
    add_cls = cfg.task.get("add_cls", False)
    k = cfg.task.get("topk", 100)
    all_scores, all_rows = [], []
    query_dump = [] if cfg.task.get("query_emb_output_dir") else None
    t_encode = 0.0
    for batch in dm.batches():
        tic = time.perf_counter()
        out = encode_batch(model, batch, device, topk_route, add_cls)
        t_encode += time.perf_counter() - tic
        if query_dump is not None:
            query_dump.append(out)
        s, r = index.search(out, topk=k)
        all_scores.append(s)
        all_rows.append(r)

    if query_dump is not None:
        write_query_embeddings(cfg.task["query_emb_output_dir"], questions, query_dump)
    scores = np.concatenate(all_scores, 0)
    rows = np.concatenate(all_rows, 0)
    index.latency["encode_time"] = t_encode
    print("latency:", dict(index.latency))

    results = []
    for qi in range(len(questions)):
        ctxs = []
        for sc, row in zip(scores[qi], rows[qi]):
            if row < 0:  # placeholder slot (query touched < k docs)
                continue
            p = passages[int(row)]
            ctxs.append({
                "id": p.get("id", str(int(row))),
                "title": p.get("title", ""),
                "text": p.get("text", ""),
                "score": float(sc),
            })
        results.append(ctxs)

    if cfg.task.get("output_path"):
        write_dpr_json(cfg.task["output_path"], questions, results)
        print(f"Wrote {cfg.task['output_path']}")
    if cfg.task.get("output_trec_path"):
        qids = [str(q.get("id", i)) for i, q in enumerate(questions)]
        write_trec_run(
            cfg.task["output_trec_path"],
            qids,
            [[c["id"] for c in ctxs] for ctxs in results],
            [[c["score"] for c in ctxs] for ctxs in results],
        )
        print(f"Wrote {cfg.task['output_trec_path']}")
    return results


if __name__ == "__main__":
    main()
