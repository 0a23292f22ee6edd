"""A/B timing of the device CITADEL search at chip_smoke.py phase 13's size
(8.8M docs in its five buckets, B = 128, 32 query tokens, D = 32, a
128-wide CLS plane, bf16, seeds as in phase 13) on one card, for several
checkouts of the repo in one call:

    python dpr_scale_tpu_torch/tools/bench_citadel_search.py --trees OLD NEW NEW OLD

Each tree runs in a process of its own, in the order given; the process
imports that tree's ``dpr_scale_tpu_torch`` and ``chip_smoke.py`` (for
phase 13's bucket layout and constants), builds the one-device index and
times its search with CLS and without: per call the host clock and CUDA
events around it (the search fetches its result), medians of ``--reps``
after one warm-up, and the caching allocator's ``cudaMalloc`` calls during
the timed calls. Where the tree's index takes a device list, the same is
then timed again with a ``--beside``-shard index of the same data built
beside it on the card (phase 23 (a)'s set-up), and for that index too.
One JSON line per (tree, layout, case) on stdout, then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _build(cs, dev, mesh=None, shared=None):
    """Phase 13's synthetic index on ``dev`` (``mesh``: its device list);
    ``shared`` reuses the bucket and CLS tensors of an earlier build.
    Returns (index, tensors, expert count)."""
    import numpy as np
    import torch

    from dpr_scale_tpu_torch.index.inverted_device import DeviceExpertIndex

    index = (DeviceExpertIndex(cs.CITADEL_DOCS, torch.bfloat16, dev) if mesh is None
             else DeviceExpertIndex(cs.CITADEL_DOCS, torch.bfloat16, dev, mesh))
    if shared is None:
        rng = np.random.default_rng(cs.SEED + 10)
        g = torch.Generator(device=dev).manual_seed(cs.SEED + 10)
        shared, first = {"buckets": []}, 0
        for bsize, n_exp in cs.CITADEL_PLAN:
            _docs, run_id, run_doc, start_pos, mrl = cs._synth_bucket(rng, n_exp, bsize,
                                                                      cs.CITADEL_DOCS)
            vecs = (torch.randn(n_exp, bsize, cs.CITADEL_DIM, generator=g, device=dev) * 0.3
                    ).to(torch.bfloat16)
            vecs[:, int(bsize * 0.7):] = 0
            shared["buckets"].append((bsize, np.arange(first, first + n_exp), vecs, run_id,
                                      run_doc, start_pos, mrl))
            first += n_exp
        cls = torch.empty(cs.CITADEL_DOCS, cs.CITADEL_CLS_DIM, dtype=torch.bfloat16, device=dev)
        for lo in range(0, cs.CITADEL_DOCS, 1 << 20):
            rows = min(1 << 20, cs.CITADEL_DOCS - lo)
            cls[lo : lo + rows] = torch.randn(rows, cs.CITADEL_CLS_DIM, generator=g,
                                              device=dev) * 0.3
        shared["cls"], shared["experts"] = cls, first
    for bucket in shared["buckets"]:
        index.add_bucket(*bucket)
    if hasattr(index, "set_cls"):
        index.set_cls(shared["cls"])
    else:  # an index that takes the plane as an attribute
        index.cls = shared["cls"]
    return index, shared


def _queries(cs, n_experts):
    """Phase 13's query batch (seed SEED + 11): (with CLS, without)."""
    import numpy as np

    B, T = cs.CITADEL_BATCH, cs.CITADEL_QTOKENS
    qrng = np.random.default_rng(cs.SEED + 11)
    query = {
        "expert_ids": qrng.integers(0, n_experts, size=(B, T, 1)).astype(np.int64),
        "expert_weights": qrng.random((B, T, 1)).astype(np.float32),
        "expert_repr": qrng.normal(size=(B, T, cs.CITADEL_DIM)).astype(np.float32),
        "attention_mask": np.ones((B, T), np.int64),
        "cls_repr": qrng.normal(size=(B, cs.CITADEL_CLS_DIM)).astype(np.float32),
    }
    return {"with CLS": query,
            "without CLS": {k: v for k, v in query.items() if k != "cls_repr"}}


def _time(index, q, reps):
    """(host ms, event ms) medians, cudaMalloc calls and the latency dict
    in ms, per timed search."""
    import torch

    index.search(q, 100)
    index.latency.clear()
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
    host, events = [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        index.search(q, 100)
        b.record()
        b.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(a.elapsed_time(b))
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs
    return {"host_ms": statistics.median(host), "event_ms": statistics.median(events),
            "host_ms_min": min(host), "host_ms_max": max(host),
            "cuda_mallocs_per_search": allocs / reps,
            "latency_ms": {k: v / reps * 1e3 for k, v in index.latency.items()}}


def child(tree: str, reps: int, beside: int) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    one, shared = _build(cs, dev)
    cases = _queries(cs, shared["experts"])

    def report(layout, index):
        for case, q in cases.items():
            print(json.dumps({"tree": tree, "layout": layout, "case": case,
                              **_time(index, q, reps)}), flush=True)

    report("one device", one)
    try:
        ep, _ = _build(cs, dev, [dev] * beside, shared)
    except NotImplementedError:
        return
    report(f"one device, {beside} shards beside it", one)
    report(f"{beside} shards", ep)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[os.getcwd()])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--beside", type=int, default=4)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.reps, args.beside)
        return
    for tree in args.trees:
        tree = os.path.abspath(tree)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                        "--reps", str(args.reps), "--beside", str(args.beside)],
                       cwd=tree, check=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=False)


if __name__ == "__main__":
    main()
