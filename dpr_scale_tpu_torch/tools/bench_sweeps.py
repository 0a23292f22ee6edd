"""Times the MIPS sweep kernels and the searches built on them, on one GPU.

    PYTHONPATH=. python dpr_scale_tpu_torch/tools/bench_sweeps.py

Over a seeded random 2,097,152 x 768 bf16 block (the JAX ``bench.py``
geometry) it times, queued behind a GPU sleep, ``count_above_groups`` at
B = 512 over the block and at B = 64 over it and over its first 1,048,576
rows, and ``count_above`` and ``groupmax`` at B = 512 and 64 (thresholds at
each query's 99.99th score percentile); then, at B = 512 and k = 100, one
device search per method ("fused", "auto", "groupmax": CUDA events around
``MipsIndex._device_search``) and ``MipsIndex.benchmark`` over four
batches (its dict). Prints one JSON object: the package it timed, the
card's name and power limit, the results (times in ms).

``PYTHONPATH`` names the checkout whose package is timed, so two checkouts
compare on one card by running this script in turns with each (parent,
change, change, parent), from either tree; the ``package`` key says which
one ran.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from dpr_scale_tpu_torch.index.mips import MipsIndex
from dpr_scale_tpu_torch.ops import mips_kernels as mk

SEED = 7
ROWS, DIM, CHUNK = 1 << 21, 768, 131072


def queued_ms(fn, calls=10, reps=3):
    """Median device time of one call, ``calls`` calls enqueued behind a
    GPU sleep (chip_smoke.device_ms)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def events_ms(fn, reps=5):
    """Median time of one call between CUDA events (host gaps included)."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def p9999(q, corpus):
    """Each query's 99.99th score percentile (fp32 sums), chunk by chunk."""
    k = corpus.shape[0] // 10000 + 1
    best = None
    for lo in range(0, corpus.shape[0], CHUNK):
        t = torch.topk(q.float() @ corpus[lo : lo + CHUNK].float().T, k, dim=1).values
        best = t if best is None else torch.topk(torch.cat([best, t], 1), k, dim=1).values
    return best[:, -1].contiguous()


def main():
    if not torch.cuda.is_available():
        print("bench_sweeps: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(SEED)
    corpus = torch.randn(ROWS, DIM, generator=g, device=dev).to(torch.bfloat16)
    res = {}
    for B in (512, 64):
        q = torch.randn(B, DIM, generator=g, device=dev).to(torch.bfloat16)
        tau = p9999(q, corpus)
        res[f"count_above_groups B={B} N={ROWS}"] = queued_ms(
            lambda: mk.count_above_groups_kernel(q, corpus, tau))
        res[f"count_above B={B}"] = queued_ms(lambda: mk.count_above_kernel(q, corpus, tau))
        res[f"groupmax B={B}"] = queued_ms(lambda: mk.groupmax_kernel(q, corpus))
    half = corpus[: ROWS // 2]
    tau = p9999(q, half)
    res[f"count_above_groups B=64 N={ROWS // 2}"] = queued_ms(
        lambda: mk.count_above_groups_kernel(q, half, tau))
    del half
    batches = np.random.default_rng(SEED).standard_normal((4, 512, DIM)).astype(np.float32)
    index = MipsIndex(dev)
    index.add(corpus)
    del corpus
    emb, n_valid, _off = index._blocks[0]
    q0 = torch.from_numpy(batches[0]).to(dev)
    for method in ("fused", "auto", "groupmax"):
        index.method = method
        with torch.inference_mode():
            res[f"{method} device search B=512"] = events_ms(
                lambda: index._device_search(emb, q0, 100, n_valid))
        res[f"{method} benchmark B=512"] = index.benchmark(batches, 100)
    print(json.dumps({"package": mk.__file__, "device": smi, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
