"""Times the MIPS sweep kernels and the searches built on them, and the
CITADEL gather-score kernels, on one GPU.

    PYTHONPATH=. python dpr_scale_tpu_torch/tools/bench_sweeps.py

Over a seeded random 2,097,152 x 768 bf16 block (the JAX ``bench.py``
geometry) it times, queued behind a GPU sleep, ``count_above_groups`` at
B = 512 over the block and at B = 64 over it and over its first 1,048,576
rows, and ``count_above``, ``groupmax`` and ``tile_max_scores`` (4,096-row
tiles) at B = 512 and 64 (thresholds at each query's 99.99th score
percentile); over a seeded int8 copy of the block (its values times 32,
rounded and clamped; the first 384 bytes of each row as packed int4),
``int_groupmax`` without rows (int8 and int4, one plane) at B = 512 and
64 and ``int8_tile_max`` (2,048-row tiles) at B = 512, 256 and 64; then,
at B = 512 and k = 100, one device search per method
("fused", "auto", "groupmax": CUDA events around
``MipsIndex._device_search``) and ``MipsIndex.benchmark`` over four
batches (its dict). Then the serial and pipelined gather-score kernels,
queued, summed over five D = 32 bf16 buckets of the 8.8M-doc layout of
``chip_smoke.py`` phase 13 (entries: 4,096 query tokens routed uniformly
over its experts), with whether the two give the same bits, and, where
the package has the bulk-copy ring, the pipelined kernel at ring stages of
16, 32 and 64 KB. Prints one JSON object: the package it timed, the
card's name and power limit, the results (times in ms).

``--sweeps-only`` times the four bf16 sweeps alone, and ``--dims 768 1536``
times them over a 2,097,152-row block of each width (the keys of a width
other than 768 name it).

``PYTHONPATH`` names the checkout whose package is timed, so two checkouts
compare on one card by running this script in turns with each (parent,
change, change, parent), from either tree; the ``package`` key says which
one ran.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from dpr_scale_tpu_torch.index.mips import MipsIndex
from dpr_scale_tpu_torch.ops import gather_score as gs
from dpr_scale_tpu_torch.ops import int_kernels as ik
from dpr_scale_tpu_torch.ops import mips_kernels as mk

SEED = 7
ROWS, DIM, CHUNK = 1 << 21, 768, 131072
# chip_smoke.CITADEL_PLAN: (bucket rows, experts) of the 8.8M-doc layout
CITADEL_PLAN = ((512, 8000), (2048, 3000), (8192, 800), (32768, 100), (131072, 8))
CITADEL_TOKENS, CITADEL_DIM = 4096, 32


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


def bench_gather(dev, g):
    """The gather-score kernels over the CITADEL buckets (see the module
    docstring): their queued times summed over the buckets."""
    rng = np.random.default_rng(SEED)
    experts = sum(n for _L, n in CITADEL_PLAN)
    stage_sizes = (16384, 32768, 65536) if hasattr(gs, "PIPE_BULK_STAGE_BYTES") else ()
    res = dict.fromkeys(["gather serial 5 buckets", "gather pipelined 5 buckets",
                         *(f"gather pipelined {b} B stages" for b in stage_sizes)], 0.0)
    same = True
    for L, n_exp in CITADEL_PLAN:
        E = int(rng.binomial(CITADEL_TOKENS, n_exp / experts))
        vecs = (torch.randn(n_exp, L, CITADEL_DIM, generator=g, device=dev) * 0.3).bfloat16()
        slots = torch.from_numpy(np.sort(rng.integers(0, n_exp, E)).astype(np.int32)).to(dev)
        q = torch.randn(E, CITADEL_DIM, generator=g, device=dev).bfloat16()
        same &= torch.equal(gs.gather_score_serial_kernel(vecs, slots, q),
                            gs.gather_score_pipelined_kernel(vecs, slots, q))
        res["gather serial 5 buckets"] += queued_ms(
            lambda: gs.gather_score_serial_kernel(vecs, slots, q), calls=20)
        res["gather pipelined 5 buckets"] += queued_ms(
            lambda: gs.gather_score_pipelined_kernel(vecs, slots, q), calls=20)
        default = gs.PIPE_BULK_STAGE_BYTES if stage_sizes else None
        for b in stage_sizes:
            gs.PIPE_BULK_STAGE_BYTES = b
            res[f"gather pipelined {b} B stages"] += queued_ms(
                lambda: gs.gather_score_pipelined_kernel(vecs, slots, q), calls=20)
        if stage_sizes:
            gs.PIPE_BULK_STAGE_BYTES = default
        del vecs
    res["gather pipelined == serial"] = same
    return res


def bench_int(dev, g, corpus):
    """The integer sweeps over an int8 copy of ``corpus`` (see the module
    docstring): their queued times."""
    c8 = torch.cat([(corpus[lo : lo + CHUNK].float() * 32).round().clamp(-127, 127).to(torch.int8)
                    for lo in range(0, ROWS, CHUNK)])
    c4 = c8[:, : DIM // 2].contiguous()
    sc = torch.rand(ROWS, generator=g, device=dev) + 0.5
    res = {}
    for B in (512, 256, 64):
        q8 = torch.randint(-127, 128, (B, DIM), generator=g, device=dev, dtype=torch.int8)
        qsc = torch.rand(B, generator=g, device=dev) * 0.09 + 0.01
        if B != 256:
            for tier, rows, packed in (("int8", c8, False), ("int4", c4, True)):
                res[f"int_groupmax {tier} B={B}"] = queued_ms(lambda: ik.int_groupmax_kernel(
                    q8, rows, sc, qsc, packed=packed, want_rows=False))
        res[f"int8_tile_max B={B}"] = queued_ms(lambda: ik.int8_tile_max_kernel(q8, c8, 2048))
    return res


def bench_bf16(dev, g, corpus, res, tag=""):
    """The four bf16 sweeps over ``corpus`` at B = 512 and 64, queued."""
    for B in (512, 64):
        q = torch.randn(B, corpus.shape[1], generator=g, device=dev).to(torch.bfloat16)
        tau = p9999(q, corpus)
        res[f"count_above_groups B={B} N={ROWS}{tag}"] = queued_ms(
            lambda: mk.count_above_groups_kernel(q, corpus, tau))
        res[f"count_above B={B}{tag}"] = queued_ms(lambda: mk.count_above_kernel(q, corpus, tau))
        res[f"groupmax B={B}{tag}"] = queued_ms(lambda: mk.groupmax_kernel(q, corpus))
        res[f"tile_max_scores B={B}{tag}"] = queued_ms(
            lambda: mk.tile_max_scores_kernel(q, corpus, mk.TILE_ROWS))
    return q


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dims", type=int, nargs="+", default=[DIM])
    parser.add_argument("--sweeps-only", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sweeps: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    for D in (d for d in args.dims if d != DIM):
        wide = torch.randn(ROWS, D, generator=g, device=dev).to(torch.bfloat16)
        bench_bf16(dev, g, wide, res, f" D={D}")
        del wide
    if args.sweeps_only and DIM not in args.dims:
        print(json.dumps({"package": mk.__file__, "device": smi, "results": res}))
        return 0
    corpus = torch.randn(ROWS, DIM, generator=g, device=dev).to(torch.bfloat16)
    q = bench_bf16(dev, g, corpus, res)
    if args.sweeps_only:
        print(json.dumps({"package": mk.__file__, "device": smi, "results": res}))
        return 0
    res.update(bench_int(dev, g, corpus))
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
    del index, emb
    res.update(bench_gather(dev, g))
    print(json.dumps({"package": mk.__file__, "device": smi, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
