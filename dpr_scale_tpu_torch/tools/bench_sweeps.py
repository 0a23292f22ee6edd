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

Pass 1 (``topk_candidates``, kc = 128) is timed beside the sweeps, a call
and queued calls, at each batch and width.

``--sweeps-only`` times the four bf16 sweeps and pass 1 alone, and ``--dims 768 1536``
times them over a 2,097,152-row block of each width (the keys of a width
other than 768 name it). For the widths other than 768, ``--rows`` sets the
blocks' rows (one block of each; keys other than 2,097,152 rows name them)
and ``--batches`` the query batches, so that ``--dims 30522 --rows 65536
1280 --batches 256`` times SPLADE's width; the tile maxima take 4,096-row
tiles where they divide the rows, else 256. Each width's keys beside
``routes D=...`` say which route each sweep's launches took.

``--resources`` adds, for each instance of the four bf16 sweep kernels,
ptxas's registers and spills and, where the toolkit has ``cuobjdump``, its
SASS instruction count and counts of a few instructions; ``--sass-dir DIR``
also writes each instance's SASS under DIR. ``--pad-search`` times, at each
width that is not a multiple of 8 and each ``--rows``, ``MipsIndex.search``
(k = 100, the first ``--batches`` batch) over the rows as they are (the
cp.async route) and over the same rows zero-padded to a multiple of 8
columns (the TMA route; the padded index built from a padded copy, each
search padding its queries), for methods fused, groupmax and auto on the
device and fused with the blocks host-resident: host-clock medians, the
index build's time, whether the top-k agree. The key ``card`` after each
width holds the card's SM clock, temperature and power draw then.

``PYTHONPATH`` names the checkout whose package is timed, so two checkouts
compare on one card by running this script in turns with each (parent,
change, change, parent), from either tree; the ``package`` key says which
one ran.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

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
TOPK_KC = 128  # pass 1's depth: the fused search's kc


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


def bench_bf16(dev, g, corpus, res, tag="", batches=(512, 64)):
    """The four bf16 sweeps over ``corpus`` at each batch, queued, and pass
    1 (``topk_candidates``, kc = TOPK_KC over the rows but the last 77): a
    call between CUDA events and calls queued (a pass 1 that reads counts
    back to the host stalls the queue: its queued time holds the stall);
    their launches by route under ``routes<tag>``."""
    N = corpus.shape[0]
    tile = mk.TILE_ROWS if N % mk.TILE_ROWS == 0 else 256
    kernels = {name: getattr(mk, f"{name}_kernel")
               for name in ("count_above_groups", "count_above", "groupmax", "tile_max_scores",
                            "topk_candidates")}
    before = {name: dict(k.launches_by_route) for name, k in kernels.items()}
    for B in batches:
        q = torch.randn(B, corpus.shape[1], generator=g, device=dev).to(torch.bfloat16)
        tau = p9999(q, corpus)
        res[f"count_above_groups B={B} N={N}{tag}"] = queued_ms(
            lambda: mk.count_above_groups_kernel(q, corpus, tau))
        res[f"count_above B={B}{tag}"] = queued_ms(lambda: mk.count_above_kernel(q, corpus, tau))
        res[f"groupmax B={B}{tag}"] = queued_ms(lambda: mk.groupmax_kernel(q, corpus))
        res[f"tile_max_scores B={B}{tag}"] = queued_ms(
            lambda: mk.tile_max_scores_kernel(q, corpus, tile))
        pass1 = lambda: mk.topk_candidates_kernel(q, corpus, N - 77, TOPK_KC)  # noqa: E731
        res[f"topk_candidates B={B}{tag}"] = events_ms(pass1)
        res[f"topk_candidates queued B={B}{tag}"] = queued_ms(pass1)
    res[f"routes{tag or f' D={corpus.shape[1]}'}"] = {
        name: {r: n - before[name][r] for r, n in k.launches_by_route.items() if n > before[name][r]}
        for name, k in kernels.items()}
    return q


SWEEP_KERNELS = ("count_groups_wgmma_kernel", "count_above_wgmma_kernel", "groupmax_wgmma_kernel",
                 "tile_max_wgmma_kernel")
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "SYNCS", "BAR", "SHFL", "ATOMG", "BRA")


def _instance(mangled):
    """``name<a, b>`` of a mangled sweep kernel name (ints as they are,
    bools as 0 / 1), or None for other kernels."""
    for name in SWEEP_KERNELS:
        m = re.search(r"(?<![A-Za-z_])" + name + r"I((?:L[ib]\d+E)+)E", mangled)
        if m:
            return f"{name}<{', '.join(re.findall(r'L[ib](\d+)E', m.group(1)))}>"
    return None


def sweep_resources(sass_dir=None):
    """{instance: {"ptxas": ptxas's lines, "sass_lines": n, op: n, ...}} of
    the bf16 sweep kernels of the package's build; each instance's SASS
    written to ``sass_dir`` where given."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    res, name = {}, None
    for line in cuda_lib.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _instance(m.group(1))
        elif name and ("Used" in line or "stack frame" in line):
            res.setdefault(name, {}).setdefault("ptxas", []).append(line.split(":", 1)[-1].strip())
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return res
    sass = subprocess.run([tool, "--dump-sass", cuda_lib.build()], capture_output=True, text=True,
                          timeout=600).stdout
    for fn in sass.split("Function : ")[1:]:
        name = _instance(fn.split("\n", 1)[0])
        if not name:
            continue
        code = [l for l in fn.splitlines() if re.match(r"\s*/\*[0-9a-f]{4}\*/", l)]
        entry = res.setdefault(name, {})
        entry["sass_lines"] = len(code)
        entry.update({op: sum(re.search(r"\b" + op + r"\b", l) is not None for l in code)
                      for op in SASS_OPS})
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            with open(os.path.join(sass_dir, re.sub(r"\W+", "_", name) + ".sass"), "w") as f:
                f.write("\n".join(re.sub(r"\s*/\* 0x[0-9a-f]+ \*/", "", l) for l in code))
    return res


def card_state():
    """The card's SM clock, temperature and power draw, as nvidia-smi reads
    them now."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def host_ms(fn, reps=5):
    """Median host-clock time of one call that synchronises (after one
    untimed call)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bench_pad(dev, g, D, rows, B, res):
    """MipsIndex.search over ``rows`` x ``D`` bf16 rows as they are and
    zero-padded to a multiple of 8 columns (see the module docstring)."""
    import torch.nn.functional as F

    pad = -D % 8
    corpus = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn(B, D, generator=g, device=dev)
    tag = f" D={D} N={rows} B={B}"
    for method, host in (("fused", False), ("groupmax", False), ("auto", False), ("fused", True)):
        where = "host-resident" if host else "device"
        out = {}
        for label, width in (("as is", 0), ("padded", pad)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index = MipsIndex(dev, method=method, host_resident=host)
            index.add(F.pad(corpus, (0, width)) if width else corpus)
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - t0) * 1e3
            search = (lambda: index.search(F.pad(q, (0, width)), 100)) if width else (
                lambda: index.search(q, 100))
            out[label] = search()
            res[f"pad search {method} {where} {label}{tag}"] = {
                "ms": host_ms(search), "build_ms": build_ms}
            del index
            torch.cuda.empty_cache()
        (s0, i0), (s1, i1) = out["as is"], out["padded"]
        res[f"pad search {method} {where} same top-k{tag}"] = bool(
            np.array_equal(i0, i1) and np.array_equal(s0, s1))
    del corpus
    torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dims", type=int, nargs="+", default=[DIM])
    parser.add_argument("--sweeps-only", action="store_true")
    parser.add_argument("--rows", type=int, nargs="+", default=[ROWS],
                        help="rows of the blocks of each width other than 768")
    parser.add_argument("--batches", type=int, nargs="+", default=[512, 64],
                        help="query batches at each width other than 768")
    parser.add_argument("--resources", action="store_true",
                        help="the sweep kernels' registers, spills and SASS counts")
    parser.add_argument("--sass-dir", help="write each sweep kernel instance's SASS here")
    parser.add_argument("--pad-search", action="store_true",
                        help="MipsIndex.search over the rows as they are and zero-padded")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sweeps: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    if args.resources or args.sass_dir:
        res["resources"] = sweep_resources(args.sass_dir)
    for D in (d for d in args.dims if d != DIM):
        for rows in args.rows:
            wide = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
            bench_bf16(dev, g, wide, res, f" D={D}" + (f" N={rows}" if rows != ROWS else ""),
                       args.batches)
            del wide
            torch.cuda.empty_cache()
            res[f"card after D={D} N={rows}"] = card_state()
            if args.pad_search and D % 8:
                bench_pad(dev, g, D, rows, args.batches[0], res)
    if args.sweeps_only and DIM not in args.dims:
        print(json.dumps({"package": mk.__file__, "device": smi, "results": res}))
        return 0
    corpus = torch.randn(ROWS, DIM, generator=g, device=dev).to(torch.bfloat16)
    q = bench_bf16(dev, g, corpus, res)
    res[f"card after D={DIM}"] = card_state()
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
