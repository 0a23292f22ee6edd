"""Where the device time goes on the port's serving path.

    python -m dpr_scale_tpu_torch.tools.profile_serve \
        [--config conf/nq.yaml] [--rows 1048576] [--out FILE] [overrides ...]

Run from the repository root, on one CUDA GPU (``--device cpu`` with a tiny
model and few rows only checks the script). At the config's model width
(conf/nq.yaml: bert_base, L = 256, bf16, fused attention; random weights
from a seed) it times and profiles

  * a corpus encode batch of B = 128 and B = 64 random token sequences,
    padded to 256 with ragged masks;
  * one ``MipsIndex.search`` of B = 8 and B = 64 queries at k = 128 over
    ``--rows`` rows, with the methods "fused" and "exact_sort". As in
    chip_smoke.py, the rows are encoded sequences plus distractors drawn
    around their mean at their columns' std; the queries are encoded short
    sequences.

For each it prints the host-clock wall time of one call (median of
unprofiled calls), the device kernel time of one call, their ratio as the
device's busy share, and the kernel time by class: torch.profiler's kernel
times for PyTorch's kernels, CUDA events around each launch for the port's
own (``cuda_lib.timed_launches``; the profiler drops some of those, e.g.
every 15-ms ``groupmax`` sweep of a lone call: ROADMAP C4). ``--out`` gets
torch.profiler's tables. The override ``task.model.fused_ffn=true``
profiles the fused-FFN configuration, whose kernels form a class of their
own.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType

from dpr_scale_tpu_torch.cli.common import build_biencoder, build_model_config
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder
from dpr_scale_tpu_torch.index.mips import MipsIndex

SEED = 0
PROFILED_CALLS = 3
# kernel-name fragments per class; the first class that matches wins
CLASSES = (
    ("attention kernels", ("attention_fwd_kernel", "attention_bwd_")),
    ("FFN kernels", ("ffn_gemm_kernel", "ln_rows_kernel")),  # task.model.fused_ffn=true
    ("count kernel", ("count_groups_kernel", "count_groups_wgmma_kernel")),
    ("MIPS sweep kernels", ("count_above_kernel", "count_above_wgmma_kernel", "groupmax_kernel",
                            "groupmax_wgmma_kernel", "tile_max_kernel", "tile_max_wgmma_kernel")),
    # before "top-k / sort": their names say topk
    ("pass-1 kernels", ("topk_select_wgmma_kernel", "topk_emit_tile_kernel")),
    ("gather-score kernels", ("gather_serial_kernel", "gather_pipelined_kernel",
                              "gather_streamed_kernel")),  # the CITADEL device search
    ("optimizer (multi-tensor)", ("multi_tensor",)),
    ("GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
    ("top-k / sort", ("topk", "sort")),
    ("elementwise / copy / reduce", ("elementwise", "reduce", "copy", "cat", "fill",
                                     "index", "scatter", "gather", "where")),
)


# the port's kernel entry points (ops/cuda_lib.py) and their classes above
PORT_CLASSES = {
    "dst_attention_fwd": "attention kernels", "dst_attention_bwd": "attention kernels",
    **dict.fromkeys(("dst_ffn_fwd", "dst_ffn_ln_fwd", "dst_ffn_gemm", "dst_ffn_ln_rows"),
                    "FFN kernels"),
    "dst_count_above_groups": "count kernel", "dst_topk_select": "pass-1 kernels",
    "dst_topk_emit": "pass-1 kernels",
    **dict.fromkeys(("dst_count_above", "dst_groupmax", "dst_tile_max", "dst_int_groupmax",
                     "dst_int8_tile_max"), "MIPS sweep kernels"),
    **dict.fromkeys(("dst_gather_serial", "dst_gather_pipelined", "dst_gather_streamed",
                     "dst_gather_run_max"), "gather-score kernels"),
}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_ms(fn, dev, reps=5, warmup=2):
    """Median host-clock time of one call, the device synchronised."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn, dev):
    """(profiler, {kernel name: device us over PROFILED_CALLS calls})."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        _sync(dev)
    kernels = {
        e.key: e.self_device_time_total
        for e in prof.key_averages()
        if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
    }
    return prof, kernels


def port_kernel_ms(fn, dev):
    """{class: device ms per call} of the port's kernels over PROFILED_CALLS
    calls, from CUDA events around each launch."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    with cuda_lib.timed_launches() as calls:
        for _ in range(PROFILED_CALLS):
            fn()
        _sync(dev)
    by_class = {}
    for entry, start, end in calls:
        c = PORT_CLASSES[entry]
        by_class[c] = by_class.get(c, 0.0) + start.elapsed_time(end) / PROFILED_CALLS
    return by_class


def report(name, fn, dev, out):
    wall = wall_ms(fn, dev)
    prof, kernels = device_profile(fn, dev)
    by_class = {c: 0.0 for c, _ in CLASSES}
    by_class["other"] = 0.0
    port = set(PORT_CLASSES.values())
    for key, us in kernels.items():
        low = key.lower()
        c = next((c for c, frags in CLASSES if any(f in low for f in frags)), "other")
        if c not in port:  # the port's kernels: by CUDA events below
            by_class[c] += us / PROFILED_CALLS / 1e3
    if dev.type == "cuda":
        for c, ms in port_kernel_ms(fn, dev).items():
            by_class[c] += ms
    busy = sum(by_class.values())
    print(f"== {name}: wall {wall:.3f} ms/call (host clock), device kernels "
          f"{busy:.3f} ms/call, busy share {busy / wall:.3f}")
    for c, ms in sorted(by_class.items(), key=lambda x: -x[1]):
        if ms > 0:
            print(f"   {c}: {ms:.3f} ms/call ({ms / busy:.1%})")
    if not busy:
        print("   no device kernel time was recorded")
    if out is not None:
        out.write(f"== {name} ({PROFILED_CALLS} calls)\n")
        out.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))
        out.write("\n\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="conf/nq.yaml")
    parser.add_argument("--rows", type=int, default=1 << 20)
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--out", default=None, help="file for the profiler tables")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    cfg = load_config(args.config, args.overrides)
    mcfg = build_model_config(cfg)
    L = cfg.task.transform.get("max_seq_len", 256)
    model = build_biencoder(cfg, dev, seed=SEED)
    ctx = CorpusEncoder(model, dev)
    qry = CorpusEncoder(model, dev, use_query_tower=True)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def tokens(B, lo, hi):
        """(B, L) random ids in [CLS] .. [SEP] form, lengths in [lo, hi]."""
        lens = torch.randint(lo, hi + 1, (B,), generator=g, device=dev)
        lens[0] = hi
        ids = torch.randint(5, mcfg.vocab_size, (B, L), generator=g, device=dev)
        mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        ids[:, 0] = 2
        ids[torch.arange(B, device=dev), lens - 1] = 3
        return ids * mask, mask

    out = open(args.out, "w") if args.out else None
    try:
        for B in (128, 64):
            ids, mask = tokens(B, min(40, L // 2), L)
            report(f"encode B={B} L={L}", lambda: ctx.encode(ids, mask), dev, out)

        # the corpus: encoded rows plus distractors around their mean
        enc = torch.cat([ctx.encode(*tokens(128, min(40, L // 2), L)) for _ in range(4)])
        noise = torch.randn(args.rows - enc.shape[0], enc.shape[1], generator=g, device=dev)
        rows = torch.cat([enc, enc.mean(0) + noise * enc.std(0)])
        del noise
        index = MipsIndex(dev)
        index.add(rows)
        del rows
        for B in (8, 64):
            q = qry.encode(*tokens(B, 8, 16))
            for method in ("fused", "exact_sort"):
                index.method = method
                report(f"search {method} B={B} k=128 over {args.rows:,} rows",
                       lambda: index.search(q, 128), dev, out)
                if method == "fused":
                    print(f"   repairs of the last fused search: {index.last_repair}")
    finally:
        if out is not None:
            out.close()
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(dev)}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
