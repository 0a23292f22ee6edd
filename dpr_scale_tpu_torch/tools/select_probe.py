"""Where the time of pass 1's select sweep goes, on one GPU.

    PYTHONPATH=. python dpr_scale_tpu_torch/tools/select_probe.py [--variants]

Over seeded random bf16 blocks (2,097,152 x 768 at B = 512 and 64; SPLADE's
30,522 columns over 65,536 and 1,280 rows at B = 256; kc = 128, the rows
past N - 77 pads) it times ``topk_candidates_kernel``: a call between CUDA
events, calls queued behind a GPU sleep, and its two steps (the select
sweep alone, ``dst_topk_select``, and the aggregation, ``torch.topk`` over
the parts' keys), each queued and single (``chip_smoke._topk_split``), and
holds the call against the plain version (``chip_smoke._check_topk``).

``--variants`` builds copies of ``csrc/topk_sweep.cu`` with other values of
its constants (when the warps merge, how often they read the published
bounds, 64-pair queues at 128 queries a block) and one that admits nothing
(the sweep with the count alone), each with ``nvcc`` into a library of its
own under ``build/select_probe/``, and times the select sweep of each,
queued, beside whether its top kc equals the first variant's.

Prints one JSON object a line; the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

from dpr_scale_tpu_torch.ops import cuda_lib
from dpr_scale_tpu_torch.ops import mips_kernels as mk

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED, KC = 5, 128
SHAPES = ((512, 1 << 21, 768), (64, 1 << 21, 768), (256, 65536, 30522), (256, 1280, 30522))
OUT = os.path.join(ROOT, "build", "select_probe")

# name -> [(text of csrc/topk_sweep.cu, its replacement)]
MERGE_AT, MERGE_ABOVE = "constexpr int MERGE_AT = SLOTS", "constexpr int MERGE_ABOVE = SLOTS"
VARIANTS = {
    "as_is": [],
    "merge_at_3_4_above_1_2": [(MERGE_AT + " / 2;", MERGE_AT + " * 3 / 4;"),
                               (MERGE_ABOVE + " / 4;", MERGE_ABOVE + " / 2;")],
    "merge_above_0": [(MERGE_ABOVE + " / 4;", "constexpr int MERGE_ABOVE = 0;")],
    "reread_8": [("constexpr int REREAD = 4;", "constexpr int REREAD = 8;")],
    "slots_64": [("static constexpr int SLOTS = QM == 64 ? 64 : 32;",
                  "static constexpr int SLOTS = 64;")],
    "admit_nothing": [("    if (!vote(!fits)) {", "    if (B > 0) return;\n    if (!vote(!fits)) {")],
}

def queued(fn, calls=10, reps=3):
    """Median device time of one of ``calls`` calls queued behind a GPU sleep."""
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


def build_copies(copies):
    """{name: ctypes library} of csrc/topk_sweep.cu with each name's
    replacements, built side by side."""
    src = open(os.path.join(cuda_lib.SRC_DIR, "topk_sweep.cu")).read()
    procs = {}
    for name, reps in copies.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(cuda_lib.SRC_DIR):
            shutil.copy(os.path.join(cuda_lib.SRC_DIR, f), os.path.join(d, f))
        s = src
        for a, b in reps:
            if s.count(a) != 1:
                raise RuntimeError(f"{name}: the source no longer holds {a!r}")
            s = s.replace(a, b)
        with open(os.path.join(d, "topk_sweep.cu"), "w") as f:
            f.write(s)
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *cuda_lib.LINK_FLAGS, "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "topk_sweep.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        lib.dst_topk_select.argtypes = [p] * 4 + [i, ll, ll, i, i, i, p]
        lib.dst_topk_select_width.argtypes = [ll, ll, i, i, i]
        lib.dst_topk_select_width.restype = ll
        libs[name] = lib
    return libs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--variants", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("select_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    dev = torch.device("cuda", 0)
    print(json.dumps({"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()}), flush=True)
    libs = build_copies(VARIANTS) if args.variants else {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    for B, N, D in SHAPES:
        what = f"B={B} N={N} D={D}"
        c = torch.randn(N, D, generator=g, device=dev).bfloat16()
        q = torch.randn(B, D, generator=g, device=dev)
        n_valid = N - 77
        call = lambda: mk.topk_candidates_kernel(q, c, n_valid, KC)  # noqa: E731
        _err, bad, line = chip_smoke._check_topk(call(), mk.topk_candidates_plain(
            q, c, n_valid, KC + 1), n_valid, q, c)
        split = chip_smoke._topk_split(q, c, n_valid, KC)
        print(json.dumps({what: {"call_ms": chip_smoke.cuda_ms(call), "queued_ms": queued(call),
                                 "steps_ms": {k: {"queued": a, "single": b}
                                              for k, (a, b) in split.items()},
                                 "faults": bad, "check": line}}), flush=True)
        qd = q.bfloat16()
        ref = None
        for name, lib in libs.items():
            width = lib.dst_topk_select_width(N, n_valid, B, D, KC)
            keys = torch.empty((B, width), dtype=torch.int64, device=dev)
            pub = torch.empty((B, 32), dtype=torch.int64, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            run = lambda: lib.dst_topk_select(  # noqa: E731
                qd.data_ptr(), c.data_ptr(), keys.data_ptr(), pub.data_ptr(), B, N, n_valid, D,
                KC, 0, stream)
            ms = queued(run)
            out = {"select_ms": ms}
            if name != "admit_nothing":
                top = torch.topk(keys, KC, dim=1).values
                out["same_top"] = ref is None or bool(torch.equal(top, ref))
                ref = top if ref is None else ref
            print(json.dumps({f"{name} {what}": out}), flush=True)
            del keys
        del c, q, qd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
