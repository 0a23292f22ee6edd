"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``dpr_scale_tpu_torch/csrc`` and drives
its two paths at full bert_base width (conf/nq.yaml): serving (corpus
encoding through ``cli.generate_embeddings`` and ``/search`` requests
against ``cli.serve.build_retriever`` over a 1,048,576-row index) and
training (``cli.train``, dropout 0.1). Phases:

  1. the card (nvidia-smi name and power limit) and the tokenizer / config
     packages it has;
  2. attention kernel vs its plain PyTorch version at the encode shape
     (B=128, 12 heads, L=256, head_dim 64, bf16, ragged key masks) and the
     query-encode shape (B=512, L=32); its registers and shared memory,
     its times beside scaled_dot_product_attention's and the share of its
     bound; torch.profiler's device time of the kernel within 10% of CUDA
     events (ROADMAP C4);
  3. group-count kernel vs its plain version at B=64 over N=1,048,576 rows
     (phase 4's index) and at B=512 over 2,097,152 rows (phase 15's block,
     the fused search's pass 2), D=768 bf16, thresholds at each query's
     99.99th score percentile: counts within the COUNT_MARGIN_REL band;
     its launches by route (the wgmma kernel); its times, queued and single,
     beside the plain version, a cuBLAS yardstick (fp32-output products
     over 131,072-row chunks, the compare and the per-group sum) and the
     bound; the wgmma kernel's registers, spills, shared memory and HGMMA /
     UTMALDG counts in its SASS;
  4. the serving slice: a synthetic 30,522-entry WordPiece vocab and
     1,048,576-row passages TSV; bert_base (random weights from a seed)
     encodes the first 4,096 passages; 1,044,480 distractor rows join as a
     second shard; the server answers requests of 1, 5 and 40 questions at
     k = 5 and 100, each checked against a brute-force exact top-k over the
     same bf16 corpus; both kernels' launch counters must rise during this
     phase. Then one search of 64 queries is timed with the index's "fused"
     and "exact_sort" methods;
  5. the attention forward with dropout and the attention backward vs their
     plain versions at the shapes phase 6 gives them (B=256 contexts and
     B=128 queries, 12 heads, L=256, head_dim 64, bf16, ragged key masks,
     rates 0 and 0.1, one seed for both), seed repeatability, and their
     times at both rates beside scaled_dot_product_attention's and the
     share of their bound; the backward kernels' registers and shared
     memory;
  6. the training slice: a synthetic DPR-JSON train/val set over the same
     vocab, ``cli.train`` on conf/nq.yaml for 8 steps at batch 128 (128
     queries, 256 contexts, L = 256, dropout 0.1), then validation and test;
     loss and grad_norm finite, metrics back, the dropout forward's and the
     backward's launch counters must rise; median step time, queries/s and
     peak device memory are printed;
  7. gradient agreement at full width: batches of 16 queries and 32
     contexts at 4 weight seeds, dropout 0, the same weights (matrices at
     std 0.05) through each path; bf16 through the kernels vs the same
     model with the plain versions on the card, and vs fp32 through plain
     attention (TF32 off) on the same weights rounded to bf16: the losses
     and every parameter's gradient (cosine) must agree;
  8. the FFN kernels vs their plain versions at the shapes the fused-FFN
     configuration gives them (H=768, F=3072, bf16): ``fused_ffn`` at
     N = 65,536 (the contexts of a training step) and 32,768 (its queries,
     and an encode batch) at rates 0 and 0.1, ``fused_ffn_ln`` at N =
     32,768 at rate 0, both at a ragged N; y, pre (and x1, z) within
     FFN_REL of max |ref| and the same kept entries; the GEMM kernel's
     registers, spills and shared memory, and whether its SASS holds HGMMA
     (wgmma) and UTMALDG (TMA); their times queued behind a GPU sleep and
     as single calls, split into LN1 / GEMM1 / GEMM2 / LN2 launches, beside
     the unfused FFN half (cuBLAS GEMMs + elementwise) and the two bare
     cuBLAS products (the yardstick, ``cublas_pair_ms`` in the JSON) at the
     same shapes;
  9. phase 4 with ``task.model.fused_ffn=true`` over a 131,072-row index:
     the ``fused_ffn_ln`` and attention counters must rise;
 10. phases 6 and 7 with ``task.model.fused_ffn=true``: the ``fused_ffn``
     counter must rise in training and ``fused_ffn_ln``'s in validation and
     test; the gradient check runs the training composition (``fused_ffn``
     between two LayerNorms) with the FFN's plain version on the card as
     the second witness;
 11. the three posting gather-score kernels (serial, pipelined, streamed)
     vs their plain version at bucket sizes 512 .. 131,072, D = 32 and 128
     bf16 (and fp32 once), ragged entry counts, entries spread over the
     experts, all on one expert and with pad slots: max |err| within
     GATHER_REL of max |ref|, the pipelined kernel's scores the serial
     kernel's bits and every pipelined launch on its bulk-copy route;
     repeatability; their times (queued) beside the gather + bmm
     yardstick and the bound; the bulk-copy kernel's registers, shared
     memory and bulk-copy (UBLKCP) / mbarrier (SYNCS) instructions;
 12. the CITADEL CLI slice at full width (conf/citadel.yaml, bert_base from
     seed 0, the phase-4 vocab): ``cli.generate_multivec_embeddings``
     encodes 4,096 passages at L = 128 into expert shards, then
     ``cli.citadel_retrieval`` answers 256 TREC queries from the host index,
     the bf16 and the fp32 device index, the fp32 device index with every
     bucket streamed (``STREAM_MODE="on"``) and the bf16 device index with
     ``DPR_GATHER_KERNEL=pipelined``; fp32 runs equal the host run within
     CITADEL_TOL, bf16 within CITADEL_BF16_REL, pipelined equals serial;
     the serial, streamed and pipelined counters must rise, every
     pipelined launch on the bulk-copy route;
 13. the device search at the size its users run: the MS MARCO-like layout
     of tools/bench_citadel_device.py (8.8M docs, 21.1M padded postings in
     five buckets, D = 32 bf16, a 128-dim bf16 CLS plane) built on the
     card, B = 128 queries of 32 tokens routed uniformly, searched with the
     CLS term (dense combine) and without it (sorted combine): median
     search time, queries/s, the latency dict, peak memory and the device
     time by kernel class; the kernel path equals the plain-scorer path on
     the card and a numpy oracle on 4 queries; the tiled top-k equals
     ``torch.topk`` on a (128, 8.8M) accumulator (both timed); the
     kernels' JSON times are taken on that search's buckets, where the
     pipelined kernel must give the serial kernel's bits;
 14. the three MIPS sweep kernels (count_above, groupmax, tile_max_scores)
     vs their plain versions over 2,097,152 x 768 bf16 rows (the JAX
     bench.py geometry) at B = 512 (the retrieval CLI's query batch) and
     B = 64, plus an fp32 case and a ragged one (B = 7, D = 100, rows not a
     multiple of the kernels' 2,048-row span): counts exact where the
     threshold sits clear of every score (within the COUNT_MARGIN_REL
     bracket elsewhere), maxima within MAX_REL of max |ref|, repeated calls
     the same bits; their times beside the plain version, a cuBLAS yardstick
     (fp32-output products over 131,072-row chunks plus the reduction) and
     the bound (all three also queued behind a GPU sleep, with their share
     of the bound); their launches by route, the B = 512 and 64 cases on
     the wgmma kernels; those kernels' registers, spills, shared memory and
     HGMMA / UTMALDG counts in their SASS;
 15. the retrieval CLI slice at full width (conf/nq.yaml, bert_base from
     seed 0, the phase-4 vocab): ``cli.generate_embeddings`` encodes 4,096
     passages, fp16 distractors fill a second shard up to 2,097,152 rows
     (index blocks of 4,096, 2,000,000 and 93,056 rows),
     ``cli.generate_query_embeddings`` encodes 1,024 NQ-style questions,
     ``cli.run_retrieval`` answers them at k = 100 with
     ``task.mips_method=groupmax`` and ``=auto``, and ``retrieve()`` with
     ``fused``, ``approx`` and ``exact_sort`` over one built index; every
     method's DPR JSON equals a brute-force exact top-100 (``check_exact``),
     ``eval.qa_eval`` equals a recount with ``has_answers``, the
     count_above, count_above_groups and groupmax counters must rise; then
     ``MipsIndex.benchmark`` times groupmax, fused, auto and exact_sort at
     B = 512 over the 2,097,152-row block; every launch of the three
     sweeps in the phase on the wgmma route;
 16. the two integer sweep kernels vs their plain versions: int_groupmax
     (the tool's i4_groupmax) at the tool's geometry (4,194,304 x 768 int4,
     B = 256, random packed bytes, row scales U(0.5, 1.5)), at B = 512 and
     64 over 2,097,152 x 768 rows in int8 and int4 with one and two query
     planes, and ragged (B = 7, D = 100); int8_tile_max (the tool's
     pallas_dot) on the int8 and the tool's rows; values and rows exactly
     equal and repeatable; their times beside the plain version, a
     ``torch._int_mm`` yardstick and the bound (int_groupmax also queued,
     with its share of the bound); int_groupmax's launches by route, the
     D = 768 cases on the wgmma kernel; that kernel's registers, spills,
     shared memory and HGMMA / UTMALDG counts in its SASS;
 17. the quantised tiers on phase 15's shards and questions:
     ``cli.run_retrieval`` with ``task.mips_method=int8`` and with ``=int4
     task.rerank_oversample=4``, ``retrieve()`` with int8 at
     ``int8_query_planes=2`` and int4 without rerank; unreranked results
     equal the plain path's dequantised top-100 on the card, reranked
     scores the fp32 q . row of their shard rows; the int_groupmax counter
     must rise, every launch on the wgmma route; recall@100 against the exact fp32 top-100, peak memory and
     ``MipsIndex.benchmark`` of int8, int4 and groupmax at B = 512 over the
     2,097,152-row block.

Weights and data are made from fixed seeds. Needs a CUDA device; exits
non-zero without one, or when any check fails. The last two lines of
standard output are a JSON object of per-kernel results (with each
kernel's bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over 989 TFLOP/s bf16 or 1,979 TOPS int8, an H100 SXM's peaks,
and the time of one PyTorch call computing the same function where one
exists) and a JSON object ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
ATTN_ATOL = ATTN_RTOL = 1e-2  # bf16 outputs: two ulps at |x| ~ 1
COUNT_MARGIN_REL = 2e-5  # the fp32-ordering margin MipsIndex relies on
TOPK_REL = 1e-3  # served vs brute-force scores; near-tie swaps allowed
# backward kernel vs plain: max |err| of each of dq, dk, dv over its max |ref|
# (ds is rounded to bf16 at the same point in both, from fp32 values summed
# in other orders, so single entries may round one bf16 ulp apart)
GRAD_REL = 2e-2
TRAIN_BATCH = 128  # queries per step; contexts = 2 x queries (num_negative 1)
TRAIN_STEPS = 8
# phases 7 and 10 (phase_train_grads): GRAD_SEEDS weight seeds, each with
# its own batch, weights at GRAD_WEIGHT_STD. The loss (10-31 there) is a
# logsumexp minus a gold score, each in the hundreds, and any change of bf16
# rounding order moves it by up to ~2% on an H100 (the paths without the
# kernels included); a kernel that drops a term or a mask moves the loss by
# multiples or the gradient cosines far below 0.99. Per seed, the kernel
# path against the same model with the plain versions on the card and
# against the fp32 plain path on the same (bf16-rounded) weights: the loss
# within LOSS_REL, every cosine at least GRAD_COS.
LOSS_REL = 2e-2
GRAD_COS = 0.99
GRAD_SEEDS = 4
GRAD_WEIGHT_STD = 0.05
# FFN kernels vs plain: max |err| of each output over its max |ref| (bf16
# outputs of fp32 sums taken in other orders round at most an ulp apart)
FFN_REL = 1e-2
FFN_H, FFN_F = 768, 3072  # bert_base
FFN_INDEX_ROWS = 1 << 17  # phase 9's index: the fused FFN changes the encoder, not the index
# gather-score kernels vs plain: max |err| over max |ref| (both sides sum
# fp32 products of the same rounded operands, only in another order)
GATHER_REL = 1e-4
GATHER_BUCKETS = (512, 2048, 8192, 32768, 131072)
GATHER_SCORES = 1 << 21  # entries x rows of one phase-11 call (E = 2**21 / L)
# phase 12: fp32 device vs host run, each query's {doc: score} (the JAX CLI
# test's tolerance); bf16 device vs host, relative to the query's top score;
# pipelined vs serial (the same per-row sums; index_add_ orders its fp32
# atomics differently run to run)
CITADEL_TOL = 1e-4
CITADEL_BF16_REL = 1e-2
CITADEL_SAME_REL = 1e-5
CITADEL_PASSAGES, CITADEL_QUERIES = 4096, 256
# phase 13: tools/bench_citadel_device.py's layout (bucket size, experts)
CITADEL_DOCS = 8_800_000
CITADEL_PLAN = ((512, 8000), (2048, 3000), (8192, 800), (32768, 100), (131072, 8))
CITADEL_BATCH, CITADEL_QTOKENS, CITADEL_DIM, CITADEL_CLS_DIM = 128, 32, 32, 128
CITADEL_ORACLE_QUERIES = 4
# phases 14-15: the JAX bench.py geometry (CORPUS_ROWS x 768 bf16); maxima
# of the same fp32 products summed in another order within MAX_REL of max
# |ref| (the COUNT_MARGIN_REL bound)
MIPS_ROWS, MIPS_DIM = 1 << 21, 768
MAX_REL = 2e-5
YARD_CHUNK = 131072
RETRIEVAL_QUERIES, RETRIEVAL_K, QUERY_BATCH = 1024, 100, 512
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_FLOPS = 989e12
INT8_OPS = 1979e12  # dense int8 tensor-core operations
FP32_FLOPS = 67e12  # CUDA cores, no tensor cores


def bound(nbytes, flops, peak=BF16_FLOPS):
    """(bound_ms, bound_by): the least time for ``nbytes`` of device memory
    traffic and ``flops`` operations at ``peak`` (bf16 tensor cores unless
    given) on an H100 SXM."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def library_ms(fn, timer=None):
    """Device time (``cuda_ms`` unless ``timer`` is given) of a PyTorch call
    that computes a kernel's function, the yardstick beside it; None (and
    the reason printed) if the call fails."""
    try:
        return (timer or cuda_ms)(fn)
    except RuntimeError as e:
        print(f"library call failed: {e}")
        return None


def cuda_ms(fn, reps=10, warmup=2):
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
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


def device_ms(fn, calls=20, reps=3):
    """Median device time of one call for kernels of tens of microseconds:
    ``calls`` calls enqueued back to back behind a GPU sleep, so the host's
    per-call launch cost (a wrapper's checks and ctypes call) does not
    leave the card idle between them, as it does inside ``cuda_ms``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)  # the host enqueues the calls meanwhile
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def host_ms(fn, reps=5, warmup=1):
    """Median host-clock time of one call (the call must synchronise)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device():
    import importlib

    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    probe = {}
    for mod in ("transformers", "tokenizers", "yaml", "regex"):
        try:
            probe[mod] = importlib.import_module(mod).__version__
        except ImportError:
            probe[mod] = None
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; packages {probe}")
    return smi


# a mangled template argument of the port's kernels: an int or bool, bf16, fp32
TEMPLATE_ARG = r"L[ib]\d+E|13__nv_bfloat16|f"


def template_args(mangled):
    """The template arguments of a mangled kernel name, readable: ints as
    they are, the element types as bf16 / fp32."""
    return [x or {"13__nv_bfloat16": "bf16", "f": "fp32"}[y]
            for x, y in re.findall(r"L[ib](\d+)E|(13__nv_bfloat16|f)", mangled or "")]


def kernel_resources(prefix):
    """Registers, stack and spills of each kernel of the build whose name
    starts with ``prefix``, as ptxas printed them (``cuda_lib.build_log()``),
    one line per template instance ``name<a, b, ...>`` (the attention
    kernels' width and dropout, the FFN GEMM's tile width and epilogue, the
    sweeps' packing, planes, query tile and rows flag)."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    found, name = {}, None
    for line in cuda_lib.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the function's own name: the digit-free run before its template
            # arguments (the anonymous namespace's name holds the file's)
            t = re.search(r"([A-Za-z_]+_kernel)(?:I((?:" + TEMPLATE_ARG + r")+)E)?", m.group(1))
            name = None
            if t and t.group(1).startswith(prefix):
                args = template_args(t.group(2))
                name = t.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif name and ("Used" in line or "stack frame" in line):
            found.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return [f"{n}: {'; '.join(v)}" for n, v in sorted(found.items())]


def _fwd_case(dev, B, L, seed, nh=12, hd=64):
    """The rate-0 forward against plain at one shape with ragged key masks:
    max error, kernel times (queued and single-call), plain and SDPA times,
    bound and its share."""
    import torch

    from dpr_scale_tpu_torch.ops import attention, cuda_lib

    q, k, v, bias, _ = _attention_inputs(dev, B, nh, L, hd, seed)
    out = attention.attention_fwd_kernel(q, k, v, bias)
    torch.cuda.synchronize()
    ref = attention.attention_plain(q, k, v, bias)
    err = (out.float() - ref.float()).abs()
    bad = (err > ATTN_ATOL + ATTN_RTOL * ref.float().abs()).sum().item()
    max_err = err.max().item()
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f"attention kernel disagrees with its plain version at B={B} L={L}")
    del ref, err
    fn = lambda: attention.attention_fwd_kernel(q, k, v, bias)
    ms, single_ms = device_ms(fn), cuda_ms(fn)
    plain_ms = cuda_ms(lambda: attention.attention_plain(q, k, v, bias))
    mask = bias.to(q.dtype)[:, :, None, :]
    lib_ms = library_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), timer=device_ms)
    bound_ms, bound_by = bound(nbytes(q, k, v, bias, out), 4 * B * nh * L * L * hd)
    smem = cuda_lib.library().dst_attention_fwd_smem(L, hd)
    print(f"attention_fwd (B={B} nh={nh} L={L} hd={hd} bf16, rate 0): max_abs_err {max_err:.3g}, "
          f"{bad} outside {ATTN_ATOL}+{ATTN_RTOL}|ref|; kernel {ms:.4f} ms queued "
          f"({single_ms:.4f} ms single call), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms} ms, bound {bound_ms:.4f} ms ({bound_by}) = "
          f"{bound_ms / ms:.1%} of the kernel's time; {smem} bytes of shared memory a block")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def check_profiler(dev, B=128, L=256, nh=12, hd=64, tol=0.1):
    """ROADMAP C4: ``profile_serve.device_profile`` (torch.profiler) on lone
    ``attention_fwd_kernel`` calls must report the kernel's device time
    within ``tol`` of its CUDA-event time (calls queued behind a GPU sleep)."""
    from dpr_scale_tpu_torch.ops import attention
    from dpr_scale_tpu_torch.tools import profile_serve

    q, k, v, bias, _ = _attention_inputs(dev, B, nh, L, hd, SEED)
    fn = lambda: attention.attention_fwd_kernel(q, k, v, bias)
    events = device_ms(fn)
    _prof, kernels = profile_serve.device_profile(fn, dev)
    prof = sum(us for name, us in kernels.items() if "attention_fwd_kernel" in name)
    prof = prof / profile_serve.PROFILED_CALLS / 1e3
    launches = profile_serve.port_kernel_ms(fn, dev)["attention kernels"]
    print(f"torch.profiler on a lone attention_fwd_kernel call (B={B} L={L}): {prof:.4f} ms of "
          f"device time vs {events:.4f} ms by CUDA events (queued calls), {launches:.4f} ms by "
          f"the reports' events around each launch; kernels seen {sorted(kernels)}")
    if abs(prof - events) > tol * events:
        raise AssertionError("torch.profiler misses the port's kernel time (ROADMAP C4)")


def phase_attention():
    """Phase 2: the forward against plain at the encode shape (B=128,
    L=256) and the query-encode shape (the retrieval CLI's batch, L=32),
    the kernels' registers and shared memory, and the profiler check."""
    import torch

    dev = torch.device("cuda", 0)
    print("\n".join(kernel_resources("attention_fwd_kernel")))
    entry = _fwd_case(dev, 128, 256, SEED)
    _fwd_case(dev, QUERY_BATCH, 32, SEED + 1)
    check_profiler(dev)
    return entry


# phase 3: (B, N, D) of the group counts: a serving batch over phase 4's
# 1,048,576 rows, and the retrieval CLI's batch over phase 15's largest
# block (the fused search's pass 2)
COUNT_CASES = ((64, 1 << 20, MIPS_DIM), (QUERY_BATCH, MIPS_ROWS, MIPS_DIM))


def _yard_scores(q, corpus):
    """cuBLAS products with fp32 output over YARD_CHUNK-row chunks."""
    import torch

    q = q.to(corpus.dtype)
    for lo in range(0, corpus.shape[0], YARD_CHUNK):
        yield lo, torch.mm(q, corpus[lo : lo + YARD_CHUNK].T, out_dtype=torch.float32)


def _yard_count_groups(q, corpus, tau, group):
    """count_above_groups' yardstick: the chunked products, the compare and
    the per-group sum in PyTorch."""
    import torch

    B = q.shape[0]
    out = torch.empty((B, corpus.shape[0] // group), dtype=torch.int32, device=corpus.device)
    for lo, s in _yard_scores(q, corpus):
        out[:, lo // group : (lo + s.shape[1]) // group] = (
            (s > tau[:, None]).view(B, -1, group).sum(dim=2, dtype=torch.int32))
    return out


def phase_count(dev, cases=COUNT_CASES, group=256):
    """Phase 3: count_above_groups against its plain version on ``dev`` for
    each (B, N, D) of ``cases`` (bf16, thresholds at each query's 99.99th
    score percentile), within the COUNT_MARGIN_REL band; on the card also
    its times, yardstick and bound. Returns the JSON entry of the last case
    (times absent off the card), max |err| over all cases."""
    import torch

    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    entry = {"max_abs_err": 0.0}
    for B, N, D in cases:
        kernel = mk.count_above_groups_kernel  # looked up now: a rehearsal patches it
        q = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
        corpus = torch.randn(N, D, generator=g, device=dev).to(torch.bfloat16)
        tau = _top_scores(q, corpus, N // 10000 + 1)[:, -1].contiguous()  # p99.99
        what = f"B={B} N={N} D={D} bf16, tau p99.99"
        routes = dict(getattr(kernel, "launches_by_route", {}))
        out = kernel(q, corpus, tau, group)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if routes:
            routes = {r: n - routes[r] for r, n in kernel.launches_by_route.items()}
            print(f"count_above_groups ({what}): launches by route {routes}")
            if D == MIPS_DIM and routes["wgmma"] != 1:
                raise AssertionError(f"count_above_groups ({what}) did not run the wgmma kernel")
        plain = mk.count_above_groups_plain(q, corpus, tau, group)
        m = COUNT_MARGIN_REL * tau.abs()
        lo = mk.count_above_groups_plain(q, corpus, tau + m, group)
        hi = mk.count_above_groups_plain(q, corpus, tau - m, group)
        diff = (out - plain).abs().max().item()
        out_of_band = ((out < lo) | (out > hi)).sum().item()
        print(f"count_above_groups ({what}): {(out != plain).sum().item()} counts differ (max "
              f"{diff}), {out_of_band} outside the {COUNT_MARGIN_REL} relative margin of tau")
        if out_of_band or out.shape != (B, N // group):
            raise AssertionError("count kernel disagrees with its plain version")
        entry["max_abs_err"] = max(entry["max_abs_err"], float(diff))
        del out, plain, lo, hi
        if dev.type == "cuda":
            fn = lambda: kernel(q, corpus, tau, group)
            ms, single_ms = device_ms(fn, calls=10), cuda_ms(fn)
            plain_ms = cuda_ms(lambda: mk.count_above_groups_plain(q, corpus, tau, group),
                               reps=5, warmup=1)
            yard_ms = cuda_ms(lambda: _yard_count_groups(q, corpus, tau, group), reps=5, warmup=1)
            bound_ms, bound_by = bound(nbytes(q, corpus, tau) + 4 * B * (N // group), 2 * B * N * D)
            print(f"count_above_groups ({what}): kernel {ms:.4f} ms queued ({single_ms:.4f} ms "
                  f"single call), plain {plain_ms:.4f} ms, cuBLAS yardstick {yard_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}) = {bound_ms / ms:.1%} of the kernel's "
                  "time; no single PyTorch call counts scores per group")
            entry.update(ms=ms, single_ms=single_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
            # what the counts' atomics cost: none at tau = +inf, one per
            # (query, group) at -inf (the fused search's thresholds add ~k)
            inf = torch.full_like(tau, float("inf"))
            none_ms = device_ms(lambda: kernel(q, corpus, inf, group), calls=10)
            all_ms = device_ms(lambda: kernel(q, corpus, -inf, group), calls=10)
            print(f"count_above_groups ({what[:what.index(', tau')]}): {none_ms:.4f} ms queued at "
                  f"tau = +inf (no atomic), {all_ms:.4f} ms at tau = -inf ({B * (N // group)} "
                  "atomics)")
        del q, corpus, tau
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(sweep_build_report("count_groups_wgmma_kernel", "count_above_groups wgmma",
                                 lambda lib: {f"B={B}": lib.dst_bf16_sweep_smem(B) for B in (512, 64)}))
    return entry


def write_tokenizer(path, vocab):
    """A BERT WordPiece tokenizer directory (lower-case, [CLS] .. [SEP])."""
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors

    tk = Tokenizer(models.WordPiece(vocab={w: i for i, w in enumerate(vocab)}, unk_token="[UNK]"))
    tk.normalizer = normalizers.BertNormalizer(lowercase=True)
    tk.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tk.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", 2), ("[SEP]", 3)],
    )
    tk.decoder = decoders.WordPiece()
    os.makedirs(path, exist_ok=True)
    tk.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({
            "tokenizer_class": "BertTokenizer", "do_lower_case": True,
            "unk_token": "[UNK]", "pad_token": "[PAD]", "cls_token": "[CLS]",
            "sep_token": "[SEP]", "mask_token": "[MASK]", "model_max_length": 512,
        }, f)


def post(url, questions, k):
    req = urllib.request.Request(
        url + "/search", data=json.dumps({"questions": questions, "k": k}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())["results"]


def check_exact(index, q, results, k, chunk=128):
    """Served ids against a brute-force fp32-accumulated top-k over the
    index's own bf16 rows, ``chunk`` queries at a time; swaps only among
    scores within TOPK_REL of the k-th best."""
    import torch

    for lo in range(0, len(results), chunk):
        s = torch.cat([
            q[lo : lo + chunk].to(index.dtype).float() @ emb[:n].float().T
            for emb, n, _off in index._blocks
        ], dim=1)
        best = torch.topk(s, k, dim=1)
        for j, ctxs in enumerate(results[lo : lo + chunk]):
            b = lo + j
            ids = [int(c["id"]) for c in ctxs]
            kth = best.values[j, -1].item()
            tol = TOPK_REL * abs(kth)
            true = s[j, torch.tensor(ids, device=s.device)]
            served = torch.tensor([c["score"] for c in ctxs], device=s.device)
            if len(ids) != k or len(set(ids)) != k:
                raise AssertionError(f"query {b}: {len(ids)} ids, {len(set(ids))} distinct, k={k}")
            if ((served - true).abs() > TOPK_REL * true.abs() + 1e-6).any():
                raise AssertionError(f"query {b}: served scores differ from brute force")
            if (true < kth - tol).any():
                raise AssertionError(f"query {b}: served a row below the exact k-th score")
            missed = set(best.indices[j].tolist()) - set(ids)
            if any(s[j, i].item() > kth + tol for i in missed):
                raise AssertionError(f"query {b}: missed an exact top-{k} row")
        del s, best


def phase_slice(work, dev, n_rows=1 << 20, n_encoded=4096, extra=()):
    """The serving slice on ``dev``; ``n_rows``/``n_encoded``/``extra``
    config overrides only shrink it for a rehearsal on the CPU."""
    import numpy as np
    import torch

    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.cli import generate_embeddings, serve
    from dpr_scale_tpu_torch.cli.common import build_biencoder, build_model_config, build_tokenizer
    from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder
    from dpr_scale_tpu_torch.ops import attention, ffn, mips_kernels
    from dpr_scale_tpu_torch.retrieve.server import make_server

    rng = np.random.default_rng(SEED)
    words = np.array([f"w{i}" for i in range(30522 - 5)])  # rng.choice copies a list per call
    tok_dir, tsv, embs = (os.path.join(work, n) for n in ("tok", "passages.tsv", "embs"))
    write_tokenizer(tok_dir, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words.tolist())
    lengths = rng.integers(40, 200, size=n_encoded)  # up to ~L=256 with the title
    with open(tsv, "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(n_encoded):
            text = " ".join(rng.choice(words, size=lengths[i]))
            f.write(f"{i}\t{text}\t{' '.join(rng.choice(words, size=3))}\n")
        f.writelines(f"{i}\tdistractor {i}\tdistractor\n" for i in range(n_encoded, n_rows))
    overrides = [
        f"task.transform.model_path={tok_dir}", f"datamodule.passages_path={tsv}",
        f"task.ctx_embeddings_dir={embs}", "serve.method=fused", "serve.k=10", *extra,
    ]
    cfg_path = os.path.join(ROOT, "conf", "nq.yaml")
    cfg = load_config(cfg_path, overrides)
    fused_ffn = build_model_config(cfg).fused_ffn

    attention.attention_fwd_kernel.launches = 0
    mips_kernels.count_above_groups_kernel.launches = 0
    ffn.ffn_ln_fwd_kernel.launches = 0
    # ---- encode the first 4,096 passages: shard 0 of 256 ----
    t0 = time.perf_counter()
    path = generate_embeddings.main(
        ["--config", cfg_path, "--device", str(dev), *overrides, "task.shard=0",
         f"task.num_shards={n_rows // n_encoded}", "datamodule.encode_batch_size=128"]
    )
    enc_s = time.perf_counter() - t0
    from dpr_scale_tpu_torch.encode.embeddings import load_embedding_shard

    emb = load_embedding_shard(path)
    dim = emb.shape[1]
    if emb.shape[0] != n_encoded or emb.dtype != np.float32 or not np.isfinite(emb).all():
        raise AssertionError(f"shard 0: {emb.shape} {emb.dtype}, finite={np.isfinite(emb).all()}")
    print(f"encode: {n_encoded} passages in {enc_s:.2f} s wall = {n_encoded / enc_s:.1f} passages/s "
          "(CLI incl. model init, tokenization, shard write)")

    # ---- distractors: encoded mean + seeded noise at the columns' std ----
    e = torch.from_numpy(emb).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    noise = torch.randn(n_rows - n_encoded, dim, generator=g, device=dev)
    distract = (e.mean(0) + noise * e.std(0)).half().cpu().numpy()
    np.save(os.path.join(embs, "reps_0001.npy"), distract)
    del e, noise, distract

    # ---- serve ----
    t0 = time.perf_counter()
    retriever = serve.build_retriever(cfg, dev)
    print(f"build_retriever: {time.perf_counter() - t0:.2f} s "
          f"({retriever.num_rows} rows, blocks {[b[0].shape[0] for b in retriever.index._blocks]})")
    server = make_server(retriever, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    latencies, served = [], []
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        if health["corpus_rows"] != n_rows:
            raise AssertionError(f"healthz: {health}")
        for nq in (1, 5, 40):
            questions = [" ".join(rng.choice(words, size=12)) for _ in range(nq)]
            for k in (5, 100):
                t0 = time.perf_counter()
                served.append((questions, k, post(url, questions, k)))
                latencies.append((nq, k, (time.perf_counter() - t0) * 1e3))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    # read before the checks below, whose query encodes also launch kernels
    launches = {
        "attention_fwd": attention.attention_fwd_kernel.launches,
        "count_above_groups": mips_kernels.count_above_groups_kernel.launches,
    }
    if fused_ffn:
        launches["ffn_ln_fwd"] = ffn.ffn_ln_fwd_kernel.launches
    for questions, k, results in served:
        with torch.inference_mode():
            q = retriever._encode_chunk(questions)[: len(questions)]
            check_exact(retriever.index, q, results, k)
    print("request latency ms (questions, k, ms): "
          + ", ".join(f"({nq}, {k}, {ms:.2f})" for nq, k, ms in latencies))
    print(f"repairs of the last search: {retriever.index.last_repair}")
    print(f"main-path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # ---- where the time goes: device encode rate, one request's stages ----
    tok = build_tokenizer(cfg)
    ids, mask = tok([" ".join(rng.choice(words, size=150)) for _ in range(128)])
    enc128 = cuda_ms(lambda: retriever.encoder.encode(ids, mask), reps=5)
    print(f"device encode B=128 L={ids.shape[1]}: {enc128:.2f} ms/batch = "
          f"{128e3 / enc128:.1f} passages/s")
    questions = [" ".join(rng.choice(words, size=12)) for _ in range(40)]
    padded = questions + [""] * (retriever._pad_batch(40) - 40)
    tok_ms = host_ms(lambda: tok(padded))
    qids, qmask = tok(padded)
    q_ms = cuda_ms(lambda: retriever.encoder.encode(qids, qmask), reps=5)
    q = retriever.encoder.encode(qids, qmask)
    index = retriever.index
    search_ms, found, repairs = {}, {}, {}
    for method in ("fused", "exact_sort"):  # same index and queries, back to back
        index.method = method
        search_ms[method] = host_ms(lambda: index.search(q, 128))  # returns numpy: synced
        found[method] = index.search(q, 128)
        repairs[method] = index.last_repair
    index.method = "fused"
    (fs, fi), (es, ei) = found["fused"], found["exact_sort"]
    print(f"request of 40 questions (batch {len(padded)}, k searched 128): tokenize "
          f"{tok_ms:.2f} ms host, encode {q_ms:.2f} ms device, search {search_ms['fused']:.2f} ms "
          f"host (to numpy results; exact_sort {search_ms['exact_sort']:.2f} ms; "
          f"{int((fi != ei).any(1).sum())} of {len(padded)} queries' ids differ in order or "
          f"membership, their ranked scores by at most {np.abs(fs - es).max():.3g} "
          f"(scores up to {np.abs(es).max():.3g}); fused repairs {repairs['fused']})")
    if (np.abs(fs - es) > TOPK_REL * np.abs(es) + 1e-6).any():
        raise AssertionError("fused and exact_sort rank different scores")

    # ---- the bf16 kernel path against an fp32 plain-attention reference ----
    ref_cfg = load_config(cfg_path, overrides + [
        "task.model.dtype=float32", "task.model.fused_attention=false",
        "task.model.fused_ffn=false"])
    ref = CorpusEncoder(build_biencoder(ref_cfg, dev), dev)
    ids, mask = tok([" ".join(rng.choice(words, size=n)) for n in (30, 90, 150, 240)])
    cos = torch.nn.functional.cosine_similarity(
        retriever.encoder.encode(ids, mask), ref.encode(ids, mask), dim=1)
    print(f"bf16 kernel path vs fp32 plain encoder: min cosine {cos.min().item():.6f}")
    if cos.min().item() < 0.99:
        raise AssertionError("the bf16 kernel encoder disagrees with the fp32 reference")
    return launches


def _attention_inputs(dev, B, nh, L, hd, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, go = (
        torch.randn(B, nh, L, hd, generator=g, device=dev).to(torch.bfloat16) for _ in range(4)
    )
    lens = torch.randint(16, L + 1, (B,), generator=g, device=dev)
    lens[0] = L
    bias = (torch.arange(L, device=dev)[None, :] >= lens[:, None]).float() * -1e9
    return q, k, v, bias[:, None, :].contiguous(), go


def _check_train_kernels(B, nh=12, L=256, hd=64):
    """The dropout forward and the backward against their plain versions at
    one batch; returns their max errors and times at rate 0.1."""
    import torch

    from dpr_scale_tpu_torch.ops import attention
    from dpr_scale_tpu_torch.tools import profile_serve

    dev = torch.device("cuda", 0)
    q, k, v, bias, go = _attention_inputs(dev, B, nh, L, hd, SEED + 3)
    seed, fwd_err, bwd_err = 1234, 0.0, 0.0
    for rate in (0.0, 0.1):
        o = attention.attention_fwd_kernel(q, k, v, bias, seed, rate)
        grads = attention.attention_bwd_kernel(q, k, v, bias, go, seed, rate)
        torch.cuda.synchronize()
        ref = attention.attention_plain(q, k, v, bias, seed, rate).float()
        err = (o.float() - ref).abs()
        bad = (err > ATTN_ATOL + ATTN_RTOL * ref.abs()).sum().item()
        del ref
        refs = attention.attention_bwd_plain(q, k, v, bias, go, seed, rate)
        gerr = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, refs)]
        gscale = [b.float().abs().max().item() for b in refs]
        del refs
        print(f"rate {rate} (B={B} nh={nh} L={L} hd={hd} bf16): forward max_abs_err "
              f"{err.max().item():.3g}, {bad} outside {ATTN_ATOL}+{ATTN_RTOL}|ref|; backward "
              + ", ".join(f"d{n} max_abs_err {e:.3g} of max |ref| {m:.3g}"
                          for n, e, m in zip("qkv", gerr, gscale)))
        if bad or not torch.isfinite(o).all():
            raise AssertionError(f"dropout forward disagrees with its plain version at rate {rate}")
        if any(e > GRAD_REL * m for e, m in zip(gerr, gscale)) or not all(
            torch.isfinite(t).all() for t in grads
        ):
            raise AssertionError(f"attention backward disagrees with its plain version at rate {rate}")
        fwd_err, bwd_err = max(fwd_err, err.max().item()), max(bwd_err, *gerr)
        del o, grads, err
    again = attention.attention_fwd_kernel(q, k, v, bias, seed, 0.1)
    other = attention.attention_fwd_kernel(q, k, v, bias, seed + 1, 0.1)
    dq_again = attention.attention_bwd_kernel(q, k, v, bias, go, seed, 0.1)[0]
    dq_other = attention.attention_bwd_kernel(q, k, v, bias, go, seed + 1, 0.1)[0]
    first = attention.attention_fwd_kernel(q, k, v, bias, seed, 0.1)
    dq_first = attention.attention_bwd_kernel(q, k, v, bias, go, seed, 0.1)[0]
    torch.cuda.synchronize()
    if not (torch.equal(first, again) and torch.equal(dq_first, dq_again)):
        raise AssertionError("the dropout kernels do not repeat for a repeated seed")
    if torch.equal(first, other) or torch.equal(dq_first, dq_other):
        raise AssertionError("the dropout kernels ignore their seed")
    # times at both rates: the kernels queued behind a GPU sleep (and as
    # single calls), the plain versions, and the yardstick,
    # scaled_dot_product_attention at the same rate, forward and (through
    # autograd, its graph kept) backward
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = bias.to(q.dtype)[:, :, None, :]
    fwd_bound = bound(nbytes(q, k, v, bias, q), 4 * B * nh * L * L * hd)
    bwd_bound = bound(nbytes(q, k, v, bias, go) + 3 * nbytes(q), 10 * B * nh * L * L * hd)
    times = {}
    for rate in (0.0, 0.1):
        fwd = lambda: attention.attention_fwd_kernel(q, k, v, bias, seed, rate)
        bwd = lambda: attention.attention_bwd_kernel(q, k, v, bias, go, seed, rate)
        t = {"fwd": device_ms(fwd), "fwd_single": cuda_ms(fwd),
             "fwd_plain": cuda_ms(lambda: attention.attention_plain(q, k, v, bias, seed, rate)),
             "bwd": device_ms(bwd), "bwd_single": cuda_ms(bwd),
             "bwd_plain": cuda_ms(
                 lambda: attention.attention_bwd_plain(q, k, v, bias, go, seed, rate)),
             "fwd_lib": library_ms(lambda: sdpa(q, k, v, attn_mask=mask, dropout_p=rate),
                                   timer=device_ms)}
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        try:
            lib_out = sdpa(qg, kg, vg, attn_mask=mask, dropout_p=rate)
            t["bwd_lib"] = library_ms(lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), go, retain_graph=True), timer=device_ms)
        except RuntimeError as e:
            print(f"library call failed: {e}")
            t["bwd_lib"] = None
        del qg, kg, vg
        _prof, kernels = profile_serve.device_profile(bwd, dev)
        t["bwd_split"] = {part: sum(us for name, us in kernels.items() if f"{part}_kernel" in name)
                          / profile_serve.PROFILED_CALLS / 1e3 for part in ("dq", "dkdv")}
        times[rate] = t
        print(f"B={B} rate {rate}: forward kernel {t['fwd']:.4f} ms queued ({t['fwd_single']:.4f} "
              f"ms single call), plain {t['fwd_plain']:.4f} ms, scaled_dot_product_attention "
              f"{t['fwd_lib']} ms, bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}) = "
              f"{fwd_bound[0] / t['fwd']:.1%}; backward kernel {t['bwd']:.4f} ms queued "
              f"({t['bwd_single']:.4f} ms single call), plain {t['bwd_plain']:.4f} ms, "
              f"scaled_dot_product_attention {t['bwd_lib']} ms, bound {bwd_bound[0]:.4f} ms "
              f"({bwd_bound[1]}) = {bwd_bound[0] / t['bwd']:.1%}; by kernel (torch.profiler) "
              f"dq {t['bwd_split']['dq']:.4f} ms, dk/dv {t['bwd_split']['dkdv']:.4f} ms")
    print(f"B={B}: seed repeats and varies")
    t = times[0.1]
    return {
        "attention_fwd_dropout": {"max_abs_err": fwd_err, "ms": t["fwd"],
                                  "plain_ms": t["fwd_plain"], "bound_ms": fwd_bound[0],
                                  "bound_by": fwd_bound[1], "library_ms": t["fwd_lib"]},
        "attention_bwd": {"max_abs_err": bwd_err, "ms": t["bwd"], "plain_ms": t["bwd_plain"],
                          "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                          "library_ms": t["bwd_lib"]},
    }


def phase_train_kernels():
    """Phase 5: both training kernels against their plain versions at the
    shapes phase 6 gives them, the contexts' batch (2 x TRAIN_BATCH) and
    the queries' (TRAIN_BATCH), both padded to L = 256; returns the errors
    (the larger of the two) and the contexts' times."""
    import torch

    from dpr_scale_tpu_torch.ops import cuda_lib

    print("\n".join(kernel_resources("attention_bwd_")))
    lib = cuda_lib.library()
    print(f"shared memory a block at L=256 hd=64: dq kernel {lib.dst_attention_bwd_smem(256, 64, 0)}"
          f" bytes, dk/dv kernel {lib.dst_attention_bwd_smem(256, 64, 1)} bytes")
    ctx = _check_train_kernels(2 * TRAIN_BATCH)
    torch.cuda.empty_cache()
    qry = _check_train_kernels(TRAIN_BATCH)
    torch.cuda.empty_cache()
    for name, r in ctx.items():
        r["max_abs_err"] = max(r["max_abs_err"], qry[name]["max_abs_err"])
    return ctx


def write_dpr_jsonl(path, rng, words, n_rows):
    """Synthetic DPR training rows (tests/conftest.py::dpr10_jsonl's layout):
    a 12-word question, one positive and 1-2 hard negatives of 40-200 words
    with 3-word titles, up to ~L = 256 tokens with the title."""
    def ctx():
        return {"title": " ".join(rng.choice(words, size=3)),
                "text": " ".join(rng.choice(words, size=int(rng.integers(40, 200)))),
                "score": 1.0, "relevance": 1.0}

    with open(path, "w") as f:
        for _ in range(n_rows):
            f.write(json.dumps({
                "question": " ".join(rng.choice(words, size=12)),
                "positive_ctxs": [ctx()],
                "hard_negative_ctxs": [ctx() for _ in range(int(rng.integers(1, 3)))],
            }) + "\n")


def phase_train(work, dev, batch_size=TRAIN_BATCH, steps=TRAIN_STEPS, extra=()):
    """Phase 6, the training slice on ``dev``; ``batch_size``/``steps``/
    ``extra`` config overrides only shrink it for a rehearsal on the CPU.
    Returns the kernels' launch counts and the overrides of its data."""
    import numpy as np
    import torch

    from dpr_scale_tpu_torch.cli import train
    from dpr_scale_tpu_torch.cli.common import build_model_config
    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.ops import attention, ffn

    rng = np.random.default_rng(SEED + 4)
    words = np.array([f"w{i}" for i in range(30522 - 5)])
    tok_dir = os.path.join(work, "tok")
    write_tokenizer(tok_dir, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words.tolist())
    train_path, val_path = os.path.join(work, "train.jsonl"), os.path.join(work, "val.jsonl")
    write_dpr_jsonl(train_path, rng, words, batch_size * steps)
    write_dpr_jsonl(val_path, rng, words, batch_size)
    data = [f"task.transform.model_path={tok_dir}", f"datamodule.train_path={train_path}",
            f"datamodule.val_path={val_path}", *extra]
    log = os.path.join(work, "metrics.jsonl")
    cfg_path = os.path.join(ROOT, "conf", "nq.yaml")
    overrides = [*data, f"datamodule.test_path={val_path}", "datamodule.num_test_negative=10",
                 f"trainer.max_steps={steps}", f"datamodule.batch_size={batch_size}",
                 "trainer.log_every=1", f"trainer.metrics_jsonl={log}"]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    attention.attention_fwd_kernel.dropout_launches = 0
    attention.attention_bwd_kernel.launches = 0
    ffn.ffn_fwd_kernel.launches = ffn.ffn_ln_fwd_kernel.launches = 0
    t0 = time.perf_counter()
    test = train.main(["--config", cfg_path, "--device", str(dev), *overrides])
    wall = time.perf_counter() - t0
    launches = {"attention_fwd_dropout": attention.attention_fwd_kernel.dropout_launches,
                "attention_bwd": attention.attention_bwd_kernel.launches}
    if build_model_config(load_config(cfg_path, overrides)).fused_ffn:
        # fused_ffn in the training steps, fused_ffn_ln in validation and test
        launches.update(ffn_fwd=ffn.ffn_fwd_kernel.launches,
                        ffn_ln_fwd=ffn.ffn_ln_fwd_kernel.launches)

    with open(log) as f:
        lines = [json.loads(l) for l in f]
    steps_logged = [l for l in lines if "train_loss" in l]
    valid = [l for l in lines if "valid_mrr" in l]
    numbers = [l[k] for l in steps_logged for k in ("train_loss", "grad_norm")]
    if len(steps_logged) != steps or not np.isfinite(numbers).all():
        raise AssertionError(f"training steps: {steps_logged}")
    if not valid or not test or not np.isfinite(list(test.values())).all():
        raise AssertionError(f"validation {valid} / test {test} metrics missing or not finite")
    step_ms = [batch_size / l["queries_per_s"] * 1e3 for l in steps_logged[1:]]
    med = statistics.median(step_ms)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    print(f"train: {steps} steps of {batch_size} queries + {2 * batch_size} contexts at L=256 "
          f"in {wall:.2f} s wall (CLI incl. model init, data, validation, test); median step "
          f"{med:.2f} ms (steps 2..{steps}) = {batch_size * 1e3 / med:.1f} queries/s; "
          f"losses {[round(l['train_loss'], 4) for l in steps_logged]}; grad_norms "
          f"{[round(l['grad_norm'], 4) for l in steps_logged]}; valid mrr {valid[-1]['valid_mrr']:.4f}; "
          f"peak device memory {peak:.2f} GiB")
    print(f"training-path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the training path never launched: {launches}")
    return launches, {"step_ms": med, "queries_per_s": batch_size * 1e3 / med,
                      "peak_gib": peak}, data


def phase_train_grads(dev, data, seeds=GRAD_SEEDS, extra=()):
    """Phase 7 (and with ``extra`` the fused-FFN configuration's, phase 10):
    the loss and gradients of one batch of 16 queries and 32 contexts,
    dropout 0, at each of ``seeds`` weight seeds (each with its own batch),
    through four paths from the same weights, each a training forward (a
    DropoutRng, so the composition the training steps run):

    * "kernel bf16": the model as phase 6 (or 10) trains it, through the
      kernels;
    * "fused plain bf16": the same model with the wrappers' plain versions
      on the card, which round where the kernels round;
    * "unfused bf16": the einsum attention and FFN path;
    * "plain fp32": that path in fp32, TF32 off, on the weights rounded to
      bf16: the values the bf16 paths compute with (they cast every matrix,
      bias and embedding row to bf16 at each call), so that its gap to them
      is the rounding of activations alone, not a common shift of all bf16
      paths by the weights' rounding.

    The kernel path is held to LOSS_REL / GRAD_COS against "fused plain
    bf16" and "plain fp32"; the paths without kernels against "plain fp32"
    are printed as the spread bf16 itself gives.

    The weights are the seeded init with every matrix scaled from std 0.02
    to 0.05 (GRAD_WEIGHT_STD). At the 0.02 init the scores of a query's
    contexts lie close together (loss 4.3 against log 32 = 3.5 on an H100),
    so the gradient is a small difference between near-equal embeddings
    that bf16 resolves only to a cosine of ~0.98 there; trained weights
    separate passages, as the wider init does."""
    import itertools
    from contextlib import ExitStack, nullcontext
    from unittest import mock

    import torch

    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.cli.common import build_datamodule, build_task, build_tokenizer
    from dpr_scale_tpu_torch.models.convert import init_params
    from dpr_scale_tpu_torch.models.transformer import DropoutRng
    from dpr_scale_tpu_torch.ops import attention, ffn
    from dpr_scale_tpu_torch.optim.factory import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    common = [*data, *extra, "datamodule.batch_size=16", "task.model.hidden_dropout=0",
              "task.model.attention_dropout=0"]
    unfused = ["task.model.fused_attention=false", "task.model.fused_ffn=false"]
    cfg_path = os.path.join(ROOT, "conf", "nq.yaml")
    cfgs = {"kernel bf16": load_config(cfg_path, common),
            "unfused bf16": load_config(cfg_path, common + unfused),
            "plain fp32": load_config(cfg_path, common + unfused + ["task.model.dtype=float32"])}
    dm = build_datamodule(cfgs["kernel bf16"], build_tokenizer(cfgs["kernel bf16"]))
    batches = list(itertools.islice(dm.train_batches(0), seeds))
    dm.close()
    if len(batches) < seeds:
        raise AssertionError(f"{len(batches)} training batches of 16 for {seeds} seeds")
    tasks = {n: build_task(c, make_optimizer(), dev) for n, c in cfgs.items()}
    states = {n: t.init_state(SEED) for n, t in tasks.items()}

    def plain_on_card():
        """The wrappers' plain versions on CUDA tensors, for this run only."""
        stack = ExitStack()
        for mod in (attention, ffn):
            stack.enter_context(mock.patch.object(mod, "_dispatch", lambda t, kernel, plain: plain))
        return stack

    paths = {"kernel bf16": ("kernel bf16", nullcontext),
             "fused plain bf16": ("kernel bf16", plain_on_card),
             "unfused bf16": ("unfused bf16", nullcontext),
             "plain fp32": ("plain fp32", nullcontext)}
    pairs = [("kernel bf16", "fused plain bf16"), ("kernel bf16", "plain fp32"),
             ("fused plain bf16", "plain fp32"), ("unfused bf16", "plain fp32")]
    readings = {p: [] for p in pairs}
    names = [n for n, _ in states["kernel bf16"].model.named_parameters()]
    for i, batch in enumerate(batches):
        drawn = init_params(states["kernel bf16"].model, torch.Generator().manual_seed(SEED + i))
        weights = {k: v * (GRAD_WEIGHT_STD / 0.02) if v.ndim == 2 else v
                   for k, v in drawn.items()}
        loss, grads = {}, {}
        for path, (task_name, ctx) in paths.items():
            task, state = tasks[task_name], states[task_name]
            state.model.load_state_dict(
                {k: v.bfloat16().float() for k, v in weights.items()}
                if path == "plain fp32" else weights)
            with ctx():
                l, g = task.loss_and_grads(state, task.to_device(batch), DropoutRng(SEED, i, dev))
            loss[path], grads[path] = l.item(), [t.float() for t in g]
        line = []
        for a, b in pairs:
            cos = [torch.nn.functional.cosine_similarity(x.flatten(), y.flatten(), dim=0).item()
                   for x, y in zip(grads[a], grads[b])]
            j = min(range(len(cos)), key=cos.__getitem__)
            rel = abs(loss[a] - loss[b]) / abs(loss[b])
            readings[(a, b)].append((rel, cos[j]))
            line.append(f"{a} vs {b}: loss relative {rel:.3g}, min cosine {cos[j]:.6f} "
                        f"({names[j]}), median {statistics.median(cos):.6f}")
        print(f"gradients, seed {SEED + i}, 16 queries + 32 contexts at "
              f"L={batch['contexts_ids'].shape[1]}, losses "
              + ", ".join(f"{p} {v:.6f}" for p, v in loss.items()) + "; " + "; ".join(line))
    for (a, b), r in readings.items():
        print(f"over {len(r)} seeds, {a} vs {b}: loss relative max {max(x for x, _ in r):.3g}, "
              f"min gradient cosine {min(c for _, c in r):.6f}")
    for a, b in pairs[:2]:
        if any(x > LOSS_REL or c < GRAD_COS for x, c in readings[(a, b)]):
            raise AssertionError(f"{a} disagrees with {b} beyond relative {LOSS_REL} on "
                                 f"the loss or cosine {GRAD_COS}")


def _ffn_inputs(dev, N, seed, H=FFN_H, F=FFN_F):
    """bf16 activations and bf16-cast weights at the init's scale (std 0.02
    matrices, small biases) and LayerNorm parameters near (1, 0)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape, s: torch.randn(*shape, generator=g, device=dev) * s  # noqa: E731
    x = rn(N, H, s=1.0).bfloat16()
    w = [rn(H, F, s=0.02), rn(F, s=0.02), rn(F, H, s=0.02), rn(H, s=0.02)]
    lnp = [rn(H, s=0.1) + 1.0, rn(H, s=0.1), rn(H, s=0.1) + 1.0, rn(H, s=0.1)]
    return x, [t.bfloat16() for t in w], lnp


def _rel_err(name, got, want, what):
    """max |err| of ``got`` over max |ref|; raises beyond FFN_REL."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not torch.isfinite(got.float()).all() or err > FFN_REL * scale:
        raise AssertionError(f"{what}: {name} max_abs_err {err} of max |ref| {scale}")
    return err


def _unfused_ffn(x, w1, b1, w2, b2, rate):
    """The unfused layer's FFN (cuBLAS GEMMs in bf16, exact GELU, the hidden
    dropout's torch.rand mask), the yardstick beside fused_ffn."""
    import torch

    y = torch.matmul(torch.nn.functional.gelu(torch.matmul(x, w1) + b1), w2) + b2
    if rate == 0.0:
        return y
    keep = torch.rand(y.shape, device=y.device) < 1.0 - rate
    return torch.where(keep, y / (1.0 - rate), torch.zeros((), dtype=y.dtype, device=y.device))


def _unfused_ln(v, g, b, eps=1e-12):
    """The port's LayerNorm (fp32 statistics, bf16 out)."""
    import torch

    vf = v.float()
    mean = vf.mean(dim=-1, keepdim=True)
    var = ((vf * vf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return ((vf - mean) * (torch.rsqrt(var + eps) * g) + b).to(v.dtype)


def phase_ffn_kernels():
    """Phase 8: both FFN kernels against their plain versions at the shapes
    the fused-FFN configuration gives them, a ragged N for each, and their
    times; returns the kernels' entries of the JSON line (times of
    ``fused_ffn`` at N = 65,536, rate 0.1, and of ``fused_ffn_ln`` at N =
    32,768, rate 0)."""
    import torch

    from dpr_scale_tpu_torch.ops import cuda_lib, ffn

    dev = torch.device("cuda", 0)
    seed, errs = 1234, {"ffn_fwd": 0.0, "ffn_ln_fwd": 0.0}
    for N, rates in ((2 * TRAIN_BATCH * 256, (0.0, 0.1)), (TRAIN_BATCH * 256, (0.0, 0.1)),
                     (1000, (0.0, 0.1))):
        x, w, _ = _ffn_inputs(dev, N, SEED + 5)
        for rate in rates:
            y, pre = ffn.ffn_fwd_kernel(x, *w, seed, rate)
            torch.cuda.synchronize()
            ref_y, ref_pre = ffn.ffn_fwd_plain(x, *w, seed, rate)
            what = f"fused_ffn N={N} rate {rate}"
            e = [_rel_err("y", y, ref_y, what), _rel_err("pre", pre, ref_pre, what)]
            same_keep = torch.equal(y != 0, ref_y != 0)
            print(f"{what} (H={FFN_H} F={FFN_F} bf16): y max_abs_err {e[0]:.3g} of max |ref| "
                  f"{ref_y.float().abs().max().item():.3g}, pre {e[1]:.3g}; dropped "
                  f"{(y == 0).float().mean().item():.5f}, same kept entries {same_keep}")
            if not same_keep:
                raise AssertionError(f"{what}: the kernel keeps other entries than plain")
            errs["ffn_fwd"] = max(errs["ffn_fwd"], *e)
            del y, pre, ref_y, ref_pre
        torch.cuda.empty_cache()
    for N in (TRAIN_BATCH * 256, 1000):
        x, w, lnp = _ffn_inputs(dev, N, SEED + 6)
        got = ffn.ffn_ln_fwd_kernel(x, *w, *lnp, seed, 0.0)
        torch.cuda.synchronize()
        want = ffn.ffn_ln_fwd_plain(x, *w, *lnp, seed, 0.0)
        what = f"fused_ffn_ln N={N} rate 0"
        e = [_rel_err(n, a, b, what) for n, a, b in zip(("out", "x1", "pre", "z"), got, want)]
        print(f"{what} (H={FFN_H} F={FFN_F} bf16): max_abs_err out {e[0]:.3g}, x1 {e[1]:.3g}, "
              f"pre {e[2]:.3g}, z {e[3]:.3g}")
        errs["ffn_ln_fwd"] = max(errs["ffn_ln_fwd"], *e)
        del got, want
    torch.cuda.empty_cache()

    print("\n".join(kernel_resources("ffn_gemm_kernel") + kernel_resources("ln_rows_kernel")))
    lib = cuda_lib.library()
    print(f"ffn_gemm_kernel shared memory a block: GEMM1 (F={FFN_F} wide) "
          f"{lib.dst_ffn_gemm_smem(FFN_F)} bytes, GEMM2 (H={FFN_H}) {lib.dst_ffn_gemm_smem(FFN_H)}")
    print(sass_check("ffn_gemm_kernel", "FFN GEMM"))
    out = {}
    N = 2 * TRAIN_BATCH * 256
    x, w, lnp = _ffn_inputs(dev, N, SEED + 7)
    for n_rows, rate in ((N, 0.1), (N // 2, 0.1), (N // 2, 0.0)):
        xs = x[:n_rows]
        fn = lambda: ffn.ffn_fwd_kernel(xs, *w, seed, rate)  # noqa: E731
        ms, single_ms = device_ms(fn), cuda_ms(fn)
        plain_ms = cuda_ms(lambda: ffn.ffn_fwd_plain(xs, *w, seed, rate))
        unfused_ms = cuda_ms(lambda: _unfused_ffn(xs, *w, rate))
        pair_ms = device_ms(_cublas_pair(xs, w))
        split = _ffn_split(xs, w, lnp, seed, rate)
        b = bound(nbytes(xs, *w) + nbytes(xs) + n_rows * FFN_F * 2, 4 * n_rows * FFN_H * FFN_F)
        gemm_bound = 2 * n_rows * FFN_H * FFN_F / BF16_FLOPS * 1e3  # either GEMM's operations
        print(f"fused_ffn N={n_rows} rate {rate}: kernel {ms:.4f} ms queued ({single_ms:.4f} ms "
              f"single call; GEMM1 {split['gemm1']:.4f}, GEMM2 {split['gemm2']:.4f} ms alone), "
              f"plain {plain_ms:.4f} ms, unfused FFN (cuBLAS + elementwise) {unfused_ms:.4f} ms, "
              f"the two bare cuBLAS products {pair_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) = "
              f"{b[0] / ms:.1%} of the kernel's time; GEMM1 / GEMM2 at "
              f"{gemm_bound / split['gemm1']:.1%} / {gemm_bound / split['gemm2']:.1%} of their "
              f"{gemm_bound:.4f} ms bound")
        if (n_rows, rate) == (N, 0.1):
            out["ffn_fwd"] = {"max_abs_err": errs["ffn_fwd"], "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
                              "cublas_pair_ms": pair_ms}
    xs = x[: N // 2]
    fn = lambda: ffn.ffn_ln_fwd_kernel(xs, *w, *lnp, seed, 0.0)  # noqa: E731
    ms, single_ms = device_ms(fn), cuda_ms(fn)
    plain_ms = cuda_ms(lambda: ffn.ffn_ln_fwd_plain(xs, *w, *lnp, seed, 0.0))

    def unfused_half():
        x1 = _unfused_ln(xs, *lnp[:2])
        return _unfused_ln(x1 + _unfused_ffn(x1, *w, 0.0), *lnp[2:])

    unfused_ms = cuda_ms(unfused_half)
    pair_ms = device_ms(_cublas_pair(xs, w))
    split = _ffn_split(xs, w, lnp, seed, 0.0)
    # the function's inputs and its outputs (out, and x1, pre, z kept for
    # its backward)
    b = bound(nbytes(xs, *w, *lnp) + 3 * nbytes(xs) + (N // 2) * FFN_F * 2,
              4 * (N // 2) * FFN_H * FFN_F)
    print(f"fused_ffn_ln N={N // 2} rate 0: kernel {ms:.4f} ms queued ({single_ms:.4f} ms single "
          f"call; LN1 {split['ln1']:.4f}, GEMM1 {split['gemm1']:.4f}, GEMM2 {split['gemm2']:.4f}, "
          f"LN2 {split['ln2']:.4f} ms alone), plain {plain_ms:.4f} ms, unfused half-layer "
          f"(LayerNorms, cuBLAS GEMMs, elementwise) {unfused_ms:.4f} ms, the two bare cuBLAS "
          f"products {pair_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) = {b[0] / ms:.1%} of the "
          f"kernel's time; no single PyTorch call computes either function")
    out["ffn_ln_fwd"] = {"max_abs_err": errs["ffn_ln_fwd"], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
                         "cublas_pair_ms": pair_ms}
    return out


def _cublas_pair(x, w):
    """The yardstick beside the FFN kernels: the two bare cuBLAS products at
    the same shapes (x . w1, then an (N, F) operand . w2; bf16 out, no
    epilogue)."""
    import torch

    h = torch.mm(x, w[0])
    return lambda: (torch.mm(x, w[0]), torch.mm(h, w[2]))


def _ffn_split(x, w, lnp, seed, rate, eps=1e-12):
    """Queued device ms of each launch of the FFN entry points alone
    (``dst_ffn_gemm`` and ``dst_ffn_ln_rows``): LN1, GEMM1 (bias + GELU),
    GEMM2 (bias, dropout at ``rate``), LN2 (with the residual)."""
    import torch

    from dpr_scale_tpu_torch.ops import cuda_lib
    from dpr_scale_tpu_torch.ops.attention import _dropout_args

    lib = cuda_lib.library()
    N = x.shape[0]
    pre, h = (torch.empty(N, FFN_F, dtype=x.dtype, device=x.device) for _ in range(2))
    y, out = torch.empty_like(x), torch.empty_like(x)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    s, thr, inv_keep = _dropout_args(seed, rate)

    def gemm(a, b, bias, out0, out1, n_cols, k, epi, *drop):
        def run():
            cuda_lib.check(lib.dst_ffn_gemm(
                a.data_ptr(), b.data_ptr(), bias.data_ptr(), out0.data_ptr(),
                out1.data_ptr() if out1 is not None else None, N, n_cols, k, epi,
                *(drop or (0, 0, 1.0)), stream()), "dst_ffn_gemm")
        return run

    def ln(a, b, g, beta):
        def run():
            cuda_lib.check(lib.dst_ffn_ln_rows(
                a.data_ptr(), b.data_ptr() if b is not None else None, g.data_ptr(),
                beta.data_ptr(), out.data_ptr(), N, FFN_H, eps, stream()), "dst_ffn_ln_rows")
        return run

    gemm2 = (gemm(h, w[2], w[3], y, None, FFN_H, FFN_F, 2, s, thr, inv_keep) if rate
             else gemm(h, w[2], w[3], y, None, FFN_H, FFN_F, 1))
    return {"ln1": device_ms(ln(x, None, *lnp[:2])),
            "gemm1": device_ms(gemm(x, w[0], w[1], pre, h, FFN_F, FFN_H, 0)),
            "gemm2": device_ms(gemm2), "ln2": device_ms(ln(x, y, *lnp[2:]))}


def sass_check(prefix, label, ops=None):
    """Whether ``cuobjdump --dump-sass`` of the kernel library shows HGMMA
    (wgmma; IGMMA for its integer form) and UTMALDG (TMA loads), or the
    instructions ``ops`` (name prefixes) where given, in each instance of
    the kernel named ``prefix``, where the toolkit has cuobjdump; one
    line."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return f"cuobjdump not found beside nvcc: {label} SASS not checked"
    sass = subprocess.run([tool, "--dump-sass", cuda_lib.build()], capture_output=True,
                          text=True, timeout=600).stdout
    found = []
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        t = re.search(r"(?<![A-Za-z_])" + prefix + r"I((?:" + TEMPLATE_ARG + r")+)E", name)
        if t:
            args = ", ".join(template_args(t.group(1)))
            if ops:
                counts = ", ".join(f"{op} {fn.count(op)}" for op in ops)
            else:
                igmma = f"IGMMA {fn.count('IGMMA')}, " if "IGMMA" in fn else ""  # s8 wgmma
                counts = f"HGMMA {fn.count('HGMMA')}, {igmma}UTMALDG {fn.count('UTMALDG')}"
            found.append(f"{prefix}<{args}>: {counts}")
    return f"{label} SASS (instruction counts): " + ("; ".join(found) or f"no {prefix} found")


def _gather_bound(vecs, slots, q):
    """(bound_ms, bound_by) of one gather-score call: each distinct posting
    block read once, q and the slots read once, the (E, L) fp32 scores
    written once; E * L * D fp32 multiply-adds on the CUDA cores."""
    import torch

    n_exp, L, D = vecs.shape
    live = slots[(slots >= 0) & (slots < n_exp)]
    blocks = int(torch.unique(live).numel())
    E, size = slots.shape[0], vecs.element_size()
    return (blocks * L * D * size + E * L * 4 + E * D * size + E * 4, 2 * E * L * D)


def _gather_inputs(dev, n_exp, L, D, E, dtype, case, seed):
    """One bucket's postings (std 0.3), slot-sorted slots and queries:
    entries spread over the experts, all on one expert, or every third
    entry on the pad slot n_exp."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    vecs = (torch.randn(n_exp, L, D, generator=g, device=dev) * 0.3).to(dtype)
    q = torch.randn(E, D, generator=g, device=dev)
    if case == "one_slot":
        slots = torch.full((E,), n_exp // 2, dtype=torch.int32, device=dev)
    else:
        slots = torch.randint(0, n_exp, (E,), generator=g, device=dev, dtype=torch.int32)
        if case == "pad":
            slots[::3] = n_exp
    return vecs, torch.sort(slots).values, q


def _yardstick(vecs, slots, q):
    """The gather + batched product a user would write: cuBLAS bmm in the
    postings' dtype (bf16 products, fp32 accumulation, bf16 result)."""
    import torch

    idx = slots.long().clamp(0, vecs.shape[0] - 1)
    return torch.bmm(vecs[idx], q.to(vecs.dtype)[:, :, None])


def _gather_kernels():
    from dpr_scale_tpu_torch.ops import gather_score as gs

    return {
        "gather_score_serial": lambda v, s, q, p=None: gs.gather_score_serial_kernel(v, s, q),
        "gather_score_pipelined": lambda v, s, q, p=None: gs.gather_score_pipelined_kernel(v, s, q),
        "gather_score_streamed": lambda v, s, q, p=None: gs.gather_score_streamed_kernel(v, q, s, p),
    }


def phase_gather_kernels():
    """Phase 11: each gather-score kernel against the plain version at
    every bucket size the index uses, D = 32 (conf/citadel.yaml) and 128
    (tools/bench_citadel_device.py's default), bf16, plus fp32 once; three
    routings each, E ragged; the pipelined kernel's scores the serial
    kernel's bits, every launch on its bulk-copy route; repeatability; times
    of the spread routing (queued); the bulk-copy kernel's registers,
    shared memory and bulk-copy / mbarrier instructions. Returns each
    kernel's max |err|."""
    import torch

    from dpr_scale_tpu_torch.ops import cuda_lib
    from dpr_scale_tpu_torch.ops import gather_score as gs

    dev = torch.device("cuda", 0)
    kernels = _gather_kernels()
    errs = dict.fromkeys(kernels, 0.0)
    routes = dict(gs.gather_score_pipelined_kernel.launches_by_route)
    shapes = [(D, L, torch.bfloat16) for D in (32, 128) for L in GATHER_BUCKETS]
    shapes.append((32, 2048, torch.float32))
    for i, (D, L, dtype) in enumerate(shapes):
        n_exp, E = max(8, GATHER_SCORES // L), GATHER_SCORES // L - 3
        for case in ("spread", "one_slot", "pad"):
            vecs, slots, q = _gather_inputs(dev, n_exp, L, D, E, dtype, case, SEED + 9 + i)
            want = gs.gather_score_plain(vecs, slots, q)
            scale = want.abs().max().item()
            line, got = [], {}
            for name, fn in kernels.items():
                got[name] = fn(vecs, slots, q)
                torch.cuda.synchronize()
                err = (got[name] - want).abs().max().item()
                line.append(f"{name[13:]} {err:.3g}")
                if not torch.isfinite(got[name]).all() or err > GATHER_REL * scale:
                    raise AssertionError(f"{name} (L={L} D={D} {dtype} {case}): max_abs_err "
                                         f"{err} of max |ref| {scale}")
                errs[name] = max(errs[name], err)
            if not torch.equal(got["gather_score_pipelined"], got["gather_score_serial"]):
                raise AssertionError(f"pipelined (L={L} D={D} {dtype} {case}): not the serial "
                                     "kernel's bits")
            del got
            times = ""
            if case == "spread":
                pieces = torch.from_numpy(gs.stream_pieces(slots.cpu().numpy())).to(dev)
                ms = {n: device_ms(lambda: fn(vecs, slots, q, pieces)) for n, fn in kernels.items()}
                plain_ms = device_ms(lambda: gs.gather_score_plain(vecs, slots, q), calls=5)
                yard_ms = device_ms(lambda: _yardstick(vecs, slots, q))
                b = bound(*_gather_bound(vecs, slots, q), FP32_FLOPS)
                times = ("; " + ", ".join(f"{n[13:]} {t:.4f} ms" for n, t in ms.items())
                         + f", plain {plain_ms:.4f} ms, gather+bmm {yard_ms:.4f} ms, bound "
                         f"{b[0]:.4f} ms ({b[1]}) = {b[0] / ms['gather_score_serial']:.1%} of serial")
            print(f"gather L={L} D={D} {str(dtype)[6:]} n_exp={n_exp} E={E} {case}: max_abs_err "
                  + ", ".join(line) + f" of max |ref| {scale:.3g}; pipelined == serial bits"
                  + times)
            del vecs, slots, q, want
        torch.cuda.empty_cache()
    # repeatability: inputs made again from the same seed, the same bits
    for name, fn in kernels.items():
        a = fn(*_gather_inputs(dev, 64, 512, 32, 301, torch.bfloat16, "spread", 5))
        b = fn(*_gather_inputs(dev, 64, 512, 32, 301, torch.bfloat16, "spread", 5))
        c = fn(*_gather_inputs(dev, 64, 512, 32, 301, torch.bfloat16, "spread", 6))
        torch.cuda.synchronize()
        if not torch.equal(a, b) or torch.equal(a, c):
            raise AssertionError(f"{name}: a repeated seed gives other scores, or another the same")
    print("gather kernels: repeated inputs give the same bits")
    routes = {r: n - routes[r] for r, n in gs.gather_score_pipelined_kernel.launches_by_route.items()}
    print(f"gather_score_pipelined launches by route over the phase: {routes}")
    if routes["element_copy"]:  # every row here is a multiple of 16 bytes
        raise AssertionError("the pipelined kernel left its bulk-copy route")
    tile = gs.pipelined_tiling("bulk_copy", 64, 1 << 20, 1)[0]
    print("\n".join(kernel_resources("gather_bulk_kernel") + [
        f"gather_bulk_kernel dynamic shared memory a block (D=32 bf16, {tile}-row stages): "
        f"{cuda_lib.library().dst_gather_pipelined_smem(tile, 32, 0)}",
        sass_check("gather_bulk_kernel", "gather bulk", ops=("UBLKCP", "SYNCS"))]))
    return errs


def _same_runs(want, got, tol):
    """Queries whose ranked (doc, score) lists disagree beyond ``tol`` (a
    number or a function of the wanted list), compared as {doc: score}
    maps: the ranked scores and each shared doc's score within tol, a doc
    in only one list within tol of the lists' last score (near-tie swaps)."""
    import numpy as np

    bad = 0
    for w, g in zip(want, got):
        t = tol(w) if callable(tol) else tol
        if len(w) != len(g):
            bad += 1
            continue
        if not w:
            continue
        ws, gs_ = np.array([s for _d, s in w]), np.array([s for _d, s in g])
        wm, gm = dict(w), dict(g)
        floor = min(w[-1][1], g[-1][1]) + t
        ok = (np.all(np.isfinite(gs_)) and np.all(np.abs(ws - gs_) <= t)
              and all(abs(wm[d] - gm[d]) <= t for d in wm.keys() & gm.keys())
              and all(wm.get(d, gm.get(d)) <= floor for d in wm.keys() ^ gm.keys()))
        bad += not ok
    return bad


def _rel_tol(rel):
    return lambda w: rel * max((abs(s) for _d, s in w), default=0.0)


def phase_citadel_cli(work, dev, n_passages=CITADEL_PASSAGES, n_queries=CITADEL_QUERIES,
                      extra=()):
    """Phase 12, the CITADEL CLI slice on ``dev``; ``n_passages``/
    ``n_queries``/``extra`` config overrides only shrink it for a rehearsal
    on the CPU. Returns the kernels' launch counts."""
    import numpy as np

    from dpr_scale_tpu_torch.cli import citadel_retrieval, generate_multivec_embeddings
    from dpr_scale_tpu_torch.index import inverted_device
    from dpr_scale_tpu_torch.index.inverted import InvertedExpertIndex
    from dpr_scale_tpu_torch.ops import gather_score as gs

    rng = np.random.default_rng(SEED + 8)
    words = np.array([f"w{i}" for i in range(30522 - 5)])  # rng.choice copies a list per call
    tok_dir = os.path.join(work, "tok")
    write_tokenizer(tok_dir, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words.tolist())
    tsv, queries, embs = (os.path.join(work, n) for n in ("passages.tsv", "queries.tsv", "index"))
    with open(tsv, "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(n_passages):
            text = " ".join(rng.choice(words, size=int(rng.integers(40, 120))))
            f.write(f"p{i}\t{text}\t{' '.join(rng.choice(words, size=3))}\n")
    with open(queries, "w") as f:
        f.writelines(f"q{i}\t{' '.join(rng.choice(words, size=12))}\n" for i in range(n_queries))
    cfg_path = os.path.join(ROOT, "conf", "citadel.yaml")
    base = ["--config", cfg_path, "--device", str(dev), f"task.transform.model_path={tok_dir}",
            f"datamodule.passages_path={tsv}", f"datamodule.test_path={queries}",
            "datamodule.trec_format=true", f"task.ctx_embeddings_dir={embs}", *extra]

    kernels = (gs.gather_score_serial_kernel, gs.gather_score_streamed_kernel,
               gs.gather_score_pipelined_kernel)
    for k in kernels:
        k.launches = 0
    bulk = gs.gather_score_pipelined_kernel.launches_by_route["bulk_copy"]
    t0 = time.perf_counter()
    stats = generate_multivec_embeddings.main(base + ["task.shard=0", "task.num_shards=1",
                                                      "datamodule.encode_batch_size=64"])
    gen_s = time.perf_counter() - t0
    lengths = np.array([len(p.doc_ids) for p in InvertedExpertIndex.load(
        embs, num_docs=n_passages).experts.values()])
    buckets = np.searchsorted(inverted_device.BUCKET_SIZES, lengths)
    print(f"generate_multivec_embeddings: {n_passages} passages in {gen_s:.2f} s wall "
          f"(CLI incl. model init, tokenization, index build, shard write); {stats}; experts "
          "per bucket " + str({inverted_device.BUCKET_SIZES[min(b, 5)]: int(c) for b, c in
                               zip(*np.unique(buckets, return_counts=True))})
          + f"; longest list {lengths.max()}")
    if lengths.max() > inverted_device.BUCKET_SIZES[-1]:
        raise AssertionError("an expert list exceeds the largest bucket: the device index "
                             "would truncate it")

    def run(tag, more):
        t0 = time.perf_counter()
        res = citadel_retrieval.main(base + more)
        wall = time.perf_counter() - t0
        print(f"citadel_retrieval {tag}: {len(res)} queries in {wall:.2f} s wall (CLI incl. "
              "model init, index load and build)")
        return [[(c["id"], c["score"]) for c in ctxs] for ctxs in res]

    host = run("host index", [])
    bf16 = run("device index bf16", ["task.device_index=true"])
    fp32 = run("device index fp32", ["task.device_index=true", "task.device_index_dtype=float32"])
    inverted_device.STREAM_MODE = "on"
    try:
        streamed = run("device index fp32, STREAM_MODE on",
                       ["task.device_index=true", "task.device_index_dtype=float32"])
    finally:
        inverted_device.STREAM_MODE = "auto"
    os.environ["DPR_GATHER_KERNEL"] = "pipelined"
    try:
        pipelined = run("device index bf16, DPR_GATHER_KERNEL=pipelined",
                        ["task.device_index=true"])
    finally:
        del os.environ["DPR_GATHER_KERNEL"]
    launches = {"gather_score_serial": kernels[0].launches,
                "gather_score_streamed": kernels[1].launches,
                "gather_score_pipelined": kernels[2].launches}

    if len(host) != n_queries or any(len(r) != min(100, n_passages) for r in host):
        raise AssertionError(f"host run: {len(host)} queries, lengths {set(map(len, host))}")
    checks = [("fp32 device vs host", fp32, host, CITADEL_TOL),
              ("fp32 device streamed vs host", streamed, host, CITADEL_TOL),
              ("bf16 device vs host", bf16, host, _rel_tol(CITADEL_BF16_REL)),
              ("bf16 pipelined vs bf16 serial", pipelined, bf16, _rel_tol(CITADEL_SAME_REL))]
    worst = max(abs(s) for r in host for _d, s in r)
    for what, got, want, tol in checks:
        bad = _same_runs(want, got, tol)
        diff = max(max(abs(a - b) for (_x, a), (_y, b) in zip(w, g)) for w, g in zip(want, got))
        print(f"{what}: {bad} of {len(want)} queries disagree; ranked scores differ by at most "
              f"{diff:.3g} (scores up to {worst:.3g})")
        if bad:
            raise AssertionError(f"{what}: {bad} queries disagree")
    print(f"citadel-path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the CITADEL path never launched: {launches}")
    bulk = gs.gather_score_pipelined_kernel.launches_by_route["bulk_copy"] - bulk
    print(f"pipelined launches on the bulk-copy route: {bulk} of {launches['gather_score_pipelined']}")
    if bulk != launches["gather_score_pipelined"]:
        raise AssertionError("a pipelined launch of the CITADEL path left the bulk-copy route")
    return launches


def _synth_bucket(rng, n_exp, bsize, n_docs, fill=0.7):
    """tools/bench_citadel_device.py::synth_bucket's doc layout: per
    expert, sorted random doc ids on the first 70% of the rows (-1 after,
    the pad rows, which join the last run), with its run ids and the
    run-compact (run_doc, start_pos) layout."""
    import numpy as np

    from dpr_scale_tpu_torch.index.inverted_device import _pad_2bit

    docs = np.sort(rng.integers(0, n_docs, size=(n_exp, bsize)), axis=1)
    f = int(bsize * fill)
    docs[:, f:] = -1
    starts = np.zeros((n_exp, bsize), bool)
    starts[:, 0] = True
    starts[:, 1:f] = docs[:, 1:f] != docs[:, : f - 1]
    run_id = np.zeros((n_exp, bsize), np.int32)
    run_id[:, :f] = np.cumsum(starts[:, :f], axis=1) - 1
    run_id[:, f:] = run_id[:, f - 1 : f]
    nruns = run_id[:, f - 1].astype(np.int64) + 1
    R_pad = min(_pad_2bit(int(nruns.max()), minimum=8), bsize)
    rows, cols = np.nonzero(starts)  # row-major: each expert's starts in order
    rank = np.arange(len(rows)) - np.repeat(np.cumsum(nruns) - nruns, nruns)
    keep = rank < R_pad
    run_doc = np.full((n_exp, R_pad), -1, np.int64)
    start_pos = np.zeros((n_exp, R_pad), np.int64)
    run_doc[rows[keep], rank[keep]] = docs[rows[keep], cols[keep]]
    start_pos[rows[keep], rank[keep]] = cols[keep]
    flat = (np.arange(n_exp)[:, None] * bsize + run_id)[:, :f]
    max_run_len = int(np.bincount(flat.ravel()).max())
    return docs, run_id, run_doc, start_pos, max_run_len


def _oracle(index, docs_of, query, rows):
    """numpy scores of queries ``rows`` over every doc: per routed entry the
    score of each posting (q rounded to the index dtype, products summed in
    fp64), the max over each doc's postings, the zero floor, summed in fp32;
    plus the CLS dot products (fp32)."""
    import numpy as np
    import torch

    def rounded(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(index.dtype).float().numpy()

    acc = np.zeros((len(rows), index.num_docs), np.float32)
    for i, b in enumerate(rows):
        for t in np.flatnonzero(query["attention_mask"][b] > 0):
            e, w = int(query["expert_ids"][b, t, 0]), float(query["expert_weights"][b, t, 0])
            bsize, slot = int(index._route_bsize[e]), int(index._route_slot[e])
            q = rounded(np.float32(w) * query["expert_repr"][b, t]).astype(np.float64)
            block = index.buckets[bsize]["vecs"][slot].float().cpu().numpy()
            docs = docs_of[bsize][slot]
            live = docs >= 0
            s, d = (block @ q)[live], docs[live]
            first = np.flatnonzero(np.concatenate([[True], d[1:] != d[:-1]]))
            acc[i, d[first]] += np.maximum(np.maximum.reduceat(s, first), 0.0)
    if "cls_repr" in query:
        qc = rounded(query["cls_repr"][rows])
        step = 1 << 20
        for lo in range(0, index.num_docs, step):
            acc[:, lo : lo + step] += qc @ index.cls[lo : lo + step].float().cpu().numpy().T
    return acc


def phase_citadel_search(dev, n_docs=CITADEL_DOCS, plan=CITADEL_PLAN, batch=CITADEL_BATCH,
                         qtokens=CITADEL_QTOKENS, dim=CITADEL_DIM, cls_dim=CITADEL_CLS_DIM,
                         reps=5):
    """Phase 13 on ``dev``; the sizes only shrink for a rehearsal on the
    CPU. Returns the serial kernel's launches, the per-search numbers and
    the buckets' (vecs, slots, q) of one CLS search."""
    from unittest import mock

    import numpy as np
    import torch

    from dpr_scale_tpu_torch.index.inverted_device import DeviceExpertIndex
    from dpr_scale_tpu_torch.ops import gather_score as gs

    rng = np.random.default_rng(SEED + 10)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    t0 = time.perf_counter()
    index = DeviceExpertIndex(n_docs, torch.bfloat16, dev)
    docs_of, first = {}, 0
    for bsize, n_exp in plan:
        docs, run_id, run_doc, start_pos, mrl = _synth_bucket(rng, n_exp, bsize, n_docs)
        vecs = (torch.randn(n_exp, bsize, dim, generator=g, device=dev) * 0.3).to(torch.bfloat16)
        vecs[:, int(bsize * 0.7):] = 0  # pad rows score 0, as from_host_index leaves them
        index.add_bucket(bsize, np.arange(first, first + n_exp), vecs, run_id, run_doc,
                         start_pos, mrl)
        docs_of[bsize], first = docs, first + n_exp
        del vecs
    index.cls = torch.empty(n_docs, cls_dim, dtype=torch.bfloat16, device=dev)
    for lo in range(0, n_docs, 1 << 20):
        rows = min(1 << 20, n_docs - lo)
        index.cls[lo : lo + rows] = torch.randn(rows, cls_dim, generator=g, device=dev) * 0.3
    postings = sum(b * n for b, n in plan)
    nbytes = sum(b["vecs"].numel() * 2 for b in index.buckets.values())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"citadel index built on {dev} in {time.perf_counter() - t0:.2f} s: {first} experts, "
          f"{postings} padded postings, D={dim} bf16 ({nbytes / 1e9:.3f} GB), CLS plane "
          f"({n_docs}, {cls_dim}) bf16 ({index.cls.numel() * 2 / 1e9:.3f} GB), {n_docs} docs; "
          "max run lengths " + str({b: v["max_run_len"] for b, v in index.buckets.items()}))

    qrng = np.random.default_rng(SEED + 11)
    query = {
        "expert_ids": qrng.integers(0, first, size=(batch, qtokens, 1)).astype(np.int64),
        "expert_weights": qrng.random((batch, qtokens, 1)).astype(np.float32),
        "expert_repr": qrng.normal(size=(batch, qtokens, dim)).astype(np.float32),
        "attention_mask": np.ones((batch, qtokens), np.int64),
        "cls_repr": qrng.normal(size=(batch, cls_dim)).astype(np.float32),
    }
    no_cls = {k: v for k, v in query.items() if k != "cls_repr"}
    cuda = dev.type == "cuda"
    gs.gather_score_serial_kernel.launches = gs.gather_score_streamed_kernel.launches = 0
    stats = {}
    for tag, q in (("with CLS", query), ("without CLS", no_cls)):
        index.search(q, 100)  # warm-up
        index.latency.clear()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ms = host_ms(lambda: index.search(q, 100), reps=reps, warmup=0)
        latency = {k: round(v / reps * 1e3, 3) for k, v in index.latency.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
        stats[tag] = {"ms": ms, "queries_per_s": batch * 1e3 / ms, "peak_gib": peak}
        print(f"citadel search {tag} (B={batch}, {qtokens} tokens, query_topk 1, k=100, "
              f"{n_docs} docs): median {ms:.2f} ms host = {batch * 1e3 / ms:.1f} queries/s; "
              f"latency ms per search {latency}; scorers {index.last_plan}; peak device "
              f"memory {peak:.2f} GiB")
    launches = {"gather_score_serial": gs.gather_score_serial_kernel.launches,
                "gather_score_streamed": gs.gather_score_streamed_kernel.launches}

    # one more search of each kind, recording the buckets' scorer inputs,
    # against the plain scorers on the same device and the numpy oracle
    captured = []
    serial, streamed = gs.gather_score_serial, gs.gather_score_streamed

    def record_serial(v, s, qv):
        captured.append((v, s.clone(), qv.clone()))
        return serial(v, s, qv)

    def record_streamed(v, qv, s, pieces=None):
        captured.append((v, s.clone(), qv.clone()))
        return streamed(v, qv, s, pieces)

    oracle_rows = list(range(CITADEL_ORACLE_QUERIES))
    t0 = time.perf_counter()
    for tag, q in (("with CLS", query), ("without CLS", no_cls)):
        if tag == "with CLS":
            with mock.patch.object(gs, "gather_score_serial", record_serial), \
                    mock.patch.object(gs, "gather_score_streamed", record_streamed):
                got = index.search(q, 100)
        else:
            got = index.search(q, 100)
        with mock.patch.object(gs, "_dispatch", lambda t, kernel, plain: plain):
            plain = index.search(q, 100)
        ranked = [[list(zip(d.tolist(), s.tolist())) for s, d in zip(*r)] for r in (got, plain)]
        if not np.isfinite(got[0]).all() or got[0].shape != (batch, 100):
            raise AssertionError(f"citadel search {tag}: {got[0].shape}, not all finite")
        bad_plain = _same_runs(ranked[1], ranked[0], _rel_tol(CITADEL_TOL))
        acc = _oracle(index, docs_of, q, oracle_rows)
        top = np.argpartition(-acc, 99, axis=1)[:, :100]
        top = np.take_along_axis(top, np.argsort(-np.take_along_axis(acc, top, 1), 1), 1)
        want = [list(zip(t.tolist(), acc[i, t].tolist())) for i, t in enumerate(top)]
        bad_oracle = _same_runs(want, ranked[0][: len(oracle_rows)], _rel_tol(CITADEL_TOL))
        diff = np.abs(got[0] - plain[0]).max()
        print(f"citadel search {tag}: kernel path vs plain scorers on {dev}: {bad_plain} of "
              f"{batch} queries disagree (ranked scores differ by at most {diff:.3g}, scores up "
              f"to {np.abs(plain[0]).max():.3g}); vs the numpy oracle: {bad_oracle} of "
              f"{len(oracle_rows)} disagree ({time.perf_counter() - t0:.1f} s into the checks)")
        if bad_plain or bad_oracle:
            raise AssertionError(f"citadel search {tag} disagrees with its plain path or oracle")
    if cuda:
        from dpr_scale_tpu_torch.index.inverted_device import _tiled_topk
        from dpr_scale_tpu_torch.tools.profile_serve import report

        for tag, q in (("with CLS", query), ("without CLS", no_cls)):
            report(f"citadel search {tag}, B={batch}", lambda: index.search(q, 100), dev, None)
        # the dense combine's tiled top-k against torch.topk on a (B, num_docs)
        # accumulator of CLS scores
        acc = index._cls_scores(query["cls_repr"])
        same = torch.equal(_tiled_topk(acc, 100)[0], torch.topk(acc, 100, dim=1).values)
        tiled_ms = cuda_ms(lambda: _tiled_topk(acc, 100))
        topk_ms = cuda_ms(lambda: torch.topk(acc, 100, dim=1))
        print(f"top-100 of the ({batch}, {n_docs}) fp32 accumulator: tiled {tiled_ms:.3f} ms, "
              f"torch.topk {topk_ms:.3f} ms; the same values: {same}")
        del acc
        if not same:
            raise AssertionError("the tiled top-k disagrees with torch.topk")
    print(f"citadel search launches: {launches}")
    if launches["gather_score_serial"] < 1:
        raise AssertionError(f"the serial gather kernel never launched: {launches}")
    return launches, stats, captured


def citadel_kernel_entries(captured):
    """The gather-score kernels' JSON entries on the buckets of one CLS
    search of phase 13 (their sums over the buckets): device time
    (``device_ms``), the plain version's, the bound and the gather + bmm
    yardstick; the streamed kernel takes each bucket's entries sorted by
    slot. The serial kernel's time of one call with its host launch cost
    (``cuda_ms``) is printed beside it."""
    import torch

    from dpr_scale_tpu_torch.ops import gather_score as gs

    kernels = _gather_kernels()
    total = {n: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0} for n in kernels}
    nb = flops = yard = 0.0
    for v, s, q in captured:
        order = torch.argsort(s, stable=True)
        s_sorted, q_sorted = s[order].contiguous(), q[order].contiguous()
        pieces = torch.from_numpy(gs.stream_pieces(s_sorted.cpu().numpy())).to(v.device)
        want = gs.gather_score_plain(v, s, q)
        plain_ms = device_ms(lambda: gs.gather_score_plain(v, s, q), calls=5)
        if not torch.equal(kernels["gather_score_pipelined"](v, s, q),
                           kernels["gather_score_serial"](v, s, q)):
            raise AssertionError(f"bucket L={v.shape[1]}: pipelined gives other bits than serial")
        line = []
        for name, fn in kernels.items():
            if name == "gather_score_streamed":
                args, ref = (v, s_sorted, q_sorted, pieces), want[order]
            else:
                args, ref = (v, s, q), want
            err = (fn(*args) - ref).abs().max().item()
            ms = device_ms(lambda: fn(*args))
            total[name]["ms"] += ms
            total[name]["plain_ms"] += plain_ms
            total[name]["max_abs_err"] = max(total[name]["max_abs_err"], err)
            line.append(f"{name[13:]} {ms:.4f} ms")
        b = _gather_bound(v, s, q)
        nb, flops = nb + b[0], flops + b[1]
        y = device_ms(lambda: _yardstick(v, s, q))
        yard += y
        bb = bound(*b, FP32_FLOPS)
        print(f"bucket L={v.shape[1]} ({v.shape[0]} experts) E={s.shape[0]}: " + ", ".join(line)
              + f", plain {plain_ms:.4f} ms, gather+bmm {y:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]}); "
              "pipelined == serial bits")
    launch = sum(cuda_ms(lambda: gs.gather_score_serial_kernel(v, s, q)) for v, s, q in captured)
    print(f"gather_score_serial, one call per bucket with its host launch cost: {launch:.4f} ms")
    b_ms, b_by = bound(nb, flops, FP32_FLOPS)
    for name, t in total.items():
        t.update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"{name} over the {len(captured)} buckets of one B={CITADEL_BATCH} search: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, gather+bmm yardstick {yard:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}) = {b_ms / t['ms']:.1%} of the kernel's time; no "
              "single PyTorch call computes it")
    return total


def _mips_kernels():
    """name -> (kernel, plain, yardstick); looked up at call time."""
    import torch

    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    def yard_count(q, corpus, tau):
        return sum((s > tau[:, None]).sum(dim=1, dtype=torch.int32) for _lo, s in
                   _yard_scores(q, corpus))

    def yard_groupmax(q, corpus):
        t1 = torch.empty((corpus.shape[0] // 8, q.shape[0]), device=corpus.device)
        for lo, s in _yard_scores(q, corpus):
            t1[lo // 8 : lo // 8 + s.shape[1] // 8] = s.view(q.shape[0], -1, 8).amax(dim=2).T
        return t1, t1.view(-1, 16, q.shape[0]).amax(dim=1)

    def yard_tile_max(q, corpus, tile):
        return torch.cat([s.view(q.shape[0], -1, tile).amax(dim=2)
                          for _lo, s in _yard_scores(q, corpus)], dim=1)

    return {
        "count_above": (mk.count_above_kernel, mk.count_above_plain, yard_count),
        "groupmax": (mk.groupmax_kernel, mk.groupmax_plain, yard_groupmax),
        "tile_max_scores": (mk.tile_max_scores_kernel, mk.tile_max_scores_plain, yard_tile_max),
    }


# (B, N, D, dtype name, tile_max tile, timed): the retrieval CLI's query batch
# and a serving batch over the bench geometry, an fp32 case, a ragged case
MIPS_CASES = (
    (QUERY_BATCH, MIPS_ROWS, MIPS_DIM, "bfloat16", 4096, True),
    (64, MIPS_ROWS, MIPS_DIM, "bfloat16", 4096, True),
    (37, 131072 + 4096, MIPS_DIM, "float32", 4096, False),
    (7, 101 * 128, 100, "bfloat16", 1616, False),
)


def _top_scores(q, corpus, k):
    """(B, k) best scores, descending, of the queries cast to the corpus
    dtype, fp32 sums, chunk by chunk."""
    import torch

    best = None
    for lo in range(0, corpus.shape[0], YARD_CHUNK):
        s = q.to(corpus.dtype).float() @ corpus[lo : lo + YARD_CHUNK].float().T
        t = torch.topk(s, min(k, s.shape[1]), dim=1).values
        best = t if best is None else torch.topk(torch.cat([best, t], 1), k, dim=1).values
    return best


def phase_mips_kernels(dev, cases=MIPS_CASES):
    """Phase 14: count_above, groupmax and tile_max_scores against their
    plain versions on ``dev`` for each case; the timed cases also time
    kernel, plain version and yardstick. Returns each kernel's JSON entry
    from the first timed case (times absent if none ran), max |err| over all
    cases."""
    import torch

    kernels = _mips_kernels()
    entries = {n: {"max_abs_err": 0.0} for n in kernels}
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    for B, N, D, dtype_name, tile, timed in cases:
        dtype = getattr(torch, dtype_name)
        corpus = torch.randn(N, D, generator=g, device=dev).to(dtype)
        q = torch.randn(B, D, generator=g, device=dev)
        k = RETRIEVAL_K
        best = _top_scores(q, corpus, k + 1)
        tau = ((best[:, k - 1] + best[:, k]) / 2).contiguous()
        margin = COUNT_MARGIN_REL * tau.abs()
        clear = (best[:, k - 1] - best[:, k]) > 2 * margin  # no score near tau
        del best
        what = f"B={B} N={N} D={D} {dtype_name}"
        args = {"count_above": (q, corpus, tau), "groupmax": (q, corpus),
                "tile_max_scores": (q, corpus, tile)}
        for name, (kernel, plain, yard) in kernels.items():
            routes = dict(getattr(kernel, "launches_by_route", {}))
            got, again = kernel(*args[name]), kernel(*args[name])
            want = plain(*args[name])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if routes:  # the route each shape takes
                routes = {r: n - routes[r] for r, n in kernel.launches_by_route.items()}
                print(f"{name} ({what}): launches by route {routes}")
                if dtype_name == "bfloat16" and D == MIPS_DIM and routes["wgmma"] != 2:
                    raise AssertionError(f"{name} ({what}) did not run the wgmma kernel")
            got, again, want = (x if isinstance(x, tuple) else (x,) for x in (got, again, want))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} ({what}): repeated calls give other bits")
            if name == "count_above":
                lo_c, hi_c = plain(q, corpus, tau + margin), plain(q, corpus, tau - margin)
                (c,), (p,) = got, want
                err = (c - p).abs().max().item()
                bad = (((c != p) & clear).sum().item() + ((c < lo_c) | (c > hi_c)).sum().item()
                       + (p[clear] != k).sum().item())
                line = (f"{(c != p).sum().item()} of {B} counts differ from plain ({int(clear.sum())} "
                        f"thresholds clear of every score, {int((p[clear] == k).sum())} of those "
                        f"count {k}), {bad} outside the check")
            else:
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                scale = max(b.abs().max().item() for b in want)
                bad = int(err > MAX_REL * scale or any(a.shape != b.shape for a, b in zip(got, want))
                          or not all(torch.isfinite(a).all() for a in got))
                line = f"max_abs_err {err:.3g} of max |ref| {scale:.3g}"
            print(f"{name} ({what}): {line}; repeatable")
            if bad:
                raise AssertionError(f"{name} ({what}) disagrees with its plain version")
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], float(err))
            del got, again, want
            if timed:
                out_bytes = {"count_above": nbytes(tau) + 4 * B,
                             "groupmax": 4 * B * (N // 8 + N // 128),
                             "tile_max_scores": 4 * B * (N // tile)}[name]
                b_ms, b_by = bound(nbytes(q, corpus) + out_bytes, 2 * B * N * D)
                ms = cuda_ms(lambda: kernel(*args[name]))
                plain_ms = cuda_ms(lambda: plain(*args[name]), reps=5, warmup=1)
                yard_ms = cuda_ms(lambda: yard(*args[name]), reps=5, warmup=1)
                timing = {"ms": ms}
                if name in ("groupmax", "count_above", "tile_max_scores"):  # redesigned: queued too
                    timing = {"ms": device_ms(lambda: kernel(*args[name]), calls=10),
                              "single_ms": ms}
                    print(f"{name} ({what}): kernel {timing['ms']:.4f} ms queued, "
                          f"{b_ms / timing['ms']:.1%} of its bound")
                print(f"{name} ({what}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS "
                      f"yardstick {yard_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) = "
                      f"{b_ms / ms:.1%} of the kernel's time; no single PyTorch call computes it")
                if "plain_ms" not in entries[name]:
                    entries[name].update(**timing, plain_ms=plain_ms, bound_ms=b_ms,
                                         bound_by=b_by, library_ms=None)
        del corpus, q, tau
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        for prefix, smem in (("groupmax_wgmma_kernel", "dst_bf16_sweep_smem"),
                             ("count_above_wgmma_kernel", "dst_bf16_sweep_smem"),
                             ("tile_max_wgmma_kernel", "dst_tile_max_smem")):
            print(sweep_build_report(prefix, prefix.replace("_kernel", "").replace("_", " "),
                                     lambda lib: {f"B={B}": getattr(lib, smem)(B)
                                                  for B in (512, 64)}))
    return entries


def sweep_build_report(prefix, label, smem):
    """The registers / spills of each instance of a wgmma sweep kernel as
    ptxas printed them, its blocks' dynamic shared memory (``smem(lib)``:
    {case: bytes}) and the HGMMA / UTMALDG counts of its SASS."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    return "\n".join(kernel_resources(prefix) + [
        f"{prefix} dynamic shared memory a block: {smem(cuda_lib.library())}",
        sass_check(prefix, label)])


def phase_retrieval_cli(work, dev, n_rows=MIPS_ROWS, n_encoded=4096,
                        n_queries=RETRIEVAL_QUERIES, extra=(), bench_iters=4):
    """Phase 15, the retrieval CLI slice on ``dev``; ``n_rows``/
    ``n_encoded``/``n_queries``/``extra`` only shrink it for a rehearsal on
    the CPU. Returns the kernels' launch counts."""
    import numpy as np
    import torch

    from dpr_scale_tpu_torch.cli import generate_embeddings, generate_query_embeddings, run_retrieval
    from dpr_scale_tpu_torch.data.datasets import QueryCSVDataset
    from dpr_scale_tpu_torch.encode.embeddings import load_embedding_shard
    from dpr_scale_tpu_torch.eval.qa_eval import SimpleTokenizer, evaluate_retrieval, has_answers
    from dpr_scale_tpu_torch.index.mips import MipsIndex
    from dpr_scale_tpu_torch.ops import mips_kernels
    from dpr_scale_tpu_torch.retrieve.retrieval import build_index, retrieve

    rng = np.random.default_rng(SEED + 21)
    words = np.array([f"w{i}" for i in range(30522 - 5)])
    tok_dir, tsv, csv, embs = (os.path.join(work, n) for n in
                               ("tok", "passages.tsv", "questions.csv", "embs"))
    write_tokenizer(tok_dir, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words.tolist())
    with open(tsv, "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(n_encoded):
            text = " ".join(rng.choice(words, size=int(rng.integers(40, 200))))
            f.write(f"{i}\t{text}\t{' '.join(rng.choice(words, size=3))}\n")
        f.writelines(f"{i}\tdistractor {i}\tdistractor\n" for i in range(n_encoded, n_rows))
    with open(csv, "w") as f:  # NQ-style: question \t python list of answers
        f.writelines(f"{' '.join(rng.choice(words, size=12))}\t{[str(rng.choice(words))]}\n"
                     for _ in range(n_queries))
    cfg_path = os.path.join(ROOT, "conf", "nq.yaml")
    base = ["--config", cfg_path, "--device", str(dev), f"task.transform.model_path={tok_dir}",
            f"datamodule.passages_path={tsv}", f"datamodule.test_path={csv}",
            f"task.ctx_embeddings_dir={embs}", "datamodule.encode_batch_size=128", *extra]

    t0 = time.perf_counter()
    generate_embeddings.main(base + ["task.shard=0", f"task.num_shards={n_rows // n_encoded}"])
    emb = load_embedding_shard(os.path.join(embs, "reps_0000.pkl"))
    e = torch.from_numpy(emb).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    noise = torch.randn(n_rows - n_encoded, emb.shape[1], generator=g, device=dev)
    np.save(os.path.join(embs, "reps_0001.npy"), (e.mean(0) + noise * e.std(0)).half().cpu().numpy())
    del e, noise
    qpath = generate_query_embeddings.main(base)
    q_emb = load_embedding_shard(qpath)
    print(f"corpus and query embeddings: {n_encoded} encoded + {n_rows - n_encoded} distractor rows, "
          f"{q_emb.shape} queries ({q_emb.dtype}) in {time.perf_counter() - t0:.2f} s wall")
    if q_emb.shape != (n_queries, emb.shape[1]) or not np.isfinite(q_emb).all():
        raise AssertionError(f"query_reps.pkl: {q_emb.shape}, finite={np.isfinite(q_emb).all()}")

    sweeps = {"count_above": mips_kernels.count_above_kernel,
              "count_above_groups": mips_kernels.count_above_groups_kernel,
              "groupmax": mips_kernels.groupmax_kernel}
    for kernel in sweeps.values():
        kernel.launches = 0
        kernel.launches_by_route = dict.fromkeys(mips_kernels.ROUTES, 0)
    outputs = {}
    for method in ("groupmax", "auto"):
        outputs[method] = os.path.join(work, f"{method}.json")
        t0 = time.perf_counter()
        run_retrieval.main(base + [f"task.mips_method={method}", f"task.topk={RETRIEVAL_K}",
                                   f"task.output_path={outputs[method]}",
                                   f"task.output_trec_path={work}/{method}.trec"])
        print(f"run_retrieval mips_method={method}: {n_queries} queries in "
              f"{time.perf_counter() - t0:.2f} s wall (CLI incl. shard load, index build, "
              "search, JSON and TREC write)")
    t0 = time.perf_counter()
    index = build_index(embs, dev)
    print(f"build_index: {time.perf_counter() - t0:.2f} s, blocks "
          f"{[(b[1], b[0].shape[0]) for b in index._blocks]} (valid, padded rows)")
    questions = QueryCSVDataset(csv)
    questions = [questions[i] for i in range(len(questions))]
    for method in ("fused", "approx", "exact_sort"):
        index.method = method
        outputs[method] = os.path.join(work, f"{method}.json")
        t0 = time.perf_counter()
        retrieve(q_emb, questions, tsv, embs, index=index, k=RETRIEVAL_K,
                 query_batch=QUERY_BATCH, output_json_path=outputs[method])
        print(f"retrieve method={method}: {n_queries} queries in {time.perf_counter() - t0:.2f} s "
              f"wall (search, JSON write); repairs of the last batch {index.last_repair}")
    launches = {name: kernel.launches for name, kernel in sweeps.items()}

    q = torch.from_numpy(q_emb).to(dev)
    for method in ("groupmax", "auto"):  # the CLI's own index is gone: one batch again
        index.method = method
        index.search(q[:QUERY_BATCH], RETRIEVAL_K)
        print(f"{method}: repairs of a {min(QUERY_BATCH, n_queries)}-query batch {index.last_repair}")
    for method, path in outputs.items():
        with open(path) as f:
            results = [row["ctxs"] for row in json.load(f)]
        check_exact(index, q, results, RETRIEVAL_K)
        print(f"{method}: {len(results)} queries, each top-{RETRIEVAL_K} equals the brute-force "
              f"exact top-{RETRIEVAL_K} within {TOPK_REL} (near-tie swaps allowed)")

    cuts = [1, 5, 20, RETRIEVAL_K]
    acc = evaluate_retrieval(outputs["groupmax"], cuts)
    tok = SimpleTokenizer()
    with open(outputs["groupmax"]) as f:
        payload = json.load(f)
    first = [next((i for i, c in enumerate(row["ctxs"]) if has_answers(c["text"], row["answers"], tok)),
                  RETRIEVAL_K) for row in payload]
    if any(acc[c] != [int(h < c) for h in first] for c in cuts):
        raise AssertionError("qa_eval disagrees with a recount of has_answers")
    print("qa_eval on the groupmax run: " + ", ".join(f"top-{c} {np.mean(acc[c]):.4f}" for c in cuts)
          + " (random weights), equal to a recount with has_answers")
    print(f"retrieval-path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the retrieval path never launched: {launches}")

    # ---- benchmark(): the methods over the 2,097,152-row block ----
    blk, n_valid, _off = max(index._blocks, key=lambda b: b[0].shape[0])
    bench = MipsIndex(dev)
    bench.add(blk[:n_valid])
    del index, blk
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    qb = q_emb[: n_queries // QUERY_BATCH * QUERY_BATCH].reshape(-1, QUERY_BATCH, q_emb.shape[1])
    qb = np.concatenate([qb] * max(1, bench_iters // len(qb)))
    for method in ("groupmax", "fused", "auto", "exact_sort"):
        bench.method = method
        stats = bench.benchmark(qb, RETRIEVAL_K)
        print(f"benchmark {method} over {bench._blocks[0][0].shape[0]} rows ({n_valid} valid), "
              f"B={QUERY_BATCH} k={RETRIEVAL_K}: {stats}")
    # where the time of one search goes (device time by kernel class)
    from dpr_scale_tpu_torch.tools import profile_serve

    q0 = torch.from_numpy(qb[0]).to(dev)
    rows = bench._blocks[0][0]
    qd = q0.to(rows.dtype)
    sweep = cuda_ms(lambda: mips_kernels.groupmax_kernel(qd, rows))
    bench.method = "groupmax"
    search = cuda_ms(lambda: bench._device_search(rows, q0, RETRIEVAL_K, n_valid))
    lone = lambda: mips_kernels.groupmax_kernel(qd, rows)
    _prof, kern = profile_serve.device_profile(lone, dev)
    prof_sweep = sum(us for key, us in kern.items() if "groupmax_kernel" in key)
    events = profile_serve.port_kernel_ms(lone, dev)["MIPS sweep kernels"]
    print(f"groupmax over these rows, B={QUERY_BATCH}, CUDA events: sweep kernel {sweep:.4f} ms, one "
          f"device search {search:.4f} ms, the rest (selection, gather, rescore, soundness) "
          f"{search - sweep:.4f} ms = {(search - sweep) / search:.1%}; the profiler on the sweep "
          f"kernel alone: {prof_sweep / profile_serve.PROFILED_CALLS / 1e3:.4f} ms per call, "
          f"the reports' CUDA events around its launch {events:.4f} ms")
    for method in ("groupmax", "fused"):
        bench.method = method
        profile_serve.report(f"{method} search B={QUERY_BATCH} k={RETRIEVAL_K} over "
                             f"{bench._blocks[0][0].shape[0]} rows",
                             lambda: bench.search(q0, RETRIEVAL_K), dev, None)
    routes = {name: kernel.launches_by_route for name, kernel in sweeps.items()}
    print(f"launches by route over the phase (CLI runs, retrieve(), benchmark, profile): {routes}")
    if any(r["score_tile"] or not r["wgmma"] for r in routes.values()):
        raise AssertionError(f"a sweep of the retrieval path did not take the wgmma kernel: {routes}")
    return launches


def _int_yardsticks():
    """The yardsticks of int_groupmax and int8_tile_max: ``torch._int_mm``
    (cuBLAS int8 x int8 -> int32) over YARD_CHUNK-row chunks, after the
    torch unpack where the corpus is packed, then the scaling and the maxima
    in PyTorch (no argmax)."""
    import torch

    from dpr_scale_tpu_torch.ops import int_kernels as ik

    def yard_groupmax(q8, corpus, sc, qsc, packed, planes):
        B, N = qsc.shape[0], corpus.shape[0]
        out = torch.empty((N // 8, B), device=corpus.device)
        for lo in range(0, N, YARD_CHUNK):
            x = corpus[lo : lo + YARD_CHUNK]
            s = torch._int_mm(q8, (ik.unpack_int4(x) if packed else x).T).float()
            if planes == 2:
                s = s[:B] + s[B:] * ik.INV127
            s = s * sc[lo : lo + YARD_CHUNK][None, :] * qsc[:, None]
            out[lo // 8 : lo // 8 + s.shape[1] // 8] = s.view(B, -1, 8).amax(dim=2).T
        return out

    def yard_tile_max(q8, x8, tile):
        return torch.cat([torch._int_mm(q8, x8[lo : lo + YARD_CHUNK].T).view(q8.shape[0], -1, tile)
                          .amax(dim=2).T for lo in range(0, x8.shape[0], YARD_CHUNK)])

    return yard_groupmax, yard_tile_max


# (B, N, D, packed, planes, timed): the tool's geometry (int4, one plane),
# the CLI's query batch and a serving batch over the bench geometry in both
# tiers and both plane counts, two ragged cases
INT_CASES = (
    (256, 1 << 22, MIPS_DIM, True, 1, True),
    *((B, MIPS_ROWS, MIPS_DIM, packed, planes, True) for B in (QUERY_BATCH, 64)
      for packed in (False, True) for planes in (1, 2)),
    (7, 101 * 128, 100, False, 1, False),
    (7, 101 * 128, 100, True, 2, False),
)


def phase_int_kernels(dev, cases=INT_CASES, tile=2048):
    """Phase 16: int_groupmax (the tool's i4_groupmax, and its int8 and
    two-plane forms) and int8_tile_max (the tool's pallas_dot) against their
    plain versions on ``dev``: random query planes, random corpus bytes
    (every nibble, -8 included), row scales U(0.5, 1.5), query scales 1 in
    the tool's case and U(0.01, 0.1) elsewhere. Values and rows must equal
    the plain version's exactly and repeat bit for bit. int8_tile_max runs on
    the one-plane int8 cases and on the unpacked rows of the tool's case, as
    the tool does. The timed cases also time kernel, plain version and the
    ``torch._int_mm`` yardstick. Returns each kernel's JSON entry from the
    first timed case, max |err| over all cases."""
    import torch

    from dpr_scale_tpu_torch.ops import int_kernels as ik

    yard_groupmax, yard_tile_max = _int_yardsticks()
    entries = {n: {"max_abs_err": 0.0} for n in ("int_groupmax", "int8_tile_max")}
    g = torch.Generator(device=dev).manual_seed(SEED + 30)

    def rand_int8(shape, lo):
        return torch.randint(lo, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def record(name, what, got, again, want, timed, run, plain, yard, n_bytes, ops):
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} ({what}): repeated calls give other bits")
        if any(a.shape != b.shape or not torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} ({what}) disagrees with its plain version")
        err = max((a.double() - b.double()).abs().max().item() for a, b in zip(got, want))
        print(f"{name} ({what}): equal to the plain version, max_abs_err {err:.3g}; repeatable")
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
        if not timed:
            return
        b_ms, b_by = bound(n_bytes, ops, peak=INT8_OPS)
        ms = cuda_ms(run)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        yard_ms = library_ms(yard)
        timing = {"ms": ms}
        if name == "int_groupmax":  # redesigned: queued calls too, as the FFN's
            timing = {"ms": device_ms(run, calls=10), "single_ms": ms}
            print(f"{name} ({what}): kernel {timing['ms']:.4f} ms queued, "
                  f"{b_ms / timing['ms']:.1%} of its bound")
        print(f"{name} ({what}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm "
              f"yardstick {yard_ms} ms, bound {b_ms:.4f} ms ({b_by}) = {b_ms / ms:.1%} of the "
              "kernel's time; no single PyTorch call computes it")
        if "plain_ms" not in entries[name]:
            entries[name].update(**timing, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None, yardstick_ms=yard_ms)

    for B, N, D, packed, planes, timed in cases:
        W = D // 2 if packed else D
        q8, corpus = rand_int8((planes * B, D), -127), rand_int8((N, W), -128)
        sc = torch.rand(N, generator=g, device=dev) + 0.5
        tool = B == 256 and packed and planes == 1
        qsc = torch.ones(B, device=dev) if tool else torch.rand(B, generator=g, device=dev) * 0.09 + 0.01
        what = f"B={B} N={N} D={D} {'int4' if packed else 'int8'} planes={planes}"
        args = (q8, corpus, sc, qsc)
        kw = {"packed": packed, "planes": planes}
        routes = dict(getattr(ik.int_groupmax_kernel, "launches_by_route", {}))
        got, again = ik.int_groupmax_kernel(*args, **kw), ik.int_groupmax_kernel(*args, **kw)
        want = ik.int_groupmax_plain(*args, **kw)
        if routes:  # the route each shape takes
            routes = {r: n - routes[r] for r, n in ik.int_groupmax_kernel.launches_by_route.items()}
            print(f"int_groupmax ({what}): launches by route {routes}")
            if D == MIPS_DIM and routes["wgmma"] != 2:
                raise AssertionError(f"int_groupmax ({what}) did not run the wgmma kernel")
        out_bytes = 2 * 4 * (N // 8) * B
        record("int_groupmax", what, got, again, want, timed,
               lambda: ik.int_groupmax_kernel(*args, **kw),
               lambda: ik.int_groupmax_plain(*args, **kw),
               lambda: yard_groupmax(*args, packed, planes),
               nbytes(*args) + out_bytes, 2 * planes * B * N * D)
        del got, again, want
        if timed:  # the search's form: no argmax stored
            bare = lambda: ik.int_groupmax_kernel(*args, **kw, want_rows=False)  # noqa: E731
            ms = cuda_ms(bare)
            b_ms, b_by = bound(nbytes(*args) + out_bytes // 2, 2 * planes * B * N * D,
                               peak=INT8_OPS)
            queued = device_ms(bare, calls=10) if dev.type == "cuda" else ms
            print(f"int_groupmax ({what}) without rows, as the search calls it: kernel {ms:.4f} "
                  f"ms ({queued:.4f} ms queued, {b_ms / queued:.1%} of its bound), bound "
                  f"{b_ms:.4f} ms ({b_by})")
        if planes == 1 and (tool or not packed):
            x8 = torch.cat([ik.unpack_int4(corpus[lo : lo + YARD_CHUNK])  # int32 temporaries
                            for lo in range(0, N, YARD_CHUNK)]) if packed else corpus
            n_tile = tile if N % tile == 0 else N // 8  # 1,616 rows: ragged score tiles
            got, again = ik.int8_tile_max_kernel(q8, x8, n_tile), ik.int8_tile_max_kernel(q8, x8, n_tile)
            want = ik.int8_tile_max_plain(q8, x8, n_tile)
            record("int8_tile_max", f"B={B} N={N} D={D} tile={n_tile}", (got,), (again,), (want,),
                   timed, lambda: ik.int8_tile_max_kernel(q8, x8, n_tile),
                   lambda: ik.int8_tile_max_plain(q8, x8, n_tile),
                   lambda: yard_tile_max(q8, x8, n_tile),
                   nbytes(q8, x8) + 4 * B * (N // n_tile), 2 * B * N * D)
            del got, again, want, x8
        del q8, corpus, sc, qsc, args
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(sweep_build_report(
            "int_groupmax_wgmma_kernel", "int_groupmax wgmma",
            lambda lib: {f"{'int4' if p else 'int8'} planes={n} B={B}":
                         lib.dst_int_groupmax_smem(B, p, n)
                         for p in (0, 1) for n in (1, 2) for B in (512, 64)}))
    return entries


def _plain_topk(index, q, k, chunk=256):
    """The index's exact top-k by its plain chunked arithmetic (for a
    quantised index: the dequantised scores), blocks merged, numpy."""
    import numpy as np

    from dpr_scale_tpu_torch.index.mips import merge_topk_batched

    out_s, out_i = [], []
    for lo in range(0, q.shape[0], chunk):
        per_s, per_i = [], []
        for emb, n_valid, offset in index._blocks:
            s, i = index._exact_topk(emb, n_valid, q[lo : lo + chunk], min(k, emb.shape[0]))
            i = i.cpu().numpy()
            per_s.append(np.pad(s.cpu().numpy(), ((0, 0), (0, k - s.shape[1])), constant_values=-np.inf))
            per_i.append(np.pad(np.where(i >= 0, i + offset, -1), ((0, 0), (0, k - i.shape[1])),
                                constant_values=-1))
        s, i = merge_topk_batched(np.stack(per_s), np.stack(per_i), k)
        out_s.append(s)
        out_i.append(i)
    return np.concatenate(out_s), np.concatenate(out_i)


def _same_topk(what, results, want_s, want_i):
    """DPR ctx lists against (scores, rows): the same score lists exactly,
    the same rows wherever a score stands clear of the k-th (dequantised
    scores tie, and torch.topk breaks ties in its own order)."""
    import numpy as np

    for b, ctxs in enumerate(results):
        s = np.array([c["score"] for c in ctxs], np.float32)
        ids = np.array([int(c["id"]) for c in ctxs])
        if not np.array_equal(s, want_s[b]):
            raise AssertionError(f"{what}, query {b}: scores differ from the plain path's")
        clear = s > s[-1]
        if set(ids[clear]) != set(want_i[b][clear]):
            raise AssertionError(f"{what}, query {b}: rows differ from the plain path's")


def phase_int_retrieval(work, dev, n_queries=RETRIEVAL_QUERIES, extra=(), bench_iters=4):
    """Phase 17, the quantised tiers on phase 15's shards and questions in
    ``work`` (``n_queries``/``extra`` as there only shrink it on the CPU):
    ``cli.run_retrieval`` with ``task.mips_method=int8`` and with
    ``=int4 task.rerank_oversample=4``, then ``retrieve()`` over one built
    index a tier, int8 with ``int8_query_planes=2`` and int4 without rerank.
    Unreranked results must equal the plain path's dequantised top-k on
    ``dev``, reranked scores the fp32 products with their shard rows; the
    int_groupmax counter must rise. Prints recall@k against the exact fp32
    top-k, ``MipsIndex.benchmark`` of int8, int4 and groupmax at B =
    QUERY_BATCH over the largest block, and peak memory. Returns the
    kernels' launch counts."""
    import numpy as np
    import torch

    from dpr_scale_tpu_torch.cli import run_retrieval
    from dpr_scale_tpu_torch.data.datasets import QueryCSVDataset
    from dpr_scale_tpu_torch.encode.embeddings import ShardRowReader, load_embedding_shard
    from dpr_scale_tpu_torch.index.mips import MipsIndex
    from dpr_scale_tpu_torch.ops import int_kernels
    from dpr_scale_tpu_torch.retrieve.retrieval import build_index, retrieve

    tok_dir, tsv, csv, embs = (os.path.join(work, n) for n in
                               ("tok", "passages.tsv", "questions.csv", "embs"))
    base = ["--config", os.path.join(ROOT, "conf", "nq.yaml"), "--device", str(dev),
            f"task.transform.model_path={tok_dir}", f"datamodule.passages_path={tsv}",
            f"datamodule.test_path={csv}", f"task.ctx_embeddings_dir={embs}",
            f"task.topk={RETRIEVAL_K}", *extra]
    q_emb = load_embedding_shard(os.path.join(embs, "query_reps.pkl"))
    questions = QueryCSVDataset(csv)
    questions = [questions[i] for i in range(len(questions))]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    int_kernels.int_groupmax_kernel.launches = int_kernels.int8_tile_max_kernel.launches = 0
    int_kernels.int_groupmax_kernel.launches_by_route = dict.fromkeys(int_kernels.ROUTES, 0)
    outputs = {}
    for tag, opts in (("int8", ["task.mips_method=int8"]),
                      ("int4_rerank4", ["task.mips_method=int4", "task.rerank_oversample=4"])):
        outputs[tag] = os.path.join(work, f"{tag}.json")
        t0 = time.perf_counter()
        run_retrieval.main(base + opts + [f"task.output_path={outputs[tag]}",
                                          f"task.output_trec_path={work}/{tag}.trec"])
        print(f"run_retrieval {' '.join(opts)}: {n_queries} queries in "
              f"{time.perf_counter() - t0:.2f} s wall (CLI incl. shard load, host quantisation, "
              "search, JSON and TREC write)")
    indexes = {}
    for method, planes, tag in (("int8", 2, "int8_planes2"), ("int4", None, "int4")):
        t0 = time.perf_counter()
        indexes[tag] = build_index(embs, dev, method=method)
        t1 = time.perf_counter()
        outputs[tag] = os.path.join(work, f"{tag}.json")
        retrieve(q_emb, questions, tsv, embs, index=indexes[tag], k=RETRIEVAL_K,
                 query_batch=QUERY_BATCH, int8_query_planes=planes, output_json_path=outputs[tag])
        print(f"retrieve method={method} int8_query_planes={indexes[tag].int8_query_planes}: "
              f"build_index {t1 - t0:.2f} s, {n_queries} queries in {time.perf_counter() - t1:.2f} s "
              f"wall (search, JSON write); repairs of the last batch {indexes[tag].last_repair}")
    launches = {"int_groupmax": int_kernels.int_groupmax_kernel.launches,
                "int8_tile_max": int_kernels.int8_tile_max_kernel.launches}
    routes = dict(int_kernels.int_groupmax_kernel.launches_by_route)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0

    # ---- checks: the plain path's dequantised top-k; the rerank's fp32 rescores
    results = {}
    for tag, path in outputs.items():
        with open(path) as f:
            results[tag] = [row["ctxs"] for row in json.load(f)]
        if any(len(ctxs) != RETRIEVAL_K for ctxs in results[tag]):
            raise AssertionError(f"{tag}: a query has fewer than {RETRIEVAL_K} results")
    q = torch.from_numpy(q_emb).to(dev)
    indexes["int8"] = indexes.pop("int8_planes2")
    for tag, planes in (("int8", 1), ("int8_planes2", 2), ("int4", 1)):
        index = indexes[tag.split("_")[0]]
        index.int8_query_planes = planes
        _same_topk(tag, results[tag], *_plain_topk(index, q, RETRIEVAL_K))
        print(f"{tag}: {len(results[tag])} queries, each top-{RETRIEVAL_K} equals the plain "
              f"path's dequantised top-{RETRIEVAL_K} on {dev} (scores exactly, rows clear of ties)")
    reader = ShardRowReader(embs)
    ids = np.array([[int(c["id"]) for c in ctxs] for ctxs in results["int4_rerank4"]])
    served = np.array([[c["score"] for c in ctxs] for ctxs in results["int4_rerank4"]], np.float32)
    true = np.einsum("bd,bkd->bk", q_emb, reader(ids.reshape(-1)).reshape(*ids.shape, -1))
    rel = float(np.abs(served - true).max() / np.abs(true).max())
    if rel > 1e-5:
        raise AssertionError(f"int4_rerank4: reranked scores differ from fp32 q.row by {rel:.3g}")
    print(f"int4_rerank4: every reranked score equals fp32 q.row of its shard row (max rel "
          f"err {rel:.3g})")

    exact = build_index(embs, dev, dtype=torch.float32, method="exact_sort")
    exact_i = np.concatenate([exact.search(q[lo : lo + QUERY_BATCH], RETRIEVAL_K)[1]
                              for lo in range(0, q.shape[0], QUERY_BATCH)])
    del exact
    recall = {tag: float(np.mean([len(set(int(c["id"]) for c in ctxs) & set(e.tolist()))
                                  for ctxs, e in zip(res, exact_i)]) / RETRIEVAL_K)
              for tag, res in results.items()}
    print(f"recall@{RETRIEVAL_K} against the exact fp32 top-{RETRIEVAL_K} (random weights): "
          f"{recall}; peak device memory of the phase's searches {peak:.2f} GiB")

    # ---- benchmark(): the tiers and groupmax over the largest block ----
    bq = min(QUERY_BATCH, n_queries)
    qb = q_emb[: n_queries // bq * bq].reshape(-1, bq, q_emb.shape[1])
    qb = np.concatenate([qb] * max(1, bench_iters // len(qb)))
    for method in ("int8", "int4"):
        blk, n_valid, _off = max(indexes[method]._blocks, key=lambda b: b[0].shape[0])
        bench = MipsIndex(dev, method=method)
        bench._blocks, bench._total_rows, bench._dim = [(blk, n_valid, 0)], n_valid, blk.shape[1]
        stats = bench.benchmark(qb, RETRIEVAL_K)
        print(f"benchmark {method} over {blk.shape[0]} rows ({n_valid} valid), B={bq} "
              f"k={RETRIEVAL_K}: {stats}")
        del bench, blk
    indexes.clear()
    rows = np.load(os.path.join(embs, "reps_0001.npy"), mmap_mode="r")[:n_valid]
    bench = MipsIndex(dev, method="groupmax")
    bench.add(torch.from_numpy(np.array(rows)).to(dev))
    print(f"benchmark groupmax over the same rows, B={bq} k={RETRIEVAL_K}: "
          f"{bench.benchmark(qb, RETRIEVAL_K)}")
    del bench
    print(f"quantised-retrieval launches: {launches}")
    if launches["int_groupmax"] < 1:
        raise AssertionError(f"a kernel of the quantised path never launched: {launches}")
    print(f"int_groupmax launches by route: {routes}")
    if routes["wgmma"] != launches["int_groupmax"]:
        raise AssertionError(f"an int_groupmax run did not take the wgmma kernel: {routes}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dpr_scale_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    smi = phase_device()
    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s:")
    print("\n".join(l for l in cuda_lib.build_log().splitlines() if "Used" in l))
    attn = phase_attention()
    count = phase_count(torch.device("cuda", 0))
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        launches = phase_slice(work, torch.device("cuda", 0))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"device {smi}; peak device memory of serving "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    train_kernels = phase_train_kernels()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        train_launches, _stats, data = phase_train(work, torch.device("cuda", 0))
        phase_train_grads(torch.device("cuda", 0), data)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    ffn_kernels = phase_ffn_kernels()
    torch.cuda.empty_cache()
    fused_ffn = ["task.model.fused_ffn=true"]
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        ffn_launches = phase_slice(work, torch.device("cuda", 0), n_rows=FFN_INDEX_ROWS,
                                   extra=fused_ffn)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        ffn_train_launches, _stats, data = phase_train(work, torch.device("cuda", 0),
                                                      extra=fused_ffn)
        phase_train_grads(torch.device("cuda", 0), data, extra=fused_ffn)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    gather_errs = phase_gather_kernels()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        citadel_launches = phase_citadel_cli(work, torch.device("cuda", 0))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    search_launches, _stats, captured = phase_citadel_search(torch.device("cuda", 0))
    gather = citadel_kernel_entries(captured)
    del captured
    for name, err in gather_errs.items():
        gather[name]["max_abs_err"] = max(gather[name]["max_abs_err"], err)
    citadel_launches["gather_score_serial"] += search_launches["gather_score_serial"]
    citadel_launches["gather_score_streamed"] += search_launches["gather_score_streamed"]
    torch.cuda.empty_cache()
    mips = phase_mips_kernels(torch.device("cuda", 0))
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        retrieval_launches = phase_retrieval_cli(work, torch.device("cuda", 0))
        torch.cuda.empty_cache()
        int_entries = phase_int_kernels(torch.device("cuda", 0))
        torch.cuda.empty_cache()
        int_launches = phase_int_retrieval(work, torch.device("cuda", 0))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"device {smi}")
    source = "dpr_scale_tpu_torch/csrc/"
    kernels = [
        {"name": "attention_fwd", "route": "cuda", "source": source + "attention_fwd.cu",
         "replaces": "dpr_scale_tpu/ops/attention.py:210",
         "launches": launches["attention_fwd"], **attn},
        {"name": "attention_fwd_dropout", "route": "cuda", "source": source + "attention_fwd.cu",
         "replaces": "dpr_scale_tpu/ops/attention.py:210",
         "launches": train_launches["attention_fwd_dropout"],
         **train_kernels["attention_fwd_dropout"]},
        {"name": "attention_bwd", "route": "cuda", "source": source + "attention_bwd.cu",
         "replaces": "dpr_scale_tpu/ops/attention.py:237",
         "launches": train_launches["attention_bwd"], **train_kernels["attention_bwd"]},
        {"name": "count_above_groups", "route": "cuda", "source": source + "count_groups.cu",
         "replaces": "dpr_scale_tpu/ops/mips_kernels.py:134",
         "launches": launches["count_above_groups"] + retrieval_launches["count_above_groups"],
         **count},
        {"name": "ffn_fwd", "route": "cuda", "source": source + "ffn_fwd.cu",
         "replaces": "dpr_scale_tpu/ops/ffn.py:169",
         "launches": ffn_train_launches["ffn_fwd"], **ffn_kernels["ffn_fwd"]},
        {"name": "ffn_ln_fwd", "route": "cuda", "source": source + "ffn_fwd.cu",
         "replaces": "dpr_scale_tpu/ops/ffn.py:387",
         "launches": ffn_launches["ffn_ln_fwd"], **ffn_kernels["ffn_ln_fwd"]},
        *({"name": name, "route": "cuda", "source": source + "gather_score.cu",
           "replaces": f"dpr_scale_tpu/index/inverted_device.py:{line}",
           "launches": citadel_launches[name], **gather[name]}
          for name, line in (("gather_score_serial", 431), ("gather_score_pipelined", 550),
                             ("gather_score_streamed", 648))),
        *({"name": name, "route": "cuda", "source": source + "mips_scan.cu",
           "replaces": f"dpr_scale_tpu/ops/mips_kernels.py:{line}",
           "launches": retrieval_launches.get(name, 0), **mips[name]}
          for name, line in (("count_above", 71), ("groupmax", 208), ("tile_max_scores", 242))),
        *({"name": name, "route": "cuda", "source": source + "int_scan.cu",
           "replaces": f"tools/microbench_int4_kernel.py:{line}",
           "launches": int_launches[name], **int_entries[name]}
          for name, line in (("int8_tile_max", 111), ("int_groupmax", 160))),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
