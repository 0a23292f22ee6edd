"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``dpr_scale_tpu_torch/csrc`` and drives
its two paths at full bert_base width (conf/nq.yaml): serving (corpus
encoding through ``cli.generate_embeddings`` and ``/search`` requests
against ``cli.serve.build_retriever`` over a 1,048,576-row index) and
training (``cli.train``, dropout 0.1) and the weights it trains through a
save, a resume and an export into encoding and retrieval. Phases:

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
     CITADEL_TOL, bf16 within CITADEL_BF16_REL, pipelined equals the fused
     scorer; the fused scorer's (gather_run_max) and the pipelined
     kernel's counters must rise, every launch of both on the bulk-copy
     route;
 13. the device search at the size its users run: the MS MARCO-like layout
     of tools/bench_citadel_device.py (8.8M docs, 21.1M padded postings in
     five buckets, D = 32 bf16, a 128-dim bf16 CLS plane) built on the
     card, B = 128 queries of 32 tokens routed uniformly, searched with the
     CLS term (dense combine) and without it (sorted combine), each with
     one gather_run_max launch a search and no other scorer: median search
     time, queries/s, the latency dict, peak memory and the device time by kernel class; the kernel
     path equals the plain-scorer path on the card and a numpy oracle on
     4 queries; the fused scorer's triples equal the per-bucket route's bit
     for bit on every bucket of one CLS search and of one with every
     bucket streamed, and the plain version's within CITADEL_TOL; the
     tiled top-k equals ``torch.topk`` on a (128, 8.8M) accumulator (both
     timed); the kernels' JSON times are taken on that search's buckets
     (gather_run_max beside the per-bucket route, CUDA events around the
     whole chain), where the pipelined kernel must give the serial
     kernel's bits;
 14. the three MIPS sweep kernels (count_above, groupmax, tile_max_scores)
     and pass 1, topk_candidates (kc = 128, the rows past N - 77 pads),
     vs their plain versions over 2,097,152 x 768 bf16 rows (the JAX
     bench.py geometry) at B = 512 (the retrieval CLI's query batch) and
     B = 64, plus an fp32 case and a ragged one (B = 7, D = 100, rows not a
     multiple of the kernels' 2,048-row span): counts exact where the
     threshold sits clear of every score (within the COUNT_MARGIN_REL
     bracket elsewhere), maxima within MAX_REL of max |ref|, repeated calls
     the same bits; pass 1's row sets equal where the kc-th score is clear,
     its scores within MAX_REL of plain's and of their rows' fp32 sums, no
     pad row, its steps timed apart (the fp32 case on the score tile); their
     times beside the plain version, a cuBLAS yardstick
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
     ``MipsIndex.benchmark`` times groupmax, and fused, auto and exact_sort
     with pass 1 on the kernel and on the plain version (``plain_pass1``)
     in one process, at B = 512 over the 2,097,152-row block; where fused's
     fallbacks come from on both; pass 1's scores are pass 2's bits; every
     launch of the sweeps and of pass 1 in the phase on the wgmma route;
 16. the two integer sweep kernels vs their plain versions: int_groupmax
     (the tool's i4_groupmax) at the tool's geometry (4,194,304 x 768 int4,
     B = 256, random packed bytes, row scales U(0.5, 1.5)), at B = 512 and
     64 over 2,097,152 x 768 rows in int8 and int4 with one and two query
     planes, and ragged (B = 7, D = 100); int8_tile_max (the tool's
     pallas_dot) on the int8 and the tool's rows; values and rows exactly
     equal and repeatable; their times beside the plain version, a
     ``torch._int_mm`` yardstick and the bound (both also queued, with
     their share of the bound); both kernels' launches by route, the
     D = 768 cases (int8_tile_max's in 2,048-row tiles) on the wgmma
     kernels; those kernels' registers, spills, shared memory and IGMMA /
     UTMALDG counts in their SASS;
 17. the quantised tiers on phase 15's shards and questions:
     ``cli.run_retrieval`` with ``task.mips_method=int8`` and with ``=int4
     task.rerank_oversample=4``, ``retrieve()`` with int8 at
     ``int8_query_planes=2`` and int4 without rerank; unreranked results
     equal the plain path's dequantised top-100 on the card, reranked
     scores the fp32 q . row of their shard rows; the int_groupmax counter
     must rise, every launch on the wgmma route; recall@100 against the exact
     fp32 top-100 (an fp32 index, pass 1 its plain version), peak memory and
     ``MipsIndex.benchmark`` of int8, int4 and groupmax at B = 512 over the
     2,097,152-row block.
 18. the checkpoint slice (conf/nq.yaml, bert_base from seed 0, the phase-4
     vocab, dropout 0.1, learning rate and warmup overridden): keyed data
     the model can learn (CKPT_PASSAGES passages, each with a key pair, its
     sibling as the hard negative); ``cli.train`` for CKPT_STEPS steps at
     batch 128 with a save every CKPT_STEPS / 4 (top 1, async), unbroken,
     and broken after its save at CKPT_STEPS / 2 then resumed with
     ``--resume`` in a new ``cli.train`` call: the restored state equals
     the saved one bit for bit, the resumed steps' batches and LRs equal
     the unbroken run's, their losses within RESUME_LOSS_REL; save
     (synchronous and async-blocking) and restore times and the state's
     bytes on disk; then ``cli.generate_embeddings`` and
     ``cli.run_retrieval`` (fused, top-100) on ``task.checkpoint_path`` =
     the exported ``params_best``: the same top-100 ids as the best model
     in memory, and recall@RECALL_K over CKPT_QUESTIONS held-out questions
     above the seeded encoder's by RECALL_MARGIN; the attention forward
     (with and without dropout), backward and group-count counters must
     rise.
 19. the configs at their own batch and model (OWN_RUNS, on phase 18's
     keyed data): the GradCache step (c = 2, 4) against the monolithic one
     at rate 0 and batch 128 (loss within GC_LOSS_REL, gradient cosine at
     least GC_COS), the remat step against the one without at rate 0.1 and
     batch 64 (REMAT_LOSS_REL, REMAT_COS); then ``cli.train`` on
     conf/nq.yaml at its batch 256 with ``task.grad_cache_chunks=2``
     (without and with the fused FFN, 4 steps), conf/ccnews_ict.yaml at its
     batch 2,048 with 16 chunks (2 steps), conf/nq.yaml with bert_large's
     arch and remat at batch 256 (3 steps), lamb, madgrad and accumulation
     over 2 steps at batch 64, and a run with ``trainer.profile_dir``: step
     ms by CUDA events, queries/s and peak memory of each; every loss
     finite, every peak under the card's memory, the profiler's trace holds
     device events; the attention counters (and the FFN forward's with the
     flag) must rise.
 20. the multi-vector slice (conf/citadel.yaml, bert_base at L = 128, on
     phase 18's keyed data, its learning rate and warmup): the monolithic
     CITADEL step at the conf's batch of 128 (its peak or its OOM) and the
     GradCache gate (MV_GC_CHUNKS chunks against it at rate 0, batch
     MV_GATE_BATCH); run_eval at the conf's 1,408 validation and 6,528
     test contexts (ms, peak, the blocked scorer's own peak);
     ``cli.train`` for MV_STEPS steps under GradCache with top-1 async
     saves, exporting params_best; ``cli.generate_multivec_embeddings`` and
     ``cli.citadel_retrieval`` (host and bf16 device index) on the export:
     the same top-100 as the exported model in memory, recall@RECALL_K
     against the seeded encoder reported; ``cli.serve`` with only
     ``serve_citadel``: ``/search_citadel`` answers as citadel_retrieval's
     device-index run (the CLI's first query batch within
     CITADEL_SAME_REL, other batch shapes within CITADEL_BF16_REL); two
     SPLADE steps (conf/nq.yaml, ``task.model.family=splade``, the fused
     FFN) at batch MV_SPLADE_BATCH; step ms by CUDA events, queries/s and
     peaks, every loss finite, every peak under the card's memory; the
     attention forward (with and without dropout), backward, fused FFN and
     gather_run_max counters must rise; the SPLADE run exports its params
     for phase 21.
 21. the rest of the reference surface (phase_rest), on phase 18's keyed
     data, vocab and export and phase 20's CITADEL and SPLADE exports, at
     bert_base width: (a) the export's teacher vectors for phase 18's
     questions and positives, ``cli.train --config conf/distill.yaml`` as
     the conf stands for DISTILL_STEPS steps (the MSE must fall) and with
     ``task.model.fused_attention=true``; the attention kernels held against
     their plain versions at its shape (B = 32, L = 64, rate 0.1) beside
     SDPA; (b) a TREC run of ``cli.run_retrieval`` (fused, top 20) for
     RERANK_QUESTIONS questions and ``cli.rerank`` of each type (dense on
     the export, within RERANK_BF16_REL of the retrieval's scores; the
     cross-encoder seeded at L = 256; multivec on the CITADEL export),
     pairs/s; (c) the export and a seeded encoder over REST_PASSAGES keyed
     passages plus fp16 distractors (REST_ROWS rows at D = 768 + 768),
     ``tools.spar_retrieval`` for REST_QUESTIONS questions at k = 100 against
     a brute force of the combined vectors; count_above_groups, count_above,
     groupmax and tile_max held at D = 1,536; ``tools.tune_spar_weights``;
     (d) the export as a ``torch.export`` program (its vectors the eager
     encode's within EXPORT_REL, the attention kernel launched inside it)
     and as int8 weights (cosine >= QUANT_COS, bytes, recall@RECALL_K);
     passages/s of each; (e) ``datamodule.num_workers=REST_WORKERS``: a shard
     byte-equal to the serial one; (f) the SPLADE export through
     ``generate_embeddings``, ``run_retrieval`` (fused) and ``/search``,
     against a brute force, count_above_groups on the wgmma route fed by
     cp.async (rows of 61,044 bytes, which TMA cannot address) in both, the
     sweeps' span (cut to fill the card), and the sweeps held there on that
     path's vectors and on random mixed-sign ones. Each
     main-path run with the counts
     set to 0 just before it and read just after.
 22. the index store, the host tiers and data-parallel training
     (phase_scale): (a) the four bf16 sweeps at D = 30,528 on the wgmma
     route fed by TMA and at D = 30,522 on the same fed by cp.async (each
     64-column stage's sums promoted into fp32 adds past 1,536 columns) on
     dense non-negative and normal vectors, clear counts equal to plain,
     tile and group maxima against fp64 beside cuBLAS's, the kernels timed
     at both widths over 65,536 rows, B = 256, beside plain and the bound;
     (b) 2,097,152 x 768 seeded fp16 shards, build_int8_store,
     a fresh int8 MipsIndex filled by load_int8_store with half the rows on
     the device and half streamed from the host: the cold start (load and
     the first search of 1,024 questions at k = 100, B = 256) against
     building the index from the shards, q/s streamed against all blocks on
     the device, the card's busy share while streaming, the peak memory;
     the streamed top-100 equal to the all-on-device one; fused and groupmax
     with every block host-resident equal to a brute force; (c) cli.train on
     conf/nq.yaml at batch 256 under GradCache c = 2, without a process
     group and in a world-size-1 NCCL group with trainer.strategy=
     ddp_sharded (ZeRO-1): the same losses and parameters, and the ZeRO-1
     checkpoint loaded without a group; (d) cli.sweep over two one-step
     runs. Each main-path run counted alone.
 23. the expert-parallel CITADEL search and the multi-vector task under
     data parallelism (phase_expert_parallel): (a) phase 13's 8.8M-doc
     index laid out over EP_SHARDS shards of the card and on the card alone
     from the same tensors, every search of the sharded layout (with CLS:
     the dense combine over the shards' accumulator columns; without: the
     sorted combine) within CITADEL_SAME_REL of the single-device one, the
     same docs but for near-ties; ms a search of both layouts by CUDA
     events, the peak memory, the largest shard's accumulator bytes; the
     gather kernels held against plain at the shards' bucket shapes; (b)
     ``cli.citadel_retrieval`` (bf16 device index) and the
     ``serve_citadel`` tower's ``/search_citadel`` on phase 20's export,
     each with ``expert_parallel`` over EP_SHARDS x the card (the device
     list replaced in-process) against the same run without it; (c)
     ``cli.train`` on conf/citadel.yaml at its batch (128 queries, 256
     contexts, L = 128) for EP_DP_STEPS steps, without a process group and
     in a world-size-1 NCCL group with ZeRO-1: the same losses and
     parameters. gather_run_max must launch in (a), once a shard a search
     and no other scorer, its triples the per-bucket route's bits on the
     shards' 18 buckets, and in (b). Each main-path run counted alone.

Weights and data are made from fixed seeds. Needs a CUDA device; exits
non-zero without one, or when any check fails. The last two lines of
standard output are a JSON object of per-kernel results (with each
kernel's bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over 989 TFLOP/s bf16 or 1,979 TOPS int8, an H100 SXM's peaks,
and the time of one PyTorch call computing the same function where one
exists) and a JSON object ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import json
import os
import re
import shutil
import signal
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


def stop_started_processes():
    """Stop what this process started: the worker pools' helper processes
    (each waited for), then any other child still running, killed and
    reaped. Returns ``pid cmdline`` of each process of the second kind."""
    parallel = sys.modules.get("dpr_scale_tpu_torch.data.parallel")
    if parallel is not None:
        parallel.stop_worker_processes()
    left, me = [], str(os.getpid())
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]
            with open(f"/proc/{pid}/cmdline") as f:
                cmd = f.read().replace("\0", " ").strip()
        except OSError:
            continue
        if ppid == me:
            left.append(f"{pid} {cmd}")
            try:
                os.kill(int(pid), signal.SIGKILL)
                os.waitpid(int(pid), 0)
            except (ProcessLookupError, ChildProcessError):
                pass
    return left


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


def phase_count(dev, cases=COUNT_CASES, group=256, plain_reps=5):
    """Phase 3: count_above_groups against its plain version on ``dev`` for
    each (B, N, D) of ``cases`` (bf16, thresholds at each query's 99.99th
    score percentile), within the COUNT_MARGIN_REL band; on the card also
    its times, yardstick (each the median of ``plain_reps`` calls) and
    bound. Returns the JSON entry of the last case (times absent off the
    card), max |err| over all cases."""
    import torch

    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    entry = {"max_abs_err": 0.0}
    for case in cases:  # (B, N, D), or (B, N, D, (queries, rows)) of a path's own vectors
        B, N, D = case[:3]
        kernel = mk.count_above_groups_kernel  # looked up now: a rehearsal patches it
        if len(case) > 3:
            q, corpus = (t.to(torch.bfloat16) for t in case[3])
        else:
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
                               reps=plain_reps, warmup=1)
            yard_ms = cuda_ms(lambda: _yard_count_groups(q, corpus, tau, group), reps=plain_reps,
                              warmup=1)
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


def post(url, questions, k, path="/search"):
    req = urllib.request.Request(
        url + path, data=json.dumps({"questions": questions, "k": k}).encode(),
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


@functools.lru_cache(maxsize=1)
def _sass_dump(tool, library):
    """The library's SASS, dumped once a run (every report reads the same
    build)."""
    return subprocess.run([tool, "--dump-sass", library], capture_output=True, text=True,
                          timeout=600).stdout


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
    sass = _sass_dump(tool, cuda_lib.build())
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

    kernels = (gs.gather_run_max_kernel, gs.gather_score_pipelined_kernel)
    for k in kernels:
        k.launches = 0
    bulk = gs.gather_score_pipelined_kernel.launches_by_route["bulk_copy"]
    fused_bulk = gs.gather_run_max_kernel.launches_by_route["bulk_copy"]
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
    launches = {"gather_run_max": kernels[0].launches,
                "gather_score_pipelined": kernels[1].launches}

    if len(host) != n_queries or any(len(r) != min(100, n_passages) for r in host):
        raise AssertionError(f"host run: {len(host)} queries, lengths {set(map(len, host))}")
    checks = [("fp32 device vs host", fp32, host, CITADEL_TOL),
              ("fp32 device streamed vs host", streamed, host, CITADEL_TOL),
              ("bf16 device vs host", bf16, host, _rel_tol(CITADEL_BF16_REL)),
              ("bf16 pipelined vs bf16 fused", pipelined, bf16, _rel_tol(CITADEL_SAME_REL))]
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
    fused_bulk = gs.gather_run_max_kernel.launches_by_route["bulk_copy"] - fused_bulk
    print(f"gather_run_max launches on the bulk-copy route: {fused_bulk} of "
          f"{launches['gather_run_max']}")
    if fused_bulk != launches["gather_run_max"]:
        raise AssertionError("a gather_run_max launch of the CITADEL path left the bulk-copy route")
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
            block = index.buckets[bsize]["shards"][0]["vecs"][slot].float().cpu().numpy()
            docs = docs_of[bsize][slot]
            live = docs >= 0
            s, d = (block @ q)[live], docs[live]
            first = np.flatnonzero(np.concatenate([[True], d[1:] != d[:-1]]))
            acc[i, d[first]] += np.maximum(np.maximum.reduceat(s, first), 0.0)
    if "cls_repr" in query:
        qc = rounded(query["cls_repr"][rows])
        step, cls = 1 << 20, index.cls[0][: index.num_docs]  # past num_docs: padding
        for lo in range(0, index.num_docs, step):
            acc[:, lo : lo + step] += qc @ cls[lo : lo + step].float().cpu().numpy().T
    return acc


def _citadel_index(dev, n_docs, plan, dim, cls_dim, meshes=(None,)):
    """Phase 13's synthetic index (seed SEED + 10) on ``dev``, laid out once
    for each entry of ``meshes`` (None: one device; else the
    expert-parallel device list) from the same bucket and CLS tensors.
    Returns (the indexes, each bucket's doc ids, the expert count)."""
    import numpy as np
    import torch

    from dpr_scale_tpu_torch.index.inverted_device import DeviceExpertIndex

    rng = np.random.default_rng(SEED + 10)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    indexes = [DeviceExpertIndex(n_docs, torch.bfloat16, dev, mesh) for mesh in meshes]
    docs_of, first = {}, 0
    for bsize, n_exp in plan:
        docs, run_id, run_doc, start_pos, mrl = _synth_bucket(rng, n_exp, bsize, n_docs)
        vecs = (torch.randn(n_exp, bsize, dim, generator=g, device=dev) * 0.3).to(torch.bfloat16)
        vecs[:, int(bsize * 0.7):] = 0  # pad rows score 0, as from_host_index leaves them
        for index in indexes:
            index.add_bucket(bsize, np.arange(first, first + n_exp), vecs, run_id, run_doc,
                             start_pos, mrl)
        docs_of[bsize], first = docs, first + n_exp
        del vecs
    cls = torch.empty(n_docs, cls_dim, dtype=torch.bfloat16, device=dev)
    for lo in range(0, n_docs, 1 << 20):
        rows = min(1 << 20, n_docs - lo)
        cls[lo : lo + rows] = torch.randn(rows, cls_dim, generator=g, device=dev) * 0.3
    for index in indexes:
        index.set_cls(cls)
    return indexes, docs_of, first


def _citadel_queries(n_experts, batch, qtokens, dim, cls_dim):
    """Phase 13's query batch (seed SEED + 11): (with CLS, without)."""
    import numpy as np

    qrng = np.random.default_rng(SEED + 11)
    query = {
        "expert_ids": qrng.integers(0, n_experts, size=(batch, qtokens, 1)).astype(np.int64),
        "expert_weights": qrng.random((batch, qtokens, 1)).astype(np.float32),
        "expert_repr": qrng.normal(size=(batch, qtokens, dim)).astype(np.float32),
        "attention_mask": np.ones((batch, qtokens), np.int64),
        "cls_repr": qrng.normal(size=(batch, cls_dim)).astype(np.float32),
    }
    return query, {k: v for k, v in query.items() if k != "cls_repr"}


def phase_citadel_search(dev, n_docs=CITADEL_DOCS, plan=CITADEL_PLAN, batch=CITADEL_BATCH,
                         qtokens=CITADEL_QTOKENS, dim=CITADEL_DIM, cls_dim=CITADEL_CLS_DIM,
                         reps=5):
    """Phase 13 on ``dev``; the sizes only shrink for a rehearsal on the
    CPU. Returns the gather kernels' launches in the timed searches (the
    fused scorer's; the serial and streamed kernels' must stay 0), the
    per-search numbers and the fused scorer's inputs of one CLS search
    ((parts, table) a call)."""
    from unittest import mock

    import numpy as np
    import torch

    from dpr_scale_tpu_torch.index import inverted_device
    from dpr_scale_tpu_torch.ops import gather_score as gs

    t0 = time.perf_counter()
    (index,), docs_of, first = _citadel_index(dev, n_docs, plan, dim, cls_dim)
    postings = sum(b * n for b, n in plan)
    nbytes = sum(s["vecs"].numel() * 2 for b in index.buckets.values() for s in b["shards"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"citadel index built on {dev} in {time.perf_counter() - t0:.2f} s: {first} experts, "
          f"{postings} padded postings, D={dim} bf16 ({nbytes / 1e9:.3f} GB), CLS plane "
          f"({n_docs}, {cls_dim}) bf16 ({index.cls[0].numel() * 2 / 1e9:.3f} GB), {n_docs} docs; "
          "max run lengths " + str({b: v["max_run_len"] for b, v in index.buckets.items()}))

    query, no_cls = _citadel_queries(first, batch, qtokens, dim, cls_dim)
    cuda = dev.type == "cuda"
    counters = (gs.gather_run_max_kernel, gs.gather_score_serial_kernel,
                gs.gather_score_streamed_kernel)

    def counts():
        return {"gather_run_max": counters[0].launches, "gather_score_serial": counters[1].launches,
                "gather_score_streamed": counters[2].launches}

    # the median host ms of each kind of search, the counts set to 0 just
    # before and read just after
    for k in counters:
        k.launches = 0
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
    launches = counts()
    searches = 2 * (reps + 1)
    print(f"citadel search launches over {searches} searches: {launches}")
    if cuda and (launches["gather_run_max"] != searches or launches["gather_score_serial"]
                 or launches["gather_score_streamed"]):
        raise AssertionError(f"the searches did not launch gather_run_max once each, and only "
                             f"it: {launches}")

    # one more search of each kind, recording the fused scorer's inputs,
    # against the plain scorers on the same device and the numpy oracle;
    # then one CLS search with every bucket streamed, recorded
    captured, streamed_capture = [], []
    fused = gs.gather_run_max

    def recorder(into):
        def record(parts, table):
            into.append(([p._replace(q=p.q.clone(), qrows=p.qrows.clone()) for p in parts],
                         table.clone()))
            return fused(parts, table)
        return record

    oracle_rows = list(range(CITADEL_ORACLE_QUERIES))
    t0 = time.perf_counter()
    for tag, q in (("with CLS", query), ("without CLS", no_cls)):
        if tag == "with CLS":
            with mock.patch.object(gs, "gather_run_max", recorder(captured)):
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
    inverted_device.STREAM_MODE = "on"
    try:
        with mock.patch.object(gs, "gather_run_max", recorder(streamed_capture)):
            index.search(query, 100)
    finally:
        inverted_device.STREAM_MODE = "auto"
    if cuda:
        held = check_run_max(captured + streamed_capture)
        print(f"gather_run_max triples equal the per-bucket route's bit for bit on {held} buckets "
              "(one CLS search, and one with every bucket streamed)")
        from dpr_scale_tpu_torch.index.inverted_device import TILE, _tiled_topk
        from dpr_scale_tpu_torch.tools.profile_serve import report

        for tag, q in (("with CLS", query), ("without CLS", no_cls)):
            report(f"citadel search {tag}, B={batch}", lambda: index.search(q, 100), dev, None)
        # the dense combine's tiled top-k against torch.topk on its
        # accumulator of CLS scores (the columns past num_docs at -inf)
        q = torch.from_numpy(query["cls_repr"]).to(dev, index.dtype)
        acc = index._cls_scores(q, index.cls[0])
        acc[:, n_docs:] = float("-inf")
        blocks = [acc.view(batch, -1, TILE)]
        same = torch.equal(_tiled_topk(blocks, 100, dev)[0], torch.topk(acc, 100, dim=1).values)
        tiled_ms = cuda_ms(lambda: _tiled_topk(blocks, 100, dev))
        topk_ms = cuda_ms(lambda: torch.topk(acc, 100, dim=1))
        print(f"top-100 of the ({batch}, {n_docs}) fp32 accumulator: tiled {tiled_ms:.3f} ms, "
              f"torch.topk {topk_ms:.3f} ms; the same values: {same}")
        del acc
        if not same:
            raise AssertionError("the tiled top-k disagrees with torch.topk")
    print(f"citadel search launches: {launches}")
    if launches["gather_run_max"] < 1:
        raise AssertionError(f"the gather_run_max kernel never launched: {launches}")
    return launches, stats, captured


def _chain_inputs(parts, table):
    """The per-bucket route's inputs for a fused call's parts: (bucket,
    scorer, slots, q, rows, streamed pieces) each, on the parts' device."""
    import torch

    from dpr_scale_tpu_torch.ops import gather_score as gs

    out = []
    for part in parts:
        slots = gs._part_slots(part, table).to(torch.int32)
        pieces = None
        if part.scorer == "streamed":
            pieces = torch.from_numpy(gs.stream_pieces(slots.cpu().numpy())).to(slots.device)
        out.append((part.bucket, part.scorer, slots, part.q, part.qrows, pieces))
    return out


def _per_bucket_chain(inputs):
    """The per-bucket route on ``_chain_inputs``: each bucket's serial or
    streamed scorer, then the eager epilogue; the triples, in order."""
    import torch

    from dpr_scale_tpu_torch.ops import gather_score as gs

    out = []
    for bucket, scorer, slots, q, qrows, pieces in inputs:
        if scorer == "streamed":
            scores = gs.gather_score_streamed(bucket["vecs"], q, slots, pieces)
        else:
            scores = gs.gather_score_serial(bucket["vecs"], slots, q)
        out.append(gs.run_max_epilogue(bucket, slots, scores, qrows))
    return tuple(torch.cat([o[j] for o in out]) for j in range(3))


def check_run_max(captured):
    """Every bucket of each captured gather_run_max call: its triples equal
    the per-bucket route's (serial or streamed kernel, then the eager
    suffix max) bit for bit, and the plain version's vals within
    CITADEL_TOL of their max. Returns the buckets checked."""
    import torch

    from dpr_scale_tpu_torch.ops import gather_score as gs

    held = 0
    for parts, table in captured:
        got = gs.gather_run_max_kernel(parts, table)
        want = _per_bucket_chain(_chain_inputs(parts, table))
        plain = gs.gather_run_max_plain(parts, table)
        lo = 0
        for part in parts:
            hi = lo + part.q.shape[0] * part.bucket["run_doc"].shape[1]
            for j, name in enumerate(("rows", "docs", "vals")):
                if not torch.equal(got[j][lo:hi], want[j][lo:hi]):
                    raise AssertionError(f"gather_run_max bucket L={part.bucket['vecs'].shape[1]} "
                                         f"({part.scorer}): {name} differ from the per-bucket route")
            held += 1
            lo = hi
        err = (got[2] - plain[2]).abs().max().item()
        if err > CITADEL_TOL * plain[2].abs().max().item():
            raise AssertionError(f"gather_run_max vs plain: max |err| {err:.3g}")
    return held


def _run_max_bound(parts, table):
    """(bytes, flops) of one gather_run_max call: each distinct posting
    block and its run ids and run docs read once, the query rows, batch
    rows and piece table read once, the (row, doc, value) triples written
    once; E * L * D fp32 multiply-adds on the CUDA cores."""
    import torch

    from dpr_scale_tpu_torch.ops import gather_score as gs

    nbytes, flops = table.numel() * 4, 0
    for part in parts:
        v = part.bucket["vecs"]
        n_exp, L, D = v.shape
        E, R = part.q.shape[0], part.bucket["run_doc"].shape[1]
        slots = gs._part_slots(part, table)
        blocks = int(torch.unique(slots[slots < n_exp]).numel())
        nbytes += blocks * (L * (D * v.element_size() + 4) + R * 8)
        nbytes += E * (D * v.element_size() + 4) + E * R * (4 + 8 + 8)
        flops += 2 * E * L * D
    return nbytes, flops


def citadel_kernel_entries(captured):
    """The gather kernels' JSON entries on the fused scorer's calls of one
    CLS search (``captured``: (parts, table) a call, one a shard; their
    sums): gather_run_max's device time (``device_ms``, and ``single_ms``
    with its host launch cost), the per-bucket route's (scorer + eager
    epilogue, CUDA events around the whole chain), the plain version's,
    the bound and the gather + bmm yardstick; then the three per-bucket
    scorers on each bucket (the streamed kernel takes each bucket's
    entries sorted by slot), the pipelined kernel held to the serial
    kernel's bits."""
    import torch

    from dpr_scale_tpu_torch.ops import gather_score as gs

    kernels = _gather_kernels()
    total = {n: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0} for n in kernels}
    fused = {"ms": 0.0, "single_ms": 0.0, "plain_ms": 0.0, "per_bucket_ms": 0.0,
             "per_bucket_single_ms": 0.0, "max_abs_err": 0.0}
    nb = flops = yard = rm_bytes = rm_flops = 0.0
    n_buckets = 0
    for parts, table in captured:
        chain = _chain_inputs(parts, table)
        want = gs.gather_run_max_plain(parts, table)
        got = gs.gather_run_max_kernel(parts, table)
        fused["max_abs_err"] = max(fused["max_abs_err"], (got[2] - want[2]).abs().max().item())
        fused["ms"] += device_ms(lambda: gs.gather_run_max_kernel(parts, table))
        fused["single_ms"] += cuda_ms(lambda: gs.gather_run_max_kernel(parts, table))
        fused["plain_ms"] += device_ms(lambda: gs.gather_run_max_plain(parts, table), calls=5)
        fused["per_bucket_ms"] += device_ms(lambda: _per_bucket_chain(chain), calls=5)
        fused["per_bucket_single_ms"] += cuda_ms(lambda: _per_bucket_chain(chain))
        b = _run_max_bound(parts, table)
        rm_bytes, rm_flops = rm_bytes + b[0], rm_flops + b[1]
        for v, s, q in ((p.bucket["vecs"], c[2], p.q) for p, c in zip(parts, chain)):
            n_buckets += 1
            order = torch.argsort(s, stable=True)
            s_sorted, q_sorted = s[order].contiguous(), q[order].contiguous()
            pieces = torch.from_numpy(gs.stream_pieces(s_sorted.cpu().numpy())).to(v.device)
            ref = gs.gather_score_plain(v, s, q)
            plain_ms = device_ms(lambda: gs.gather_score_plain(v, s, q), calls=5)
            if not torch.equal(kernels["gather_score_pipelined"](v, s, q),
                               kernels["gather_score_serial"](v, s, q)):
                raise AssertionError(f"bucket L={v.shape[1]}: pipelined gives other bits than "
                                     "serial")
            line = []
            for name, fn in kernels.items():
                if name == "gather_score_streamed":
                    args, r = (v, s_sorted, q_sorted, pieces), ref[order]
                else:
                    args, r = (v, s, q), ref
                err = (fn(*args) - r).abs().max().item()
                ms = device_ms(lambda: fn(*args))
                total[name]["ms"] += ms
                total[name]["plain_ms"] += plain_ms
                total[name]["max_abs_err"] = max(total[name]["max_abs_err"], err)
                line.append(f"{name[13:]} {ms:.4f} ms")
            bb = _gather_bound(v, s, q)
            nb, flops = nb + bb[0], flops + bb[1]
            y = device_ms(lambda: _yardstick(v, s, q))
            yard += y
            print(f"bucket L={v.shape[1]} ({v.shape[0]} experts) E={s.shape[0]}: "
                  + ", ".join(line) + f", plain {plain_ms:.4f} ms, gather+bmm {y:.4f} ms, bound "
                  f"{bound(*bb, FP32_FLOPS)[0]:.4f} ms; pipelined == serial bits")
    b_ms, b_by = bound(nb, flops, FP32_FLOPS)
    for name, t in total.items():
        t.update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"{name} over the {n_buckets} buckets of one B={CITADEL_BATCH} search: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, gather+bmm yardstick {yard:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}) = {b_ms / t['ms']:.1%} of the kernel's time; no "
              "single PyTorch call computes it")
    rb_ms, rb_by = bound(rm_bytes, rm_flops, FP32_FLOPS)
    fused.update(bound_ms=rb_ms, bound_by=rb_by, library_ms=None, yardstick_ms=yard)
    print(f"gather_run_max over the {n_buckets} buckets of one B={CITADEL_BATCH} search in "
          f"{len(captured)} launches: kernel {fused['ms']:.4f} ms queued, {fused['single_ms']:.4f} "
          f"ms single; the per-bucket route (scorer + eager suffix max) {fused['per_bucket_ms']:.4f} "
          f"ms queued, {fused['per_bucket_single_ms']:.4f} ms single; plain {fused['plain_ms']:.4f} "
          f"ms; gather+bmm yardstick {yard:.4f} ms; bound {rb_ms:.4f} ms ({rb_by}: "
          f"{rm_bytes:.0f} bytes) = {rb_ms / fused['ms']:.1%} of the kernel's time; no single "
          "PyTorch call computes it")
    total["gather_run_max"] = fused
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

    def yard_topk(q, corpus, n_valid, kc):  # ROADMAP B1 step 1: the bf16 GEMM + chunked top-k
        return mk.merge_chunk_topk(((lo, lo + s.shape[1], s) for lo, s in _yard_scores(q, corpus)),
                                   n_valid, kc)

    return {
        "count_above": (mk.count_above_kernel, mk.count_above_plain, yard_count),
        "groupmax": (mk.groupmax_kernel, mk.groupmax_plain, yard_groupmax),
        "tile_max_scores": (mk.tile_max_scores_kernel, mk.tile_max_scores_plain, yard_tile_max),
        "topk_candidates": (mk.topk_candidates_kernel, mk.topk_candidates_plain, yard_topk),
    }


def _topk_split(q, corpus, n_valid, kc):
    """{step: (ms queued, ms single)} of topk_candidates' steps on the card
    (device_ms, cuda_ms): the tile maxima and the threshold (torch.topk over
    them; absent where fewer than kc tiles are whole), the emit sweep (its
    entry point: the count memset and the sweep, launched here, so not
    counted on the wrapper) and the aggregation (torch.topk over the keys
    and their decode)."""
    import torch

    from dpr_scale_tpu_torch.ops import cuda_lib
    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    qd = q.to(corpus.dtype).contiguous()
    B, D = qd.shape
    tile = mk.topk_tile_rows(n_valid, kc)
    ntiles, steps = n_valid // tile, {}
    if ntiles >= kc:
        rows = corpus[: ntiles * tile]
        maxima = mk.tile_max_scores_kernel(qd, rows, tile)
        steps["tile_max"] = lambda: mk.tile_max_scores_kernel(qd, rows, tile)
        steps["threshold"] = lambda: torch.topk(maxima, kc, dim=1).values[:, kc - 1].contiguous()
        theta, cap = steps["threshold"](), mk.TOPK_CAP * kc
    else:
        theta, cap = torch.full((B,), float("-inf"), device=q.device), max(n_valid, kc)
    count = torch.empty((B,), dtype=torch.int32, device=q.device)
    keys = torch.full((B, cap), mk._KEY_EMPTY, dtype=torch.int64, device=q.device)
    lib = cuda_lib.library()

    def emit():
        cuda_lib.check(lib.dst_topk_emit(
            qd.data_ptr(), corpus.data_ptr(), theta.data_ptr(), count.data_ptr(), keys.data_ptr(),
            B, corpus.shape[0], n_valid, D, cap, B, mk._KERNEL_DTYPES[corpus.dtype],
            torch.cuda.current_stream().cuda_stream),
            "topk emit")

    steps["emit"] = emit
    emit()
    steps["aggregate"] = lambda: mk._decode_keys(torch.topk(keys, kc, dim=1).values)
    return {name: (device_ms(fn, calls=10), cuda_ms(fn)) for name, fn in steps.items()}


TOPK_KC = 128  # topk_candidates' depth in phases 14, 21, 22: the fused search's kc


def _check_topk(got, want, n_valid, q, corpus):
    """(max |err|, faults, report) of topk_candidates' (scores, rows)
    against plain's one deeper: scores within MAX_REL of max |ref|, and of
    the fp32 sums of their rows' products; the same row sets where plain's
    kc-th and (kc+1)-th scores are clear of each other; everywhere, each
    side's rows clear above its kc-th in the other's set; no pad row."""
    import torch

    rows = got[1].clamp(0, corpus.shape[0] - 1)
    paired = torch.einsum("bd,bkd->bk", q.to(corpus.dtype).float(), corpus[rows].float()).cpu()
    (s, i), (ps, pi) = (tuple(t.cpu() for t in pair) for pair in (got, want))
    kc = s.shape[1]
    tol = MAX_REL * ps[:, 0].abs().max().item()
    err = max((s - ps[:, :kc]).abs().max().item(), (s - paired).abs().max().item())
    clear = (ps[:, kc - 1] - ps[:, kc]) > 2 * tol
    differ = missed = 0
    for b in range(s.shape[0]):
        mine, theirs = set(i[b].tolist()), set(pi[b, :kc].tolist())
        differ += int(bool(clear[b]) and mine != theirs)
        missed += len(set(pi[b, :kc][ps[b, :kc] > ps[b, kc - 1] + tol].tolist()) - mine)
        missed += len(set(i[b][s[b] > s[b, -1] + tol].tolist()) - theirs)
    pads = int(((i >= n_valid) | (i < 0)).sum())
    bad = int(err > tol) + differ + missed + pads
    line = (f"max_abs_err {err:.3g} of max |ref| {tol / MAX_REL:.3g}; {int(clear.sum())} of "
            f"{s.shape[0]} queries clear at the kc-th, {differ} of them with other rows; "
            f"{missed} rows clear above the kc-th missing; {pads} pad rows")
    return err, bad, line


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


def phase_mips_kernels(dev, cases=MIPS_CASES, plain_reps=5):
    """Phase 14: count_above, groupmax, tile_max_scores and topk_candidates
    (kc = TOPK_KC, the rows past N - 77 pads) against their plain versions
    on ``dev`` for each case; the timed cases also time
    kernel, plain version and yardstick (each the median of ``plain_reps``
    calls). Returns each kernel's JSON entry
    from the first timed case (times absent if none ran), max |err| over all
    cases."""
    import torch

    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    kernels = _mips_kernels()
    entries = {n: {"max_abs_err": 0.0} for n in kernels}
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    for case in cases:  # a 7th item: (queries, rows), a path's own vectors
        B, N, D, dtype_name, tile, timed = case[:6]
        dtype = getattr(torch, dtype_name)
        if len(case) > 6:
            q, corpus = case[6][0].float(), case[6][1].to(dtype)
        else:
            corpus = torch.randn(N, D, generator=g, device=dev).to(dtype)
            q = torch.randn(B, D, generator=g, device=dev)
        k = RETRIEVAL_K
        best = _top_scores(q, corpus, k + 1)
        tau = ((best[:, k - 1] + best[:, k]) / 2).contiguous()
        margin = COUNT_MARGIN_REL * tau.abs()
        clear = (best[:, k - 1] - best[:, k]) > 2 * margin  # no score near tau
        del best
        what = f"B={B} N={N} D={D} {dtype_name}"
        n_valid = N - 77  # topk_candidates: a ragged valid span, pad rows past it
        args = {"count_above": (q, corpus, tau), "groupmax": (q, corpus),
                "tile_max_scores": (q, corpus, tile),
                "topk_candidates": (q, corpus, n_valid, TOPK_KC)}
        for name, (kernel, plain, yard) in kernels.items():
            routes = dict(getattr(kernel, "launches_by_route", {}))
            got, again = kernel(*args[name]), kernel(*args[name])
            # topk_candidates: plain one deeper, to see the ties at the kc-th
            want = plain(*args[name]) if name != "topk_candidates" else plain(
                q, corpus, n_valid, TOPK_KC + 1)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if routes:  # the route each shape takes
                routes = {r: n - routes[r] for r, n in kernel.launches_by_route.items()}
                print(f"{name} ({what}): launches by route {routes}")
                if dtype_name == "bfloat16" and D == MIPS_DIM and (
                        routes["wgmma"] < 2 if name == "topk_candidates" else routes["wgmma"] != 2):
                    raise AssertionError(f"{name} ({what}) did not run the wgmma kernel")
            got, again, want = (x if isinstance(x, tuple) else (x,) for x in (got, again, want))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} ({what}): repeated calls give other bits")
            if name == "topk_candidates":
                err, bad, line = _check_topk(got, want, n_valid, q, corpus)
            elif name == "count_above":
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
                             "tile_max_scores": 4 * B * (N // tile),
                             "topk_candidates": 12 * B * TOPK_KC}[name]
                b_ms, b_by = bound(nbytes(q, corpus) + out_bytes, 2 * B * N * D)
                ms = cuda_ms(lambda: kernel(*args[name]))
                plain_ms = cuda_ms(lambda: plain(*args[name]), reps=plain_reps, warmup=1)
                yard_ms = cuda_ms(lambda: yard(*args[name]), reps=plain_reps, warmup=1)
                timing = {"ms": ms}
                if name == "topk_candidates":  # a whole call syncs once: single calls, and
                    # each step queued
                    split = _topk_split(q, corpus, n_valid, TOPK_KC)
                    timing["queued_ms"] = sum(queued for queued, _single in split.values())
                    timing["split_ms"] = {k: {"queued": a, "single": b}
                                          for k, (a, b) in split.items()}
                    timing["yardstick_ms"] = yard_ms
                    print(f"{name} ({what}): kernel {ms:.4f} ms a call (its one sync included), "
                          f"steps queued {timing['queued_ms']:.4f} ms = {b_ms / timing['queued_ms']:.1%} "
                          f"of its bound: " + ", ".join(f"{k} {a:.4f} ({b:.4f} single)"
                                                        for k, (a, b) in split.items()))
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
              "groupmax": mips_kernels.groupmax_kernel,
              "tile_max_scores": mips_kernels.tile_max_scores_kernel}
    topk = mips_kernels.topk_candidates_kernel  # pass 1 of fused, auto, approx, exact_sort
    for kernel in sweeps.values():
        kernel.launches = 0
        kernel.launches_by_route = dict.fromkeys(mips_kernels.ROUTES, 0)
    topk.launches = 0
    # the script's totals stay (main's check): this phase reads their growth
    routes0, over0 = dict(topk.launches_by_route), topk.overflow_reruns
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
    launches["topk_candidates"] = topk.launches
    pass1 = {r: n - routes0[r] for r, n in topk.launches_by_route.items()}
    pass1_reruns = topk.overflow_reruns - over0

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
    print(f"pass 1 (topk_candidates) over the CLI runs and retrieve(): launches by route {pass1}, "
          f"{pass1_reruns} queries swept again for overflow")
    if pass1["score_tile"] or pass1["wgmma_cp_async"] or not pass1["wgmma"]:
        raise AssertionError(f"a pass 1 of the retrieval path left the kernel route: {pass1}")

    # ---- benchmark(): the methods over the 2,097,152-row block ----
    blk, n_valid, _off = max(index._blocks, key=lambda b: b[0].shape[0])
    bench = MipsIndex(dev)
    bench.add(blk[:n_valid])
    del index, blk
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    qb = q_emb[: n_queries // QUERY_BATCH * QUERY_BATCH].reshape(-1, QUERY_BATCH, q_emb.shape[1])
    qb = np.concatenate([qb] * max(1, bench_iters // len(qb)))
    for method in ("groupmax",):  # the pass-1 methods: pass1_ab
        bench.method = method
        stats = bench.benchmark(qb, RETRIEVAL_K)
        print(f"benchmark {method} over {bench._blocks[0][0].shape[0]} rows ({n_valid} valid), "
              f"B={QUERY_BATCH} k={RETRIEVAL_K}: {stats}")
    pass1_ab(bench, qb)
    pass1_fallback_causes(bench, torch.from_numpy(qb[0]).to(dev))
    pass1_bits(bench, torch.from_numpy(qb[0]).to(dev))
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
    print(f"launches by route over the phase (CLI runs, retrieve(), benchmark, profile): {routes}; "
          f"pass 1 {({r: n - routes0[r] for r, n in topk.launches_by_route.items()})}, "
          f"{topk.overflow_reruns - over0} overflow reruns")
    if any(r["score_tile"] or r["wgmma_cp_async"] or not r["wgmma"] for r in routes.values()):
        raise AssertionError(f"a sweep of the retrieval path did not take the TMA-fed wgmma "
                             f"kernel: {routes}")
    return launches


def plain_pass1(index):
    """A shallow copy of ``index`` whose pass 1 on dense blocks is
    ``topk_candidates_plain`` on the card (the port before the kernel: a
    reference independent of it, whose calls no kernel counter sees); it
    shares the blocks, the rest is the index's own code."""
    import torch

    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    class PlainPass1(type(index)):
        def _topk_rows(self, q, emb, k, n_valid):
            if isinstance(emb, torch.Tensor):
                return mk.topk_candidates_plain(q.to(self.dtype), emb, n_valid, k)
            return super()._topk_rows(q, emb, k, n_valid)

    copy = object.__new__(PlainPass1)
    copy.__dict__.update(index.__dict__)
    return copy


def pass1_ab(bench, qb):
    """``MipsIndex.benchmark`` of the pass-1 methods with pass 1 on the
    kernel, then on the plain version (``plain_pass1``), in one process:
    q/s and fallback queries."""
    for route, index in (("kernel", bench), ("plain", plain_pass1(bench))):
        for method in ("fused", "auto", "exact_sort"):
            index.method = method
            stats = index.benchmark(qb, RETRIEVAL_K)
            print(f"pass-1 A/B, {route} route: benchmark {method} B={qb.shape[1]} "
                  f"k={RETRIEVAL_K}: {stats['qps']:.1f} q/s, {stats['fallback_queries']} of "
                  f"{qb.shape[0] * qb.shape[1]} queries to the exact fallback; {stats}")


def pass1_fallback_causes(bench, q):
    """Where ``fused``'s exact fallbacks come from, for one batch on each
    pass-1 route: the verification's failures; per query the candidates in
    the margin band (tau, tau + COUNT_MARGIN_REL |tau|], which pass 2
    counts and the verification does not credit, and the groups they leave
    discrepant (more than RESCUE_GROUPS fail the query); pass 2's count
    above tau less pass 1's own; and how far the kernel's sums lie below
    fp32 sums of the same products (bmm) on its candidates."""
    import torch

    from dpr_scale_tpu_torch.index import mips
    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    rows, n_valid, _off = bench._blocks[0]
    qd, k, group = q.to(rows.dtype), RETRIEVAL_K, mips.GROUP_ROWS
    for route, index in (("kernel", bench), ("plain", plain_pass1(bench))):
        s, i = index._candidates(qd, rows, mips.FUSED_KC, n_valid)
        fails = int(index._fused_search(rows, q, k, n_valid)[2].sum())
        tau = s[:, k - 1]
        tau_hi = tau + mips.COUNT_MARGIN_REL * tau.abs()
        cnt = mk.count_above_groups(qd, rows, tau, group)
        cnt = cnt - torch.where(tau[:, None] < 0, (rows.shape[0] - n_valid) // group, 0)
        found = torch.zeros_like(cnt).scatter_add_(1, i.clamp_min(0) // group,
                                                   (s > tau_hi[:, None]).to(cnt.dtype))
        groups = ((cnt - found) > 0).sum(dim=1)
        band = ((s > tau[:, None]) & (s <= tau_hi[:, None])).sum(dim=1).float()
        extra = (cnt.sum(dim=1) - (s > tau[:, None]).sum(dim=1)).float()
        print(f"fused's fallbacks, {route} route, B={q.shape[0]}: {fails} queries fail the "
              f"verification; candidates in the margin band a query: mean {band.mean():.2f}, "
              f"max {int(band.max())}; discrepant groups a query: mean "
              f"{groups.float().mean():.2f}, {int((groups > mips.RESCUE_GROUPS).sum())} queries "
              f"over RESCUE_GROUPS = {mips.RESCUE_GROUPS}; pass 2's count above tau less pass "
              f"1's: mean {extra.mean():.3f}, min {int(extra.min())}, max {int(extra.max())}")
        if route == "kernel":
            exact = torch.einsum("bd,bkd->bk", qd.float(), rows[i].float())
            drift = ((exact - s) / s.abs()).flatten()
            print(f"the kernel's candidate scores below fp32 bmm sums of the same products, "
                  f"relative: mean {drift.mean():.3g}, median {drift.median():.3g}, min "
                  f"{drift.min():.3g}, max {drift.max():.3g}; the margin {mips.COUNT_MARGIN_REL}")


def pass1_bits(bench, q):
    """Pass 1's candidate scores are pass 2's bits on the benchmark block:
    count_above_groups at the j-th candidate's score (pad rows subtracted
    where it is negative) counts exactly the candidates above it."""
    import torch

    from dpr_scale_tpu_torch.index.mips import FUSED_KC, GROUP_ROWS
    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    rows, n_valid, _off = bench._blocks[0]
    qd = q.to(rows.dtype)
    s, _i = mk.topk_candidates(qd, rows, n_valid, FUSED_KC)
    wrong = {}
    for j in (0, 1, RETRIEVAL_K - 1, FUSED_KC - 1):
        tau = s[:, j].contiguous()
        cnt = mk.count_above_groups(qd, rows, tau, GROUP_ROWS).sum(dim=1)
        cnt = cnt - torch.where(tau < 0, rows.shape[0] - n_valid, 0)
        wrong[j] = int((cnt != (s > s[:, j : j + 1]).sum(dim=1)).sum())
    print(f"pass 1 vs pass 2 bits, B={q.shape[0]} over {rows.shape[0]} rows ({n_valid} valid): "
          f"queries whose count at the j-th candidate is not the candidates above it {wrong}")
    if any(wrong.values()):
        raise AssertionError(f"pass 1's scores are not pass 2's bits: {wrong}")


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
        if name in ("int_groupmax", "int8_tile_max"):  # redesigned: queued calls too, as the FFN's
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
            routes = dict(getattr(ik.int8_tile_max_kernel, "launches_by_route", {}))
            got, again = ik.int8_tile_max_kernel(q8, x8, n_tile), ik.int8_tile_max_kernel(q8, x8, n_tile)
            if routes:  # the route each shape takes
                routes = {r: n - routes[r]
                          for r, n in ik.int8_tile_max_kernel.launches_by_route.items()}
                print(f"int8_tile_max (B={B} N={N} D={D} tile={n_tile}): launches by route "
                      f"{routes}")
                if D == MIPS_DIM and n_tile == tile and routes["wgmma"] != 2:
                    raise AssertionError(f"int8_tile_max (B={B} D={D} tile={n_tile}) did not run "
                                         "the wgmma kernel")
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
        print(sweep_build_report(
            "int8_tile_max_wgmma_kernel", "int8_tile_max wgmma",
            lambda lib: {f"B={B}": lib.dst_int8_tile_max_smem(B) for B in (512, 64)}))
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

    # the reference: fp32 rows, pass 1 the plain version
    exact = plain_pass1(build_index(embs, dev, dtype=torch.float32, method="exact_sort"))
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



# phase 18 (phase_checkpoint): S steps at TRAIN_BATCH with a save every S/4
# (save_top_k 1, async saves), unbroken and broken at S/2 then --resume to S.
# On the card the embedding backward's atomics make steps not bit
# reproducible, so the resumed losses may drift from the unbroken run's:
# within RESUME_LOSS_REL of them (the restored state itself must equal the
# saved one bit for bit). Data the model can learn: each of CKPT_PASSAGES
# passages holds a key pair (one word shared with its sibling, its hard
# negative, one its own) among CKPT_FILLER_WORDS common words; its question
# holds the pair. The trained encoder's recall@RECALL_K over CKPT_QUESTIONS
# held-out questions (new filler, same pairs) must beat the seeded encoder's
# by RECALL_MARGIN. An export that was not loaded gains 0; the tiny-width
# CPU rehearsal (tests/test_torch_chip_smoke.py) gains about 0.7; bert_base
# from seed 0 gains 0.10-0.11 on an H100, so the margin is half that. The
# gain is the best step's (10): at conf/nq.yaml's softmax temperature 1 the
# random encoder's scores spread over tens of nats (a loss of ~28 at step
# 1), and after step 10 the run diverges (the validation MRR falls to ~0.2,
# the loss stays above ln 256), on the plain autograd path as through the
# kernels; larger rates collapse sooner, and at temperature 20 the same run
# learns to the end (tools/keyed_train.py; PERF.md, PR 13).
CKPT_STEPS = 48
CKPT_PASSAGES = 640  # 5 steps an epoch at batch 128: S/2 stops in epoch 5
CKPT_QUESTIONS = 256
CKPT_FILLER_WORDS = 1000
CKPT_PASSAGE_FILLER, CKPT_QUESTION_FILLER = 8, 2  # filler words around the key pair
CKPT_LR, CKPT_WARMUP = 1e-5, 4  # overrides of conf/nq.yaml's 2e-5 / 1,237
RESUME_LOSS_REL = 2e-2
RECALL_K, RECALL_MARGIN = 10, 0.05


def write_keyed_data(work, n_passages, n_questions, n_val):
    """Phase 18's data under ``work`` (learnable, unlike write_dpr_jsonl's
    random words), from seed SEED + 31: a tokenizer of bert_base's vocab
    size (tok/), passages.tsv, train.jsonl (one row a passage, its sibling
    as the hard negative), val.jsonl (``n_val`` rows) and questions.csv
    (held-out questions: new filler words around the same key pairs; the
    answer is the passage's own key word). Returns (the tokenizer's
    directory, the positive passage id of each held-out question)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 31)
    vocab = np.array([f"w{i}" for i in range(30522 - 5)])
    tok_dir = os.path.join(work, "tok")
    write_tokenizer(tok_dir, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + vocab.tolist())
    words = rng.permutation(vocab)
    filler = words[:CKPT_FILLER_WORDS]
    shared = words[CKPT_FILLER_WORDS:CKPT_FILLER_WORDS + n_passages // 2]
    own = words[CKPT_FILLER_WORDS + n_passages // 2:][:n_passages]
    pair = lambda i: [shared[i // 2], own[i]]
    passages = []
    for i in range(n_passages):
        text = list(rng.choice(filler, size=CKPT_PASSAGE_FILLER)) + pair(i)
        rng.shuffle(text)
        passages.append({"title": " ".join(rng.choice(filler, size=2)), "text": " ".join(text)})
    with open(os.path.join(work, "passages.tsv"), "w") as f:
        f.write("id\ttext\ttitle\n")
        f.writelines(f"{i}\t{p['text']}\t{p['title']}\n" for i, p in enumerate(passages))

    def question(i):
        q = list(rng.choice(filler, size=CKPT_QUESTION_FILLER)) + pair(i)
        rng.shuffle(q)
        return " ".join(q)

    def rows(path, ids):
        with open(path, "w") as f:
            f.writelines(json.dumps({"question": question(i), "positive_ctxs": [passages[i]],
                                     "hard_negative_ctxs": [passages[i ^ 1]]}) + "\n" for i in ids)

    rows(os.path.join(work, "train.jsonl"), range(n_passages))
    rows(os.path.join(work, "val.jsonl"), rng.choice(n_passages, size=n_val, replace=False))
    gold = rng.choice(n_passages, size=n_questions, replace=False)
    with open(os.path.join(work, "questions.csv"), "w") as f:
        f.writelines(f"{question(i)}\t{[str(own[i])]}\n" for i in gold)
    return tok_dir, [str(i) for i in gold]


def recall_of_run(path, gold, k):
    """(recall@k, MRR@100) of a DPR JSON run against each question's gold
    passage id."""
    with open(path) as f:
        ranked = [[c["id"] for c in row["ctxs"]] for row in json.load(f)]
    ranks = [r.index(g) if g in r else None for r, g in zip(ranked, gold)]
    recall = sum(r is not None and r < k for r in ranks) / len(gold)
    return recall, sum(1 / (r + 1) for r in ranks if r is not None) / len(gold)


def _host_copy(sd):
    return {k: ({n: t.detach().cpu().clone() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in sd.items()}


def _same_state(got, want):
    """Checkpoint state dicts equal key for key: tensors bit for bit (dtype
    and values, compared on the host), the ints equal."""
    import torch

    bad = []
    for key, value in want.items():
        if not isinstance(value, dict):
            bad += [] if got[key] == value else [key]
        elif set(got[key]) != set(value):
            bad.append(f"{key}: names")
        else:
            bad += [f"{key}/{n}" for n, t in value.items()
                    if got[key][n].dtype != t.dtype or not torch.equal(got[key][n].cpu(), t)]
    if bad or set(got) != set(want):
        raise AssertionError(f"restored state differs from the saved one: {bad[:8]}")


def phase_checkpoint(work, dev, batch_size=TRAIN_BATCH, steps=CKPT_STEPS,
                     n_passages=CKPT_PASSAGES, n_questions=CKPT_QUESTIONS, extra=()):
    """Phase 18, the checkpoint slice on ``dev``: ``cli.train`` on
    conf/nq.yaml for ``steps`` steps unbroken, then the same run killed after
    its save at steps/2 and resumed with ``--resume`` (same steps, LRs and
    batches; losses within RESUME_LOSS_REL; the restored state the saved one
    bit for bit); the best params exported, ``cli.generate_embeddings`` and
    ``cli.run_retrieval`` (fused, top-100) on ``task.checkpoint_path``, the
    same ids as the best model in memory, recall@RECALL_K above the seeded
    encoder's by RECALL_MARGIN. ``batch_size``/``steps``/``n_passages``/
    ``n_questions``/``extra`` only shrink it for a rehearsal on the CPU.
    Returns the kernels' launch counts."""
    import hashlib

    import torch

    from dpr_scale_tpu_torch.cli import generate_embeddings, run_retrieval, train
    from dpr_scale_tpu_torch.cli.common import build_model_config, build_optimizer, build_task
    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.models.encoder import BiEncoder
    from dpr_scale_tpu_torch.ops import attention, mips_kernels
    from dpr_scale_tpu_torch.train import checkpoint
    from dpr_scale_tpu_torch.train.task import DenseRetrieverTask

    tok_dir, gold = write_keyed_data(work, n_passages, n_questions, batch_size)
    cfg_path = os.path.join(ROOT, "conf", "nq.yaml")
    half = steps // 2
    train_args = [
        f"task.transform.model_path={tok_dir}", f"datamodule.train_path={work}/train.jsonl",
        f"datamodule.val_path={work}/val.jsonl", f"datamodule.test_path={work}/val.jsonl",
        "datamodule.num_val_negative=1", "datamodule.num_test_negative=1",
        f"datamodule.batch_size={batch_size}", "trainer.log_every=1",
        "checkpoint_callback.save_top_k=1", "checkpoint_callback.async_save=true",
        f"trainer.max_steps={steps}", f"trainer.eval_every_steps={steps // 4}",
        f"task.optim.lr={CKPT_LR}", f"task.warmup_steps={CKPT_WARMUP}", *extra]

    seen = {"batches": {}, "params": {}, "save_ms": []}

    class Probe(checkpoint.CheckpointManager):
        """The CLI's manager, timed; in the broken run it keeps each saved
        step's params in host memory and ends the run after the save at
        ``half``, keeping the saved state to compare with the restore."""
        kill = False

        def save(self, step, state, metrics=None):
            t0 = time.perf_counter()
            super().save(step, state, metrics)
            seen["save_ms"].append((time.perf_counter() - t0) * 1e3)
            if self.kill:
                seen["params"][step] = _host_copy(state.state_dict())["params"]
                if step == half and "saved" not in seen:
                    seen["saved"] = _host_copy(state.state_dict())
                    self.wait()
                    raise KeyboardInterrupt  # a kill after the save has landed

        def restore_last(self, state_like=None):
            t0 = time.perf_counter()
            out = super().restore_last(state_like)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seen["resume_restore_ms"] = (time.perf_counter() - t0) * 1e3
            _same_state(out.state_dict(), seen["saved"])
            return out

    real_step = DenseRetrieverTask.train_step

    def recording(self, state, batch, *args):
        h = hashlib.sha1()
        for key in ("query_ids", "contexts_ids", "pos_ctx_indices"):
            h.update(batch[key].cpu().numpy().tobytes())
        seen["batches"].setdefault(seen["run"], {})[state.step] = h.hexdigest()
        return real_step(self, state, batch, *args)

    counters = [(attention.attention_fwd_kernel, "launches"),
                (attention.attention_fwd_kernel, "dropout_launches"),
                (attention.attention_bwd_kernel, "launches"),
                (mips_kernels.count_above_groups_kernel, "launches")]
    for obj, name in counters:
        setattr(obj, name, 0)

    def run(name, ckpt, *args):
        seen["run"] = name
        t0 = time.perf_counter()
        try:
            train.main(["--config", cfg_path, "--device", str(dev), *train_args,
                        f"checkpoint_callback.dirpath={ckpt}",
                        f"trainer.metrics_jsonl={work}/{name}.jsonl", *args])
        except KeyboardInterrupt:
            print(f"checkpoint run {name}: stopped after its save at step {half}")
        wall = time.perf_counter() - t0
        with open(f"{work}/{name}.jsonl") as f:
            lines = [json.loads(l) for l in f]
        seen.setdefault("valid_mrr", {})[name] = [(l["step"], round(l["valid_mrr"], 4))
                                                  for l in lines if "valid_mrr" in l]
        return wall, {l["step"]: l for l in lines if "train_loss" in l}

    train.CheckpointManager, DenseRetrieverTask.train_step = Probe, recording
    try:
        wall_a, log_a = run("unbroken", f"{work}/ckpt_a")
        Probe.kill = True
        wall_b1, _log = run("broken", f"{work}/ckpt_b")
        wall_b2, log_b = run("resumed", f"{work}/ckpt_b", "--resume")
    finally:
        train.CheckpointManager = checkpoint.CheckpointManager
        DenseRetrieverTask.train_step = real_step
    async_ms = statistics.median(seen["save_ms"])
    shutil.rmtree(f"{work}/ckpt_a", ignore_errors=True)

    b = seen["batches"]
    if sorted(b["resumed"]) != list(range(half, steps)) or sorted(log_b) != list(range(half + 1, steps + 1)):
        raise AssertionError(f"resumed steps {sorted(b['resumed'])}, logged {sorted(log_b)}")
    moved = [s for s in b["resumed"] if b["resumed"][s] != b["unbroken"][s]]
    lrs = [s for s in log_b if log_b[s]["lr"] != log_a[s]["lr"]]
    drift = max(abs(log_b[s]["train_loss"] - log_a[s]["train_loss"]) / abs(log_a[s]["train_loss"])
                for s in log_b)
    print(f"unbroken run's losses: steps 1-3 {[round(log_a[s]['train_loss'], 4) for s in (1, 2, 3)]}, "
          f"steps {steps - 2}-{steps} {[round(log_a[s]['train_loss'], 4) for s in range(steps - 2, steps + 1)]}; "
          f"validation MRR by step {seen['valid_mrr']['unbroken']}")
    print(f"resume: steps {half + 1}..{steps} after --resume at step {half} (epoch "
          f"{half // (n_passages // batch_size)}, batch {half % (n_passages // batch_size)}): "
          f"{len(moved)} batches and {len(lrs)} LRs differ from the unbroken run's; losses "
          f"unbroken {[round(log_a[s]['train_loss'], 4) for s in sorted(log_b)]}, resumed "
          f"{[round(log_b[s]['train_loss'], 4) for s in sorted(log_b)]}, max relative drift "
          f"{drift:.2e} (tolerance {RESUME_LOSS_REL}); the restored state equals the saved one "
          f"bit for bit ({len(seen['saved']['params'])} parameters, mu, nu, count, step)")
    if moved or lrs or not drift <= RESUME_LOSS_REL:
        raise AssertionError(f"resumed run differs: batches {moved}, LRs {lrs}, drift {drift}")

    # save / restore of the full state, timed on their own
    cfg = load_config(cfg_path, train_args)
    state = build_task(cfg, build_optimizer(cfg, steps), dev).init_state(0)
    best = checkpoint.CheckpointManager(f"{work}/ckpt_b").best_step()
    t0 = time.perf_counter()
    checkpoint.CheckpointManager(f"{work}/ckpt_b").restore(state)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    _same_state({"params": state.state_dict()["params"]}, {"params": seen["params"][best]})
    # the CLI's save_last: a kept step's file is linked into last/state, a
    # step that does not rank is serialized there
    timing = checkpoint.CheckpointManager(f"{work}/ckpt_sync", save_top_k=1)
    sync_ms = []
    for step, mrr in ((best, 1.0), (best + 1, 1.0), (best + 2, 0.0)):  # the first allocates
        t0 = time.perf_counter()
        timing.save(step, state, {"mrr": mrr})
        sync_ms.append((time.perf_counter() - t0) * 1e3)
        if step == best + 1:
            stat = os.stat(f"{work}/ckpt_sync/{step}/{checkpoint.STATE_FILE}")
            if os.stat(f"{work}/ckpt_sync/last/state/{checkpoint.STATE_FILE}").st_ino != stat.st_ino:
                raise AssertionError("last/state of a kept step is not a link to its file")
    size = stat.st_size
    del state, timing
    shutil.rmtree(f"{work}/ckpt_sync", ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"checkpoint: state.pt {size} bytes ({size / 2**30:.3f} GiB: fp32 params, mu, nu); save "
          f"{sync_ms[0]:.1f} ms synchronous with new host buffers, {sync_ms[1]:.1f} ms with "
          f"reused ones (a kept step, linked into last), {sync_ms[2]:.1f} ms for a step that "
          f"does not rank (last only); {async_ms:.1f} ms blocking with async_save (median of "
          f"{len(seen['save_ms'])} saves in the runs); restore of step {best} into a state on "
          f"{dev} {restore_ms:.1f} ms, --resume's restore_last {seen['resume_restore_ms']:.1f} ms")

    # export -> encode -> retrieve, against the best model in memory and the seed
    export = f"{work}/ckpt_b/params_best"
    model = BiEncoder(build_model_config(cfg), projection_dim=cfg.task.model.get("projection_dim", 0),
                      shared=cfg.task.get("shared_model", True))
    model.load_state_dict(seen["params"][best])
    model = model.to(dev).eval()
    data = ["--config", cfg_path, "--device", str(dev), f"task.transform.model_path={tok_dir}",
            f"datamodule.passages_path={work}/passages.tsv",
            f"datamodule.test_path={work}/questions.csv", "datamodule.encode_batch_size=128",
            "task.mips_method=fused", "task.topk=100", *extra]
    results = {}
    for name, weights in (("export", [f"task.checkpoint_path={export}"]), ("memory", []),
                          ("seeded", [])):
        real = generate_embeddings.build_biencoder, run_retrieval.build_biencoder
        if name == "memory":
            generate_embeddings.build_biencoder = run_retrieval.build_biencoder = \
                lambda cfg, device: model
        argv = data + weights + [f"task.ctx_embeddings_dir={work}/{name}"]
        t0 = time.perf_counter()
        try:
            generate_embeddings.main(argv)
            run_retrieval.main(argv + [f"task.output_path={work}/{name}.json"])
        finally:
            generate_embeddings.build_biencoder, run_retrieval.build_biencoder = real
        results[name] = (*recall_of_run(f"{work}/{name}.json", gold, RECALL_K),
                         time.perf_counter() - t0)
        print(f"{name} weights: generate_embeddings ({n_passages} passages) + run_retrieval "
              f"({n_questions} questions, fused, top-100) in {results[name][2]:.2f} s; "
              f"recall@{RECALL_K} {results[name][0]:.4f}, MRR@100 {results[name][1]:.4f}")
    ids = {n: [[c["id"] for c in row["ctxs"]] for row in json.load(open(f"{work}/{n}.json"))]
           for n in ("export", "memory")}
    if ids["export"] != ids["memory"]:
        raise AssertionError("the export's top-100 differs from the in-memory model's")
    gain = results["export"][0] - results["seeded"][0]
    print(f"checkpoint slice: S = {steps} steps at batch {batch_size}; wall unbroken "
          f"{wall_a:.2f} s, broken {wall_b1:.2f} + resumed {wall_b2:.2f} s; the export's top-100 ids "
          f"equal the in-memory best model's (step {best}) for all {n_questions} questions; "
          f"recall@{RECALL_K} trained {results['export'][0]:.4f} vs seeded "
          f"{results['seeded'][0]:.4f} (gain {gain:.4f}, margin {RECALL_MARGIN}); MRR@100 "
          f"{results['export'][1]:.4f} vs {results['seeded'][1]:.4f}")
    if not gain >= RECALL_MARGIN:
        raise AssertionError(f"trained recall@{RECALL_K} gains {gain:.4f} < {RECALL_MARGIN}")

    fwd, drop, bwd, count = (getattr(obj, name) for obj, name in counters)
    launches = {"attention_fwd": fwd - drop, "attention_fwd_dropout": drop, "attention_bwd": bwd,
                "count_above_groups": count}
    print(f"checkpoint-path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the checkpoint path never launched: {launches}")
    return launches


# phase 19 (phase_own_batch): the dense configs at their own batch and model
# through cli.train on phase 18's keyed data. Each run is (name, config,
# queries a step, steps, overrides): conf/nq.yaml at its batch 256 (512
# contexts) under GradCache, without and with the fused FFN; conf/ccnews_ict.yaml
# at its global batch 2,048 (num_negative 0, two towers) under GradCache with
# 16 chunks; conf/nq.yaml with bert_large's model file (arch, remat) at batch
# 256; lamb, madgrad and accumulation at batch 64; and the profiler. The
# depth cut is the steps. The gates: GradCache against the monolithic step
# at rate 0 (the same bf16 kernels on chunks of other sizes: GEMM algorithms
# and the summation order differ), remat against no remat at rate 0.1 (the
# same generators replayed; only the embedding backward's atomics differ).
NQ_OWN = ["datamodule.num_val_negative=1", "datamodule.num_test_negative=1"]
OWN_RUNS = (
    ("a nq gradcache", "nq.yaml", 256, 4, [*NQ_OWN, "task.grad_cache_chunks=2"]),
    ("b nq gradcache fused_ffn", "nq.yaml", 256, 4,
     [*NQ_OWN, "task.grad_cache_chunks=2", "task.model.fused_ffn=true"]),
    ("c ccnews_ict gradcache", "ccnews_ict.yaml", 2048, 2, ["task.grad_cache_chunks=16"]),
    ("d nq bert_large remat", "nq.yaml", 256, 3,
     [*NQ_OWN, "task.model.arch=bert_large", "task.model.remat=true"]),
    ("e lamb", "nq.yaml", 64, 2, [*NQ_OWN, "task.optim.name=lamb"]),
    ("e madgrad", "nq.yaml", 64, 2, [*NQ_OWN, "task.optim.name=madgrad"]),
    ("e accumulate", "nq.yaml", 64, 2, [*NQ_OWN, "trainer.accumulate_grad_batches=2"]),
    ("f profile", "nq.yaml", 64, 2, [*NQ_OWN, "trainer.profile_dir={work}/profile"]),
)
OWN_VAL_ROWS = 64
GC_GATE_BATCH, GC_GATE_CHUNKS, GC_LOSS_REL, GC_COS = 128, (2, 4), 1e-3, 0.999
REMAT_GATE_BATCH, REMAT_LOSS_REL, REMAT_COS = 64, 1e-4, 0.9999
PORT_KERNEL_SYMBOLS = ("attention_fwd_kernel", "attention_bwd_dq_kernel",
                       "attention_bwd_dkdv_kernel", "ffn_gemm_kernel", "ln_rows_kernel")


def _cosine(a, b):
    """Cosine of two gradients, each a list of tensors, as one vector."""
    import torch

    dot = sum(torch.dot(x.flatten().double(), y.flatten().double()) for x, y in zip(a, b))
    na = sum(x.double().square().sum() for x in a).sqrt()
    nb = sum(y.double().square().sum() for y in b).sqrt()
    return float(dot / (na * nb))


def _gate_state(data, dev, overrides, config="nq.yaml"):
    """The task, its state from seed SEED and the first training batch of
    ``config`` with ``overrides`` on phase 19's (or 20's) data."""
    from dpr_scale_tpu_torch.cli.common import (build_datamodule, build_optimizer, build_task,
                                                build_tokenizer)
    from dpr_scale_tpu_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "conf", config), [*data, *overrides])
    dm = build_datamodule(cfg, build_tokenizer(cfg))
    batch = next(iter(dm.train_batches(0)))
    dm.close()
    task = build_task(cfg, build_optimizer(cfg, 1), dev)
    return task, task.init_state(SEED), task.to_device(batch)


def check_grad_cache(data, dev, batch_size=GC_GATE_BATCH, chunks=GC_GATE_CHUNKS,
                     config="nq.yaml"):
    """Gate: at rate 0 the GradCache step's loss within GC_LOSS_REL of the
    monolithic step's and its gradient's cosine to it at least GC_COS, for
    each chunk count, on ``config``. Returns {chunks: (loss relative,
    cosine)}."""
    import torch

    from dpr_scale_tpu_torch.models.transformer import DropoutRng

    task, state, batch = _gate_state(data, dev, [
        f"datamodule.batch_size={batch_size}", "task.model.hidden_dropout=0",
        "task.model.attention_dropout=0"], config)
    rng = DropoutRng(SEED, 0, dev)
    # the loss comes first and the gradients last (the multivec task's
    # metrics lie between)
    loss, *_, grads = task.loss_and_grads(state, batch, rng)
    loss = loss.item()
    out = {}
    for c in chunks:
        task.grad_cache_chunks = c
        got, *_, g = task.loss_and_grads(state, batch, rng)
        out[c] = (abs(got.item() - loss) / abs(loss), _cosine(g, grads))
        del g
        print(f"GradCache gate, {batch_size} queries + {2 * batch_size} contexts, rate 0: "
              f"c = {c} loss {got.item():.6f} vs monolithic {loss:.6f} (relative "
              f"{out[c][0]:.3g}, tolerance {GC_LOSS_REL}), gradient cosine {out[c][1]:.7f} "
              f"(at least {GC_COS})")
    del task, state, grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    bad = {c: r for c, r in out.items() if not (r[0] <= GC_LOSS_REL and r[1] >= GC_COS)}
    if bad:
        raise AssertionError(f"GradCache disagrees with the monolithic step: {bad}")
    return out


def check_remat(data, dev, batch_size=REMAT_GATE_BATCH):
    """Gate: at the config's dropout (0.1) the step with remat against the
    step without it, one DropoutRng: the loss within REMAT_LOSS_REL and the
    gradient's cosine at least REMAT_COS. Returns (loss relative, cosine)."""
    import torch

    from dpr_scale_tpu_torch.models.transformer import DropoutRng

    runs = []
    for remat in ("false", "true"):
        task, state, batch = _gate_state(data, dev, [f"datamodule.batch_size={batch_size}",
                                                     f"task.model.remat={remat}"])
        loss, grads = task.loss_and_grads(state, batch, DropoutRng(SEED, 1, dev))
        runs.append((loss.item(), grads))
        del task, state
    (l0, g0), (l1, g1) = runs
    rel, cos = abs(l1 - l0) / abs(l0), _cosine(g1, g0)
    print(f"remat gate, {batch_size} queries + {2 * batch_size} contexts, dropout 0.1: loss "
          f"{l1:.6f} vs {l0:.6f} without remat (relative {rel:.3g}, tolerance "
          f"{REMAT_LOSS_REL}), gradient cosine {cos:.7f} (at least {REMAT_COS})")
    del runs, g0, g1
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not (rel <= REMAT_LOSS_REL and cos >= REMAT_COS):
        raise AssertionError(f"remat changes the step: loss relative {rel}, cosine {cos}")
    return rel, cos


def trace_port_kernels(path):
    """(device events, {port kernel symbol: events}) of a torch.profiler
    Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    named = {s: sum(s in n for n in kernels) for s in PORT_KERNEL_SYMBOLS}
    return len(kernels), {s: n for s, n in named.items() if n}


def _timed_train_step(cls, ticks, dev):
    """``cls.train_step`` timed by CUDA events (host clock on the CPU) into
    ``ticks``; returns the real step to restore."""
    import torch

    real = cls.train_step

    def timed(self, state, batch, *args):
        if dev.type != "cuda":
            t0 = time.perf_counter()
            out = real(self, state, batch, *args)
            ticks.append((time.perf_counter() - t0) * 1e3)
            return out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(self, state, batch, *args)
        end.record()
        ticks.append((start, end))
        return out

    cls.train_step = timed
    return real


def _ticks_ms(ticks, dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in ticks]
    return list(ticks)


def phase_own_batch(work, dev, runs=OWN_RUNS, card="", gate_batches=None, n_val=OWN_VAL_ROWS,
                    extra=()):
    """Phase 19: the GradCache and remat gates, then each run of ``runs``
    through ``cli.train`` with ``--device dev``: every loss and gradient
    norm finite, the peak under the card's memory; step ms (CUDA events
    around each step; steps 2..), queries/s and the peak printed beside
    ``card``. The attention counters must rise in every run with GradCache
    or remat, the FFN forward's with the fused FFN; the profiled run's trace
    must hold device events. ``runs``/``gate_batches``/``n_val``/``extra``
    only shrink it for a rehearsal on the CPU. Returns the launches."""
    import numpy as np
    import torch

    from dpr_scale_tpu_torch.cli import train
    from dpr_scale_tpu_torch.ops import attention, ffn
    from dpr_scale_tpu_torch.train.task import DenseRetrieverTask
    from dpr_scale_tpu_torch.utils.profiling import TRACE_FILE

    n_rows = max(batch * steps for _, _, batch, steps, _ in runs)
    tok_dir, _gold = write_keyed_data(work, n_rows + n_rows % 2, 8, n_val)
    data = [f"task.transform.model_path={tok_dir}", f"datamodule.train_path={work}/train.jsonl",
            f"datamodule.val_path={work}/val.jsonl", f"datamodule.test_path={work}/val.jsonl",
            *extra]
    gc_batch, remat_batch = gate_batches or (GC_GATE_BATCH, REMAT_GATE_BATCH)
    check_grad_cache(data, dev, gc_batch)
    check_remat(data, dev, remat_batch)

    counters = {"attention_fwd_dropout": (attention.attention_fwd_kernel, "dropout_launches"),
                "attention_bwd": (attention.attention_bwd_kernel, "launches"),
                "ffn_fwd": (ffn.ffn_fwd_kernel, "launches")}
    total = dict.fromkeys(counters, 0)
    capacity = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else None
    missing = []
    for name, config, batch, steps, overrides in runs:
        overrides = [o.format(work=work) for o in overrides]
        ticks = []
        log = f"{work}/{name.replace(' ', '_')}.jsonl"
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        real_step = _timed_train_step(DenseRetrieverTask, ticks, dev)
        t0 = time.perf_counter()
        try:
            train.main(["--config", os.path.join(ROOT, "conf", config), "--device", str(dev),
                        *data, f"datamodule.batch_size={batch}", f"trainer.max_steps={steps}",
                        "trainer.log_every=1", f"trainer.metrics_jsonl={log}", *overrides])
        finally:
            DenseRetrieverTask.train_step = real_step
        wall = time.perf_counter() - t0
        launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
        for k, n in launches.items():
            total[k] += n
        ticks = _ticks_ms(ticks, dev)
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            lines = [json.loads(l) for l in f]
        logged = [l for l in lines if "train_loss" in l]
        numbers = [l[k] for l in logged for k in ("train_loss", "grad_norm")]
        if len(logged) != steps or len(ticks) != steps or not np.isfinite(numbers).all():
            raise AssertionError(f"run {name}: steps {logged}")
        step_ms = statistics.median(ticks[1:] or ticks)
        peak_gib = peak / 2**30 if dev.type == "cuda" else float("nan")
        print(f"own batch, run {name} ({config} {' '.join(overrides)}): {steps} steps of {batch} "
              f"queries in {wall:.2f} s wall (CLI incl. init, data, validation, test); step ms "
              f"{[round(t, 2) for t in ticks]}, median of steps 2.. {step_ms:.2f} ms = "
              f"{batch * 1e3 / step_ms:.1f} queries/s; losses "
              f"{[round(l['train_loss'], 4) for l in logged]}; grad_norms "
              f"{[round(l['grad_norm'], 4) for l in logged]}; peak device memory {peak_gib:.2f} GiB; "
              f"launches {launches}; {card}")
        if capacity is not None and not peak < capacity:
            raise AssertionError(f"run {name}: peak {peak} bytes of {capacity}")
        must = ["attention_fwd_dropout", "attention_bwd"] if (
            "grad_cache" in " ".join(overrides) or "remat" in " ".join(overrides)) else []
        must += ["ffn_fwd"] if "task.model.fused_ffn=true" in overrides else []
        missing += [f"{name}: {k}" for k in must if launches[k] < 1]
        if "trainer.profile_dir" in " ".join(overrides):
            n_device, named = trace_port_kernels(os.path.join(work, "profile", TRACE_FILE))
            print(f"own batch, run {name}: the trace holds {n_device} device kernel events; the "
                  f"port's kernels it names: {named} (the profiler can drop them, ROADMAP C4)")
            if dev.type == "cuda" and not n_device:
                raise AssertionError("the profiler's trace holds no device events")
    print(f"own-batch launches: {total}")
    if missing:
        raise AssertionError(f"a kernel of a run's path never launched: {missing}")
    return total


# phase 20 (phase_multivec): the multi-vector slice on conf/citadel.yaml (a
# bert_base trunk at L = 128, CITADEL routing 1 / 5 experts a token, a 32-d
# token and 128-d CLS projection, every regulariser) at its own batch of 128
# (+ 128 hard negatives), on phase 18's keyed data (MV_PASSAGES passages:
# MV_STEPS / 2 steps an epoch), at phase 18's learning rate and warmup (the
# conf's 3,000 warmup steps would hold a short run's LR near 0). The cut is
# the steps. The main path is the conf as it stands: a monolithic step with
# the trunk's attention on matmuls (the conf does not set
# task.model.fused_attention), its export encoded, searched and served; the
# CITADEL tower's kernels there are the gathers of the device index. The
# attention kernels run in the opt-in variant (task.model.fused_attention
# with task.grad_cache_chunks=MV_GC_CHUNKS, MV_VARIANT_STEPS steps) and in
# the SPLADE run. The monolithic step is also tried alone and its peak or
# its OOM reported; the GradCache gate compares it with MV_GC_CHUNKS chunks
# at rate 0 and MV_GATE_BATCH queries. The serving gate's first request is
# the citadel_retrieval CLI's first query batch (MV_SERVE_QUESTIONS
# questions: the same batch shape, so the same bits); the other requests pad
# to other shapes, whose bf16 GEMMs round otherwise (CITADEL_BF16_REL). The
# SPLADE run trains conf/nq.yaml (which sets the fused attention) with
# task.model.family=splade and the fused FFN (the phase's one run with the
# flag) at a batch whose (B, 255, 30,522) router planes fit beside the trunk.
MV_PASSAGES = 1280
MV_QUESTIONS = 256
MV_STEPS = 20
MV_GATE_BATCH, MV_GC_CHUNKS = 64, 2
MV_VARIANT_STEPS = 6
MV_SERVE_QUESTIONS = 32  # citadel_retrieval's query batch (datamodule.encode_batch_size)
MV_SPLADE_BATCH = 32


def _questions(path):
    """The question column of a DPR questions CSV (question \\t answers)."""
    with open(path) as f:
        return [line.split("\t")[0] for line in f]


def _ranked(results):
    return [[(c["id"], c["score"]) for c in row] for row in results]


def _peak_gib(dev, reset=False):
    import torch

    if dev.type != "cuda":
        return float("nan")
    if reset:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**30


def _mv_monolithic(data, dev, card):
    """(a) conf/citadel.yaml's monolithic step (dropout 0.1) at its own
    batch: two steps, the second's ms and the peak, or the OOM."""
    import torch

    _peak_gib(dev, reset=True)
    task, state, batch = _gate_state(data, dev, [], "citadel.yaml")
    B, C, L = batch["query_ids"].shape[0], batch["contexts_ids"].shape[0], batch["query_ids"].shape[1]
    ticks = []
    real = _timed_train_step(type(task), ticks, dev)
    try:
        for _ in range(2):
            state, m = task.train_step(state, batch, 0.0)
            if not torch.isfinite(m["train_loss"]):
                raise AssertionError(f"monolithic citadel step: loss {m['train_loss']}")
        ms = _ticks_ms(ticks, dev)
        print(f"multivec (a) monolithic step, {B} queries + {C} contexts at L = {L}, dropout "
              f"0.1: step ms {[round(t, 2) for t in ms]} ({B * 1e3 / ms[-1]:.1f} queries/s), "
              f"loss {float(m['train_loss']):.4f}, peak device memory {_peak_gib(dev):.2f} GiB; "
              f"{card}")
        out = {"ms": ms[-1], "peak_gib": _peak_gib(dev)}
        _mv_scorer_in_step(task, state, batch, dev, card)
    except torch.cuda.OutOfMemoryError as e:
        print(f"multivec (a) monolithic step, {B} queries + {C} contexts: out of memory at "
              f"{_peak_gib(dev):.2f} GiB allocated ({str(e).splitlines()[0][:160]}); {card}")
        out = {"oom_at_gib": _peak_gib(dev)}
    finally:
        type(task).train_step = real
    del task, state, batch
    _peak_gib(dev, reset=True)
    return out


def _mv_scorer_in_step(task, state, batch, dev, card):
    """The blocked scorer's share of a training step: expert_sim_score over
    the batch's encoded reprs, forward and backward (with respect to the
    token vectors and routing weights), timed alone, and its peak above the
    reprs."""
    import torch

    from dpr_scale_tpu_torch.train.multivec import expert_sim_score

    with torch.no_grad():
        q, c = task._encode(state.model, batch, None)
    for d in (q, c):
        for key in ("expert_repr", "expert_weights"):
            d[key] = d[key].detach().requires_grad_(True)
    leaves = [d[k] for d in (q, c) for k in ("expert_repr", "expert_weights")]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if dev.type == "cuda" else None
    _peak_gib(dev, reset=True)
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    if ev:
        ev[0].record()
    scores = expert_sim_score(q, c, batch["ctx_mask"], query_pool=task.query_pool)
    if ev:
        ev[1].record()
    torch.autograd.grad(scores.logsumexp(-1).sum(), leaves)
    if ev:
        ev[2].record()
        torch.cuda.synchronize()
        fwd, bwd = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        above = (torch.cuda.max_memory_allocated() - base) / 2**30
    else:
        fwd = bwd = above = float("nan")  # no device clock on the CPU
    n = scores.shape[0] * q["expert_ids"].shape[1] * q["expert_ids"].shape[2] * \
        scores.shape[1] * c["expert_ids"].shape[1] * c["expert_ids"].shape[2]
    print(f"multivec (a) the blocked scorer in the step: {n:.3g} gated products, forward "
          f"{fwd:.2f} ms, backward (recomputing each block) {bwd:.2f} ms, peak above the "
          f"reprs {above:.3f} GiB; {card}")


def _mv_eval(data, dev, card):
    """(b) validation and test batches at the conf's num_val_negative /
    num_test_negative: run_eval's ms and peak, and the scorer's own peak
    above the encoded batch."""
    import numpy as np
    import torch

    from dpr_scale_tpu_torch.cli.common import (build_datamodule, build_optimizer, build_task,
                                                build_tokenizer)
    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.train.multivec import SCORE_BLOCK, expert_sim_score

    cfg = load_config(os.path.join(ROOT, "conf", "citadel.yaml"), data)
    dm = build_datamodule(cfg, build_tokenizer(cfg))
    task = build_task(cfg, build_optimizer(cfg, 1), dev)
    state = task.init_state(SEED)
    out = {}
    for split, batches in (("validation", dm.val_batches()), ("test", dm.test_batches())):
        batch = next(iter(batches))
        n_ctx = batch["contexts_ids"].shape[0]
        _peak_gib(dev, reset=True)
        t0 = time.perf_counter()
        metrics = task.run_eval(state, [batch])
        wall = (time.perf_counter() - t0) * 1e3
        peak = _peak_gib(dev)
        with torch.no_grad():
            b = task.to_device(batch)
            q = task.encode_eval(state.model, b["query_ids"], b["query_mask"], task.query_topk)
            c = task.encode_eval(state.model, b["contexts_ids"], b["contexts_mask"],
                                 task.context_topk)
            _peak_gib(dev, reset=True)
            base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
            t0 = time.perf_counter()
            scores = expert_sim_score(q, c, b["ctx_mask"], query_pool=task.query_pool)
            float(scores.sum())
            score_ms = (time.perf_counter() - t0) * 1e3
            scorer_gib = (torch.cuda.max_memory_allocated() - base) / 2**30 \
                if dev.type == "cuda" else float("nan")
        del q, c, b, scores
        print(f"multivec (b) {split}: {batch['query_ids'].shape[0]} queries x {n_ctx} contexts; "
              f"run_eval {wall:.1f} ms wall, peak {peak:.2f} GiB; expert_sim_score {score_ms:.1f} "
              f"ms, its peak above the encoded batch {scorer_gib:.3f} GiB (blocks of "
              f"{SCORE_BLOCK} elements); mrr {metrics['mrr']:.4f}; {card}")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{split} metrics {metrics}")
        out[split] = {"contexts": n_ctx, "ms": wall, "peak_gib": peak, "scorer_gib": scorer_gib}
    dm.close()
    del task, state
    _peak_gib(dev, reset=True)
    return out


def _mv_counters():
    """{name: (wrapper object, count attribute)} of phase 20's kernels."""
    from dpr_scale_tpu_torch.ops import attention, ffn
    from dpr_scale_tpu_torch.ops import gather_score as gs

    return {"attention_fwd": (attention.attention_fwd_kernel, "launches"),
            "attention_fwd_dropout": (attention.attention_fwd_kernel, "dropout_launches"),
            "attention_bwd": (attention.attention_bwd_kernel, "launches"),
            "ffn_fwd": (ffn.ffn_fwd_kernel, "launches"),
            "gather_run_max": (gs.gather_run_max_kernel, "launches")}


def _zero_counts():
    for obj, attr in _mv_counters().values():
        setattr(obj, attr, 0)


def _read_counts():
    """The launches since :func:`_zero_counts`; ``attention_fwd`` counts
    the forward without dropout only."""
    launches = {k: getattr(obj, attr) for k, (obj, attr) in _mv_counters().items()}
    launches["attention_fwd"] -= launches["attention_fwd_dropout"]
    return launches


def _mv_train(label, argv, steps, cls, dev, card):
    """One ``cli.train`` run of ``argv`` (which names its batch and its
    metrics file) with the counts set to 0 just before and read just after:
    every loss and gradient norm finite; step ms by CUDA events, queries/s,
    the peak and the launches printed. Returns (launches, peak GiB)."""
    import numpy as np

    from dpr_scale_tpu_torch.cli import train

    def value(key):
        return next(a.split("=", 1)[1] for a in reversed(argv) if a.startswith(key + "="))

    log, batch = value("trainer.metrics_jsonl"), int(value("datamodule.batch_size"))
    ticks = []
    _peak_gib(dev, reset=True)
    real = _timed_train_step(cls, ticks, dev)
    t0 = time.perf_counter()
    _zero_counts()
    try:
        test_metrics = train.main([*argv, f"trainer.max_steps={steps}", "trainer.log_every=1"])
    finally:
        launches = _read_counts()
        cls.train_step = real
    wall = time.perf_counter() - t0
    peak = _peak_gib(dev)
    ms = _ticks_ms(ticks, dev)
    with open(log) as f:
        lines = [json.loads(l) for l in f]
    logged = [l for l in lines if "train_loss" in l]
    numbers = [l[k] for l in logged for k in ("train_loss", "grad_norm")]
    if len(logged) != steps or len(ms) != steps or not np.isfinite(numbers).all():
        raise AssertionError(f"multivec {label}: steps {logged}")
    step_ms = statistics.median(ms[1:] or ms)
    valid = [(l["step"], round(l["valid_mrr"], 4)) for l in lines if "valid_mrr" in l]
    print(f"multivec {label}: {steps} steps of {batch} queries + {2 * batch} contexts in "
          f"{wall:.2f} s wall (CLI incl. init, data, validation, test, saves); step ms "
          f"{[round(t, 2) for t in ms]}, median of steps 2.. {step_ms:.2f} ms = "
          f"{batch * 1e3 / step_ms:.1f} queries/s; losses "
          f"{[round(l['train_loss'], 4) for l in logged]}; grad_norms "
          f"{[round(l['grad_norm'], 4) for l in logged]}; validation MRR by step {valid}; test "
          f"{({k: round(v, 4) for k, v in test_metrics.items()})}; peak device memory "
          f"{peak:.2f} GiB; launches {launches}; {card}")
    return launches, peak


def phase_multivec(work, dev, card="", batch_size=TRAIN_BATCH, steps=MV_STEPS,
                   variant_steps=MV_VARIANT_STEPS, n_passages=MV_PASSAGES,
                   n_questions=MV_QUESTIONS, gate_batch=MV_GATE_BATCH, splade_batch=MV_SPLADE_BATCH,
                   serve_questions=MV_SERVE_QUESTIONS, extra=(), splade_extra=()):
    """Phase 20, the multi-vector slice on ``dev``. Probes: (a) the
    monolithic CITADEL step at conf/citadel.yaml's batch (peak or OOM) and
    the GradCache gate; (b) run_eval at the conf's validation and test
    batches. The main path, each run with the counts set to 0 just before it
    and read just after: (c) ``cli.train`` on the conf as it stands for
    ``steps`` steps with a top-1 async save, exporting params_best, and its
    opt-in variant with the fused attention under GradCache; (d)
    ``cli.generate_multivec_embeddings`` and ``cli.citadel_retrieval`` (host
    index, device index) on the export, the same top-100 as the exported
    model in memory, recall@RECALL_K against the seeded encoder (reported);
    (e) ``cli.serve`` with only ``serve_citadel``, its ``/search_citadel``
    answers against citadel_retrieval's device-index run; (f) two SPLADE
    steps through ``cli.train`` with the fused FFN, exporting params_best
    (phase 21 encodes and searches it: ``<work>/splade_ckpt/params_best``;
    the CITADEL export is ``<work>/ckpt/params_best``). The serial or streamed
    gather must launch in (d) and in (e), the attention forward (with and
    without dropout) and backward in the variant and in (f), the fused FFN
    in (f).
    Every other argument only shrinks it for a rehearsal on the CPU.
    Returns the main path's launches."""
    import torch

    from dpr_scale_tpu_torch.cli import citadel_retrieval, generate_multivec_embeddings, serve
    from dpr_scale_tpu_torch.cli import train
    from dpr_scale_tpu_torch.train.checkpoint import save_params
    from dpr_scale_tpu_torch.train.multivec import MultiVecRetrieverTask
    from dpr_scale_tpu_torch.train.task import DenseRetrieverTask

    t_phase = time.perf_counter()
    capacity = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else None
    peaks, by_run, missing = {}, {}, []
    gather = ("gather_run_max",)

    def needs(run, launches, kernels):
        """Record a main-path run's launches; each of ``kernels`` (a name,
        or a tuple of names of which one suffices) must have launched."""
        by_run[run] = launches
        for k in kernels:
            names = (k,) if isinstance(k, str) else k
            if not sum(launches[n] for n in names):
                missing.append(f"{run}: {'/'.join(names)}")

    tok_dir, gold = write_keyed_data(work, n_passages, n_questions, batch_size)
    cfg_path = os.path.join(ROOT, "conf", "citadel.yaml")
    data = [f"task.transform.model_path={tok_dir}", f"datamodule.train_path={work}/train.jsonl",
            f"datamodule.val_path={work}/val.jsonl", f"datamodule.test_path={work}/val.jsonl",
            f"datamodule.batch_size={batch_size}", f"task.optim.lr={CKPT_LR}",
            f"task.warmup_steps={CKPT_WARMUP}", *extra]

    # (a) probe: the step at the conf's batch, monolithic, then the GradCache gate
    mono = _mv_monolithic(data, dev, card)
    peaks["a monolithic"] = mono.get("peak_gib", mono.get("oom_at_gib"))
    print(f"multivec (a) GradCache gate on conf/citadel.yaml (router, expert and CLS losses, "
          f"every regulariser):")
    check_grad_cache(data, dev, gate_batch, (MV_GC_CHUNKS,), config="citadel.yaml")

    # (b) probe: validation and test at the conf's own context counts
    evals = _mv_eval(data, dev, card)
    peaks.update({f"b {k}": v["peak_gib"] for k, v in evals.items()})

    # (c) cli.train on the conf as it stands, top-1 async saves, params_best
    # exported; then the opt-in variant (fused attention, GradCache)
    ckpt = f"{work}/ckpt"
    exported = {}

    def keep_export(path, sd):
        exported["sd"] = {k: v.detach().cpu().clone() for k, v in sd.items()}
        return save_params(path, sd)

    train.save_params = keep_export
    try:
        launches, peaks["c cli.train"] = _mv_train(
            "(c) cli.train conf/citadel.yaml (monolithic, the conf's attention)",
            ["--config", cfg_path, "--device", str(dev), *data,
             f"trainer.metrics_jsonl={work}/train.jsonl.log", f"checkpoint_callback.dirpath={ckpt}",
             "checkpoint_callback.save_top_k=1", "checkpoint_callback.async_save=true"],
            steps, MultiVecRetrieverTask, dev, card)
    finally:
        train.save_params = save_params
    needs("c cli.train", launches, [])
    launches, peaks["c variant"] = _mv_train(
        f"(c) opt-in variant, cli.train conf/citadel.yaml task.model.fused_attention=true "
        f"task.grad_cache_chunks={MV_GC_CHUNKS}",
        ["--config", cfg_path, "--device", str(dev), *data, "task.model.fused_attention=true",
         f"task.grad_cache_chunks={MV_GC_CHUNKS}", f"trainer.metrics_jsonl={work}/variant.log"],
        variant_steps, MultiVecRetrieverTask, dev, card)
    needs("c variant", launches, ["attention_fwd", "attention_fwd_dropout", "attention_bwd"])

    # (d) the export through the encode and retrieval CLIs (the in-memory and
    # seeded runs are comparisons, outside the counts)
    export = f"{ckpt}/params_best"
    base = ["--config", cfg_path, "--device", str(dev), f"task.transform.model_path={tok_dir}",
            f"datamodule.passages_path={work}/passages.tsv",
            f"datamodule.test_path={work}/questions.csv", *extra]
    runs, recalls = {}, {}
    real_build = generate_multivec_embeddings.build_multivec_model
    for name, weights, searches in (
            ("export", [f"task.checkpoint_path={export}"], ("host", "device")),
            ("memory", [], ("host",)), ("seeded", [], ("host",))):
        if name == "memory":
            def in_memory(cfg, device, seed=0):
                model = real_build(cfg, "cpu", seed)
                model.load_state_dict(exported["sd"])
                return model.to(device).eval()
            generate_multivec_embeddings.build_multivec_model = in_memory
            citadel_retrieval.build_multivec_model = in_memory
        argv = base + weights + [f"task.ctx_embeddings_dir={work}/index_{name}"]
        if name == "export":
            _zero_counts()
        t0 = time.perf_counter()
        try:
            stats = generate_multivec_embeddings.main(argv)
            gen_s = time.perf_counter() - t0
            for search in searches:
                dev_index = ["task.device_index=true"] if search == "device" else []
                t1 = time.perf_counter()
                res = citadel_retrieval.main(argv + dev_index +
                                             [f"task.output_path={work}/{name}_{search}.json"])
                runs[f"{name} {search}"] = _ranked(res)
                recall, mrr = recall_of_run(f"{work}/{name}_{search}.json", gold, RECALL_K)
                recalls[f"{name} {search}"] = recall
                print(f"multivec (d) {name} weights: generate_multivec_embeddings ({n_passages} "
                      f"passages) {gen_s:.2f} s; citadel_retrieval {search} index "
                      f"({n_questions} questions, top-100) {time.perf_counter() - t1:.2f} s; "
                      f"recall@{RECALL_K} {recall:.4f}, MRR@100 {mrr:.4f}; {stats}")
        finally:
            generate_multivec_embeddings.build_multivec_model = real_build
            citadel_retrieval.build_multivec_model = real_build
        if name == "export":
            launches = _read_counts()
            print(f"multivec (d) the export's encode and searches: launches {launches}")
            needs("d encode and search", launches, [gather])
    if [[d for d, _s in r] for r in runs["export host"]] != \
            [[d for d, _s in r] for r in runs["memory host"]]:
        raise AssertionError("the export's top-100 differs from the in-memory model's")
    bad = _same_runs(runs["export host"], runs["export device"], _rel_tol(CITADEL_BF16_REL))
    print(f"multivec (d): the export's top-100 ids equal the in-memory model's for all "
          f"{n_questions} questions; bf16 device index vs host: {bad} of {n_questions} queries "
          f"disagree beyond {CITADEL_BF16_REL} relative; recall@{RECALL_K} trained "
          f"{recalls['export host']:.4f} vs seeded {recalls['seeded host']:.4f} (reported, "
          f"not gated)")
    if bad:
        raise AssertionError(f"device-index run of the export: {bad} queries disagree")

    # (e) cli.serve with only serve_citadel: /search_citadel
    questions = _questions(f"{work}/questions.csv")
    served = {}
    real_make = serve.make_server

    def capture(retriever, host, port, citadel_retriever=None):
        server = real_make(retriever, host, port, citadel_retriever)
        served["server"] = server
        served["ready"].set()
        return server

    served["ready"] = threading.Event()
    serve.make_server = capture
    argv = ["--config", cfg_path, "--device", str(dev), f"task.transform.model_path={tok_dir}",
            f"datamodule.passages_path={work}/passages.tsv", f"task.checkpoint_path={export}",
            f"serve_citadel.ctx_embeddings_dir={work}/index_export", "serve_citadel.add_cls=true",
            "serve_citadel.query_topk=1", "serve.host=127.0.0.1", "serve.port=0", *extra]
    failure = []

    def run_server():
        try:
            serve.main(argv)
        except BaseException as e:  # handed to the phase's thread below
            failure.append(e)
            served["ready"].set()

    thread = threading.Thread(target=run_server, daemon=True)
    _zero_counts()
    t0 = time.perf_counter()
    thread.start()
    served["ready"].wait(timeout=600)
    serve.make_server = real_make
    if failure or "server" not in served:
        raise AssertionError(f"cli.serve did not start: {failure}")
    build_s = time.perf_counter() - t0
    server = served["server"]
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        if health["towers"] != ["/search_citadel"]:
            raise AssertionError(f"healthz {health}")
        requests = [(list(range(serve_questions)), 10, CITADEL_SAME_REL),
                    ([serve_questions + 8], 10, CITADEL_BF16_REL),
                    ([serve_questions + 1, serve_questions + 2, serve_questions + 3], 5,
                     CITADEL_BF16_REL)]
        report = []
        for rows, k, rel in requests:
            t1 = time.perf_counter()
            got = _ranked(post(url, [questions[i] for i in rows], k, "/search_citadel"))
            ms_req = (time.perf_counter() - t1) * 1e3
            want = [runs["export device"][i][:k] for i in rows]
            bad = _same_runs(want, got, _rel_tol(rel))
            report.append(f"{len(rows)} questions k={k}: {ms_req:.1f} ms, {bad} disagree "
                          f"beyond {rel} relative")
            if bad:
                raise AssertionError(f"/search_citadel ({len(rows)} questions) disagrees with "
                                     f"citadel_retrieval's device-index run: {bad} queries")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        launches = _read_counts()
    print(f"multivec (e) cli.serve (serve_citadel only, bf16 device index) built in "
          f"{build_s:.2f} s; healthz {health}; /search_citadel: {'; '.join(report)}; launches "
          f"{launches}; {card}")
    needs("e serve", launches, [gather])

    # (f) two SPLADE steps with the fused FFN (conf/nq.yaml sets the fused attention)
    launches, peaks["f splade"] = _mv_train(
        "(f) cli.train conf/nq.yaml task.model.family=splade task.model.fused_ffn=true, L = 256",
        ["--config", os.path.join(ROOT, "conf", "nq.yaml"), "--device", str(dev),
         f"task.transform.model_path={tok_dir}", f"datamodule.train_path={work}/train.jsonl",
         f"datamodule.val_path={work}/val.jsonl", f"datamodule.test_path={work}/val.jsonl",
         *NQ_OWN, f"datamodule.batch_size={splade_batch}", f"trainer.metrics_jsonl={work}/splade.log",
         "task.model.family=splade", "task.model.fused_ffn=true",
         f"checkpoint_callback.dirpath={work}/splade_ckpt", "checkpoint_callback.save_top_k=1",
         "checkpoint_callback.async_save=true", *splade_extra],
        2, DenseRetrieverTask, dev, card)
    needs("f splade", launches, ["attention_fwd", "attention_fwd_dropout", "attention_bwd",
                                  "ffn_fwd"])

    if capacity is not None:
        over = {k: v for k, v in peaks.items() if not v * 2**30 < capacity}
        if over:
            raise AssertionError(f"peaks above the card's memory: {over}")
    total = {k: sum(r[k] for r in by_run.values()) for k in _mv_counters()}
    print(f"multivec main-path launches by run: {by_run}; summed {total}; peaks GiB "
          f"{({k: round(v, 2) for k, v in peaks.items()})}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if missing:
        raise AssertionError(f"a kernel of the multi-vector path never launched: {missing}")
    return total


# phase 21 (phase_rest): the rest of the reference surface on phase 18's keyed
# data and vocab at bert_base width: distillation, rerank, SPAR, the
# exporter, the worker pool and the SPLADE CLIs (C9)
REST_PASSAGES, REST_QUESTIONS = 4096, 1024
REST_ROWS = 1 << 20  # SPAR's rows with fp16 distractors: 1,048,576 x (768 + 768)
DISTILL_STEPS, DISTILL_VARIANT_STEPS = 20, 6
DISTILL_L, DISTILL_ROWS = 64, 32  # conf/distill.yaml: 16 questions, two target rows each
RERANK_QUESTIONS, RERANK_K, RERANK_BATCH = 256, 20, 256
RERANK_BF16_REL = 1e-2  # dense rerank vs retrieval score of a pair, of the query's top |score|
EXPORT_REL = 1e-2  # exported vs eager embeddings: max |diff| over max |ref| (bf16)
QUANT_COS = 0.99
REST_WORKERS = 4
SPAR_WEIGHT = 0.5
TUNE_QUESTIONS = 256
SERVE_QUESTIONS = 40


def _rest_counters():
    """{name: (wrapper object, count attribute)} of phase 21's kernels."""
    from dpr_scale_tpu_torch.ops import attention, ffn
    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    return {"attention_fwd": (attention.attention_fwd_kernel, "launches"),
            "attention_fwd_dropout": (attention.attention_fwd_kernel, "dropout_launches"),
            "attention_bwd": (attention.attention_bwd_kernel, "launches"),
            "ffn_ln_fwd": (ffn.ffn_ln_fwd_kernel, "launches"),
            "count_above_groups": (mk.count_above_groups_kernel, "launches"),
            "count_above": (mk.count_above_kernel, "launches"),
            "groupmax": (mk.groupmax_kernel, "launches"),
            "tile_max_scores": (mk.tile_max_scores_kernel, "launches"),
            "topk_candidates": (mk.topk_candidates_kernel, "launches")}


class _RestRuns:
    """Each main-path run of phase 21 with the counts set to 0 just before
    it and read just after (``attention_fwd``: the forward without
    dropout); ``needs`` names the kernels (or tuples, one of which
    suffices) the run must launch."""

    def __init__(self, counters=None, prefix="rest"):
        self.by_run, self.missing = {}, []
        self.counters, self.prefix = counters or _rest_counters, prefix

    def __call__(self, label, fn, needs=()):
        counters = self.counters()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
            launches["attention_fwd"] -= launches["attention_fwd_dropout"]
            self.by_run[label] = launches
            print(f"{self.prefix} {label}: {time.perf_counter() - t0:.2f} s wall; launches "
                  f"{ {k: v for k, v in launches.items() if v} }")
            for k in needs:
                names = (k,) if isinstance(k, str) else k
                if not sum(launches[n] for n in names):
                    self.missing.append(f"{label}: {'/'.join(names)}")

    def total(self):
        return {k: sum(r[k] for r in self.by_run.values()) for k in self.counters()}


class _EncodeTimer:
    """Host time of each ``CorpusEncoder.encode_batches`` (it ends with the
    embeddings on the host, so the device work is done) while active."""

    def __enter__(self):
        from dpr_scale_tpu_torch.encode import embeddings

        self.cls, self.real, self.runs = embeddings.CorpusEncoder, \
            embeddings.CorpusEncoder.encode_batches, []
        real, runs = self.real, self.runs

        def timed(enc, batches):
            t0 = time.perf_counter()
            out = real(enc, batches)
            runs.append((out[0].shape[0], time.perf_counter() - t0))
            return out

        self.cls.encode_batches = timed
        return self

    def __exit__(self, *exc):
        self.cls.encode_batches = self.real

    def rate(self):
        rows, secs = self.runs[-1]
        return rows / secs


def _load_reps(path):
    from dpr_scale_tpu_torch.encode.embeddings import load_embedding_shard

    return load_embedding_shard(path).astype("float32")


def _distill_rows(d18, teacher, out):
    """Phase 18's train / val rows with the teacher's vectors: the positive
    passage's context vector and the question's query vector."""
    import numpy as np

    from dpr_scale_tpu_torch.data.datasets import CSVDataset

    ps = CSVDataset(f"{d18}/passages.tsv")
    row_of = {(ps[i]["title"], ps[i]["text"]): i for i in range(len(ps))}
    P = _load_reps(f"{teacher}/passages/reps_0000.pkl")
    Q = _load_reps(f"{teacher}/queries/query_reps.pkl")
    j = 0
    for split in ("train", "val"):
        with open(f"{d18}/{split}.jsonl") as f, open(f"{out}/distill_{split}.jsonl", "w") as o:
            for line in f:
                row = json.loads(line)
                pos = row["positive_ctxs"][0]
                o.write(json.dumps({"question": row["question"],
                                    "ctx_target_vectors": [P[row_of[(pos["title"], pos["text"])]].tolist()],
                                    "qry_target_vector": Q[j].tolist()}) + "\n")
                j += 1
    if j != Q.shape[0] or not np.isfinite(P).all():
        raise AssertionError(f"teacher vectors: {j} questions vs {Q.shape[0]} query vectors")


def _rest_train(label, argv, steps, cls, dev, card, rows):
    """One ``cli.train`` run (argv names its metrics file): every loss and
    gradient norm finite; step ms by CUDA events, rows/s, the peak and the
    losses printed. Returns (logged train steps, test metrics, peak GiB)."""
    import numpy as np

    from dpr_scale_tpu_torch.cli import train

    log = next(a.split("=", 1)[1] for a in reversed(argv) if a.startswith("trainer.metrics_jsonl="))
    ticks = []
    _peak_gib(dev, reset=True)
    real = _timed_train_step(cls, ticks, dev)
    try:
        test_metrics = train.main([*argv, f"trainer.max_steps={steps}", "trainer.log_every=1"])
    finally:
        cls.train_step = real
    peak = _peak_gib(dev)
    ms = _ticks_ms(ticks, dev)
    with open(log) as f:
        lines = [json.loads(l) for l in f]
    logged = [l for l in lines if "train_loss" in l]
    numbers = [l[k] for l in logged for k in ("train_loss", "grad_norm")]
    if len(logged) != steps or len(ms) != steps or not np.isfinite(numbers).all():
        raise AssertionError(f"rest {label}: steps {logged}")
    step_ms = statistics.median(ms[1:] or ms)
    print(f"rest {label}: {steps} steps of {rows} rows; step ms {[round(t, 2) for t in ms]}, "
          f"median of steps 2.. {step_ms:.2f} ms = {rows * 1e3 / step_ms:.1f} rows/s "
          f"({rows // 2 * 1e3 / step_ms:.1f} questions/s); losses "
          f"{[round(l['train_loss'], 6) for l in logged]}; validation "
          f"{[(l['step'], round(l['valid_loss'], 6)) for l in lines if 'valid_loss' in l]}; test "
          f"{({k: round(v, 6) for k, v in test_metrics.items()})}; peak device memory "
          f"{peak:.2f} GiB; {card}")
    return logged, test_metrics, peak


def _rerank_pairs_per_s(main, argv):
    """(output, pairs/s of the scoring loop, pairs/s of the whole CLI)."""
    from dpr_scale_tpu_torch.retrieve import rerank

    real, spent = rerank._run_rerank, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        spent.append(time.perf_counter() - t0)
        return out

    rerank._run_rerank = timed
    t0 = time.perf_counter()
    try:
        out = main(argv)
    finally:
        rerank._run_rerank = real
    n = len(out["scores"])
    return out, n / spent[0], n / (time.perf_counter() - t0)


def _distractors(reps_dir, n_rows, seed, dev):
    """fp16 rows around the encoded rows' mean (their std), up to ``n_rows``
    in all, as ``reps_0001.npy`` (phase 15's distractors)."""
    import numpy as np
    import torch

    e = torch.from_numpy(_load_reps(f"{reps_dir}/reps_0000.pkl")).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(n_rows - e.shape[0], e.shape[1], generator=g, device=dev)
    np.save(f"{reps_dir}/reps_0001.npy", (e.mean(0) + noise * e.std(0)).half().cpu().numpy())


def _rows_index(rows, dtype):
    """check_exact's view of brute-force rows: one block of all of them."""
    import types

    return types.SimpleNamespace(dtype=dtype, _blocks=[(rows, rows.shape[0], 0)])


def _sweep_span(N, B, D):
    """The rows a groupmax or count block takes (the launch's fill_span)."""
    from dpr_scale_tpu_torch.ops import cuda_lib

    return cuda_lib.library().dst_bf16_sweep_span(N, B, D)


def _route_delta(before):
    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    now = {n: dict(getattr(mk, f"{n}_kernel").launches_by_route)
           for n in ("count_above_groups", "count_above", "groupmax")}
    return {n: {r: c - before.get(n, {}).get(r, 0) for r, c in routes.items()}
            for n, routes in now.items()}


def phase_rest(work, dev, d18, dense_export, citadel_export, d20, splade_export, card="",
               n_passages=REST_PASSAGES, n_questions=REST_QUESTIONS, n_rows=REST_ROWS,
               distill_steps=DISTILL_STEPS, variant_steps=DISTILL_VARIANT_STEPS,
               rerank_questions=RERANK_QUESTIONS, workers=REST_WORKERS, extra=(), mv_extra=(),
               splade_extra=(), distill_extra=(), rerank_batch=RERANK_BATCH, encode_batch=128):
    """Phase 21 on ``dev``: (a) teacher vectors from phase 18's export
    (``d18`` its data, ``dense_export`` its params), ``cli.train --config
    conf/distill.yaml`` as the conf stands (its MSE must fall) and with the
    fused attention; (b) a TREC run from ``cli.run_retrieval`` and
    ``cli.rerank`` of each type (dense on the export, its scores the
    retrieval's within RERANK_BF16_REL; the cross-encoder seeded; multivec
    on ``citadel_export``); (c) two encoders over the same passages plus
    fp16 distractors, ``tools.spar_retrieval`` against a brute force of the
    combined vectors, ``tools.tune_spar_weights``; (d) the export as a
    ``torch.export`` program (the same vectors as the eager encode, the
    attention kernel inside it) and as int8 weights (cosine >= QUANT_COS,
    bytes, recall@RECALL_K); (e) the encode with ``workers`` processes,
    shards byte-equal to the serial ones; (f) ``splade_export`` (data
    ``d20``) through generate_embeddings, run_retrieval and ``/search``
    against a brute force, the sweeps' routes at D = 30,522. On the card the
    kernels are held against their plain versions at the new shapes (the
    attention kernels at L = 64, the sweeps at D = 1,536 and 30,522). The
    other arguments only shrink it for a rehearsal on the CPU. Returns (the
    main path's launches, the new shapes' kernel entries)."""
    import glob
    import pickle

    import numpy as np
    import torch

    from dpr_scale_tpu_torch.cli import generate_embeddings, generate_query_embeddings, rerank
    from dpr_scale_tpu_torch.cli import run_retrieval, serve
    from dpr_scale_tpu_torch.cli.common import build_biencoder
    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.retrieve import spar
    from dpr_scale_tpu_torch.retrieve.server import make_server
    from dpr_scale_tpu_torch.tools import spar_retrieval, tune_spar_weights
    from dpr_scale_tpu_torch.train.distill import DPRDistillTask
    from dpr_scale_tpu_torch.utils import export

    t_phase = time.perf_counter()
    runs, shapes = _RestRuns(), {}
    cuda = dev.type == "cuda"
    nq, tok18 = os.path.join(ROOT, "conf", "nq.yaml"), f"{d18}/tok"
    dense = ["--config", nq, "--device", str(dev), f"task.transform.model_path={tok18}",
             f"datamodule.encode_batch_size={encode_batch}", *extra]
    ckpt18 = f"task.checkpoint_path={dense_export}"

    def shape(name, what, entry):
        shapes.setdefault(name, []).append({"shape": what, **entry})

    # ---- (a) distillation ----
    os.makedirs(f"{work}/teacher/queries", exist_ok=True)
    with open(f"{work}/teacher/questions.csv", "w") as o:
        for split in ("train", "val"):
            with open(f"{d18}/{split}.jsonl") as f:
                o.writelines(f"{json.loads(l)['question']}\t[]\n" for l in f)
    runs("a teacher passages", lambda: generate_embeddings.main(dense + [
        ckpt18, f"datamodule.passages_path={d18}/passages.tsv",
        f"task.ctx_embeddings_dir={work}/teacher/passages"]))
    runs("a teacher questions", lambda: generate_embeddings.main(["--queries", *dense, ckpt18, (
        f"datamodule.test_path={work}/teacher/questions.csv"),
        f"task.ctx_embeddings_dir={work}/teacher/queries"]))
    _distill_rows(d18, f"{work}/teacher", work)
    distill = ["--config", os.path.join(ROOT, "conf", "distill.yaml"), "--device", str(dev),
               f"task.transform.model_path={tok18}", f"datamodule.train_path={work}/distill_train.jsonl",
               f"datamodule.val_path={work}/distill_val.jsonl",
               f"datamodule.test_path={work}/distill_val.jsonl", *distill_extra]
    logged, _m, peak = runs("a cli.train conf/distill.yaml", lambda: _rest_train(
        "(a) cli.train conf/distill.yaml (the conf's attention)",
        distill + [f"trainer.metrics_jsonl={work}/distill.log"], distill_steps, DPRDistillTask, dev,
        card, DISTILL_ROWS))
    losses = [l["train_loss"] for l in logged]
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"rest (a) the distillation MSE: mean of the first 5 steps {head:.6f}, of the last 5 "
          f"{tail:.6f} ({tail / head - 1:+.2%})")
    if not tail < head:
        raise AssertionError(f"the distillation MSE did not fall: {head} -> {tail}")
    runs("a variant fused_attention", lambda: _rest_train(
        "(a) variant task.model.fused_attention=true",
        distill + ["task.model.fused_attention=true", f"trainer.metrics_jsonl={work}/variant.log"],
        variant_steps, DPRDistillTask, dev, card, DISTILL_ROWS),
        needs=("attention_fwd_dropout", "attention_bwd"))
    if cuda:
        held = _check_train_kernels(DISTILL_ROWS, L=DISTILL_L)
        for name, entry in held.items():
            shape(name, f"B={DISTILL_ROWS} nh=12 L={DISTILL_L} hd=64 rate 0.1", entry)
        torch.cuda.empty_cache()

    # ---- (b) rerank ----
    questions18 = _questions(f"{d18}/questions.csv")[:rerank_questions]
    with open(f"{work}/rerank_questions.csv", "w") as f:
        f.writelines(f"{q}\t[]\n" for q in questions18)
    with open(f"{work}/rerank_queries.tsv", "w") as f:
        f.writelines(f"{i}\t{q}\n" for i, q in enumerate(questions18))
    runs("b run_retrieval candidates", lambda: run_retrieval.main(dense + [
        ckpt18, f"datamodule.passages_path={d18}/passages.tsv",
        f"datamodule.test_path={work}/rerank_questions.csv",
        f"task.ctx_embeddings_dir={work}/teacher/passages", "task.mips_method=fused",
        f"task.topk={RERANK_K}", f"task.output_path={work}/cand.json",
        f"task.output_trec_path={work}/cand.trec"]), needs=("count_above_groups",))
    with open(f"{work}/cand.json") as f:
        retrieved = {(str(i), c["id"]): c["score"] for i, row in enumerate(json.load(f))
                     for c in row["ctxs"]}
    rr = ["--device", str(dev), f"task.transform.model_path={tok18}",
          f"datamodule.trec_path={work}/cand.trec", f"datamodule.queries_path={work}/rerank_queries.tsv",
          f"datamodule.passages_path={d18}/passages.tsv", f"datamodule.batch_size={rerank_batch}"]
    rates = {}
    for kind, config, weights, needs, more in (
            ("dense", "nq.yaml", [ckpt18], ("attention_fwd",), extra),
            ("cross_encoder", "nq.yaml", [], ("attention_fwd",), extra),
            ("multivec", "citadel.yaml", [f"task.checkpoint_path={citadel_export}"], (), mv_extra)):
        argv = ["--config", os.path.join(ROOT, "conf", config), *rr, f"task.rerank_type={kind}",
                *weights, f"task.output_trec_path={work}/rerank_{kind}.trec",
                f"task.output_pickle_dir={work}/rerank_{kind}", *more]
        out, loop_rate, cli_rate = runs(f"b cli.rerank {kind}",
                                        lambda: _rerank_pairs_per_s(rerank.main, argv), needs=needs)
        rates[kind] = (loop_rate, cli_rate)
        if len(out["scores"]) != len(retrieved) or not np.isfinite(out["scores"]).all():
            raise AssertionError(f"rerank {kind}: {len(out['scores'])} scores for {len(retrieved)} pairs")
        print(f"rest (b) cli.rerank {kind} ({config}): {len(out['scores'])} pairs, {loop_rate:.1f} "
              f"pairs/s scoring ({cli_rate:.1f} pairs/s the whole CLI); {card}")
        if kind == "dense":
            top = {}
            for (qid, _d), s in retrieved.items():
                top[qid] = max(top.get(qid, 0.0), abs(s))
            rel = max(abs(s - retrieved[(q, d)]) / top[q]
                      for q, d, s in zip(out["qids"], out["ctx_ids"], out["scores"]))
            print(f"rest (b) dense rerank vs the retrieval's scores of the same {len(out['scores'])} "
                  f"pairs: max |diff| {rel:.3g} of the query's top |score| (tolerance "
                  f"{RERANK_BF16_REL}: the index holds bf16 rows)")
            if not rel <= RERANK_BF16_REL:
                raise AssertionError(f"dense rerank scores differ from the retrieval's: {rel}")

    # ---- (c) SPAR over two encoders, with fp16 distractors ----
    keyed = f"{work}/keyed"
    os.makedirs(keyed, exist_ok=True)
    tok21, gold = write_keyed_data(keyed, n_passages, n_questions, 8)
    with open(f"{keyed}/passages.tsv", "a") as f:
        f.writelines(f"{i}\tdistractor {i}\tdistractor\n" for i in range(n_passages, n_rows))
    kbase = ["--config", nq, "--device", str(dev), f"task.transform.model_path={tok21}",
             f"datamodule.passages_path={keyed}/passages.tsv",
             f"datamodule.test_path={keyed}/questions.csv", "task.shard=0",
             f"task.num_shards={n_rows // n_passages}",
             f"datamodule.encode_batch_size={encode_batch}", *extra]
    with _EncodeTimer() as timer:
        runs("c encode export", lambda: generate_embeddings.main(
            kbase + [ckpt18, f"task.ctx_embeddings_dir={work}/spar_1"]), needs=("attention_fwd",))
        eager_rate = timer.rate()
    runs("c encode seeded", lambda: generate_embeddings.main(
        kbase + [f"task.ctx_embeddings_dir={work}/spar_2"]), needs=("attention_fwd",))
    runs("c queries export", lambda: generate_embeddings.main(
        ["--queries", *kbase, ckpt18, f"task.ctx_embeddings_dir={work}/spar_1"]))
    runs("c queries seeded", lambda: generate_query_embeddings.main(
        kbase + [f"task.ctx_embeddings_dir={work}/spar_2"]))
    for name in ("spar_1", "spar_2"):  # the encoded rows alone, for the tuning and recall
        os.makedirs(f"{work}/{name}_only", exist_ok=True)
        os.symlink(f"{work}/{name}/reps_0000.pkl", f"{work}/{name}_only/reps_0000.pkl")
        with open(f"{work}/{name}_only/query_reps.pkl", "wb") as f:
            pickle.dump(_load_reps(f"{work}/{name}/query_reps.pkl")[:TUNE_QUESTIONS], f, protocol=4)
    for i, name in enumerate(("spar_1", "spar_2")):
        _distractors(f"{work}/{name}", n_rows, SEED + 41 + i, dev)
    t0 = time.perf_counter()
    runs("c tools.spar_retrieval", lambda: spar_retrieval.main([
        "--jsonl_dataset_paths", f"{keyed}/questions.csv",
        "--tsv_passages_path", f"{keyed}/passages.tsv",
        "--ctx_embeddings_dir_1", f"{work}/spar_1", "--ctx_embeddings_dir_2", f"{work}/spar_2",
        "--output_dir", f"{work}/spar_out", "--output_filenames", "spar.json",
        "--weights", str(SPAR_WEIGHT), "--topk", str(RETRIEVAL_K), "--device", str(dev)]),
        needs=("count_above_groups",))
    spar_s = time.perf_counter() - t0
    p = np.concatenate([spar.load_dir_embeddings(f"{work}/{n}") for n in ("spar_1", "spar_2")], 1)
    q = spar.combine_query_vectors(spar.load_query_embeddings(f"{work}/spar_1"),
                                   spar.load_query_embeddings(f"{work}/spar_2"), SPAR_WEIGHT)
    rows = torch.from_numpy(p).to(dev).to(torch.bfloat16)
    del p
    with open(f"{work}/spar_out/spar.json") as f:
        results = [row["ctxs"] for row in json.load(f)]
    check_exact(_rows_index(rows, torch.bfloat16), torch.from_numpy(q).to(dev), results, RETRIEVAL_K)
    print(f"rest (c) tools.spar_retrieval: {len(results)} questions over {rows.shape[0]} rows at "
          f"D = {rows.shape[1]} (weight {SPAR_WEIGHT}) in {spar_s:.2f} s wall; each top-"
          f"{RETRIEVAL_K} equals the brute-force top-{RETRIEVAL_K} of the combined vectors within "
          f"{TOPK_REL} (near-tie swaps allowed); {card}")
    del rows
    if cuda:
        torch.cuda.empty_cache()
        shape("count_above_groups", f"B={QUERY_BATCH} N={n_rows} D=1536 bf16",
              phase_count(dev, cases=((QUERY_BATCH, n_rows, 1536),)))
        for name, entry in phase_mips_kernels(
                dev, cases=((QUERY_BATCH, n_rows, 1536, "bfloat16", 4096, True),)).items():
            shape(name, f"B={QUERY_BATCH} N={n_rows} D=1536 bf16", entry)
        torch.cuda.empty_cache()
    with open(f"{work}/tune_questions.csv", "w") as o, open(f"{keyed}/questions.csv") as f:
        o.writelines(f.readlines()[:TUNE_QUESTIONS])
    t0 = time.perf_counter()
    tune_spar_weights.main([
        "--queries", f"{work}/tune_questions.csv", "--tsv_passages_path", f"{keyed}/passages.tsv",
        "--ctx_embeddings_dir_1", f"{work}/spar_1_only", "--ctx_embeddings_dir_2",
        f"{work}/spar_2_only", "--weights", "0.25", "0.5", "1.0", "--topk", "100",
        "--eval_on_ks", "10", "100", "--output_json", f"{work}/tune.json"])
    with open(f"{work}/tune.json") as f:
        tuned = json.load(f)
    print(f"rest (c) tools.tune_spar_weights over {n_passages} passages, {TUNE_QUESTIONS} questions: "
          f"{tuned} in {time.perf_counter() - t0:.2f} s wall")

    # ---- (d) the exporter ----
    cfg = load_config(nq, [f"task.transform.model_path={tok21}", ckpt18, *extra])
    model = build_biencoder(cfg, dev)
    t0 = time.perf_counter()
    export.export_encoder(export.EncoderTower(model), encode_batch,
                          cfg.task.transform.max_seq_len, f"{work}/exported")
    export_s = time.perf_counter() - t0
    qpath = export.save_quantized(f"{work}/int8.pt", model)
    del model
    if cuda:
        torch.cuda.empty_cache()
    state_pt = sorted(glob.glob(f"{os.path.dirname(dense_export)}/[0-9]*/state.pt"))
    with _EncodeTimer() as timer:
        runs("d encode exported", lambda: generate_embeddings.main(
            kbase + [f"task.exported_encoder_path={work}/exported",
                     f"task.ctx_embeddings_dir={work}/exported_reps"]), needs=("attention_fwd",))
        exported_rate = timer.rate()
        runs("d encode int8", lambda: generate_embeddings.main(
            kbase + [f"task.quantized_checkpoint_path={qpath}",
                     f"task.ctx_embeddings_dir={work}/int8_reps"]), needs=("attention_fwd",))
        int8_rate = timer.rate()
    runs("d queries int8", lambda: generate_embeddings.main(
        ["--queries", *kbase, f"task.quantized_checkpoint_path={qpath}",
         f"task.ctx_embeddings_dir={work}/int8_reps"]))
    eager = _load_reps(f"{work}/spar_1/reps_0000.pkl")
    got = _load_reps(f"{work}/exported_reps/reps_0000.pkl")
    int8 = _load_reps(f"{work}/int8_reps/reps_0000.pkl")
    diff = float(np.abs(got - eager).max() / np.abs(eager).max())
    cos = (int8 * eager).sum(1) / np.linalg.norm(int8, axis=1) / np.linalg.norm(eager, axis=1)
    recalls = {}
    for name, dirname in (("eager", "spar_1_only"), ("int8", "int8_reps")):
        qpath_name = f"{work}/{'spar_1' if name == 'eager' else 'int8_reps'}/query_reps.pkl"
        out = f"{work}/recall_{name}.json"
        run_retrieval.main(kbase + [f"task.ctx_embeddings_dir={work}/{dirname}",
                                    f"task.query_emb_path={qpath_name}", "task.mips_method=fused",
                                    f"task.topk={min(RETRIEVAL_K, n_passages)}",
                                    f"task.output_path={out}"])
        recalls[name] = recall_of_run(out, gold, RECALL_K)[0]
    sizes = (os.path.getsize(qpath), os.path.getsize(state_pt[0]) if state_pt else None)
    print(f"rest (d) export: torch.export of the encoder at ({encode_batch}, "
          f"{cfg.task.transform.max_seq_len}) in {export_s:.2f} s; exported vs eager embeddings "
          f"max |diff| {diff:.3g} of max |ref| (tolerance {EXPORT_REL}); int8 weights {sizes[0]} "
          f"bytes vs state.pt {sizes[1]} bytes, cosine to the fp32 weights' embeddings min "
          f"{cos.min():.6f} mean {cos.mean():.6f} (gate {QUANT_COS}); recall@{RECALL_K} eager "
          f"{recalls['eager']:.4f}, int8 {recalls['int8']:.4f}; passages/s eager {eager_rate:.1f}, "
          f"exported {exported_rate:.1f}, int8 {int8_rate:.1f}; {card}")
    if not diff <= EXPORT_REL or got.shape != eager.shape:
        raise AssertionError(f"the exported encoder's vectors differ from the eager ones: {diff}")
    if not cos.min() >= QUANT_COS:
        raise AssertionError(f"int8 weights' embeddings: cosine {cos.min()} < {QUANT_COS}")

    # ---- (e) the worker pool ----
    with _EncodeTimer() as timer:
        t0 = time.perf_counter()
        runs("e encode workers", lambda: generate_embeddings.main(
            kbase + [ckpt18, f"datamodule.num_workers={workers}",
                     f"task.ctx_embeddings_dir={work}/workers"]), needs=("attention_fwd",))
        workers_wall, workers_rate = time.perf_counter() - t0, timer.rate()
    same = open(f"{work}/workers/reps_0000.pkl", "rb").read() == \
        open(f"{work}/spar_1/reps_0000.pkl", "rb").read()
    print(f"rest (e) generate_embeddings datamodule.num_workers={workers}: shard byte-equal to "
          f"num_workers=0's: {same}; passages/s {workers_rate:.1f} (serial {eager_rate:.1f}); the "
          f"CLI {workers_wall:.2f} s wall with the pool's start; {card}")
    if not same:
        raise AssertionError("the worker pool's shard differs from the serial one")

    # ---- (f) C9: the SPLADE export through the dense CLIs ----
    splade = ["--config", nq, "--device", str(dev), f"task.transform.model_path={d20}/tok",
              f"datamodule.passages_path={d20}/passages.tsv", f"datamodule.test_path={d20}/questions.csv",
              "task.model.family=splade", f"task.checkpoint_path={splade_export}",
              f"task.ctx_embeddings_dir={work}/splade", f"datamodule.encode_batch_size={encode_batch}",
              *splade_extra]
    runs("f splade generate_embeddings", lambda: generate_embeddings.main(splade),
         needs=("attention_fwd",))
    runs("f splade queries", lambda: generate_embeddings.main(["--queries", *splade]),
         needs=("attention_fwd",))
    before = _route_delta({})
    with open(f"{d20}/passages.tsv") as f:
        kf = min(RETRIEVAL_K, sum(1 for _ in f) - 1)
    runs("f splade run_retrieval", lambda: run_retrieval.main(splade + [
        "task.mips_method=fused", f"task.topk={kf}", f"task.output_path={work}/splade.json"]),
        needs=("count_above_groups",))
    routes = _route_delta(before)
    with open(f"{work}/splade.json") as f:
        results = [row["ctxs"] for row in json.load(f)]
    from dpr_scale_tpu_torch.retrieve.retrieval import build_index

    index = build_index(f"{work}/splade", dev)
    q_splade = torch.from_numpy(_load_reps(f"{work}/splade/query_reps.pkl")).to(dev)
    check_exact(index, q_splade, results, kf)
    rows_splade, n_splade, _off = index._blocks[0]
    rows_splade = rows_splade[:n_splade]
    dim = rows_splade.shape[1]
    del index
    cfg = load_config(nq, splade[4:] + ["serve.method=fused"])
    retriever = runs("f splade /search build", lambda: serve.build_retriever(cfg, dev))
    server = make_server(retriever, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    qs = _questions(f"{d20}/questions.csv")[:SERVE_QUESTIONS]
    before = _route_delta({})
    try:
        served = runs("f splade /search", lambda: post(url, qs, kf),
                      needs=("count_above_groups",))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    served_routes = _route_delta(before)
    bad = _same_runs(_ranked(results[:len(qs)]), _ranked(served), _rel_tol(TOPK_REL))
    print(f"rest (f) SPLADE (D = {dim}): generate_embeddings, run_retrieval (fused, top-"
          f"{kf}) equal to the brute force; /search ({len(qs)} questions in one request): "
          f"{bad} disagree with run_retrieval beyond {TOPK_REL} relative (near-tie swaps "
          f"allowed); the sweeps' launches by route in run_retrieval {routes}, in /search "
          f"{served_routes}; {card}")
    if bad:
        raise AssertionError(f"/search disagrees with run_retrieval on {bad} SPLADE questions")
    if cuda:  # rows TMA cannot address (61,044 bytes): the wgmma sweep fed by cp.async
        for what, r in (("run_retrieval", routes), ("/search", served_routes)):
            groups = r["count_above_groups"]
            if not groups["wgmma_cp_async"] or any(n for k, n in groups.items()
                                                   if k != "wgmma_cp_async"):
                raise AssertionError(f"SPLADE {what}: count_above_groups left the cp.async route: "
                                     f"{groups}")
    if cuda:  # the sweeps held on this path's own vectors (non-negative), then on
        # random mixed-sign ones of the same shape
        torch.cuda.empty_cache()
        B, N = q_splade.shape[0], rows_splade.shape[0] // 256 * 256
        print(f"rest (f) the sweeps' span over N = {N} rows at B = {B}, D = {dim}: "
              f"{_sweep_span(N, B, dim)} rows (fill_span: the grid filled toward the card's SMs)")
        for what, data in ((f"B={B} N={N} D={dim} bf16, the SPLADE path's vectors",
                            (q_splade, rows_splade[:N])), (f"B={B} N={N} D={dim} bf16", None)):
            shape("count_above_groups", what, phase_count(
                dev, cases=((B, N, dim) + ((data,) if data else ()),)))
            for name, entry in phase_mips_kernels(dev, cases=(
                    (B, N, dim, "bfloat16", 256, True) + ((data,) if data else ()),)).items():
                shape(name, what, entry)
    for name, entries in shapes.items():
        for e in entries:
            e.pop("single_ms", None)
    total = runs.total()
    print(f"rest main-path launches by run: {runs.by_run}; summed {total}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if runs.missing:
        raise AssertionError(f"a kernel of the rest of the surface never launched: {runs.missing}")
    return total, shapes


# phase 22 (phase_scale): the slice that ports the index store, the host
# tiers and data-parallel training (ROADMAP A1, A5), after the wgmma sweeps'
# two-level sums (C11). (a) The four bf16 sweeps at D = WIDE_D (a multiple
# of 8: the wgmma route fed by TMA, which promotes each 64-column stage's
# sums past 1,536 columns) and at SPLADE_D (SPLADE's vocabulary, even but
# not a multiple of 8: the same loop fed by cp.async) on dense non-negative
# and on normal vectors: clear counts equal plain, maxima against fp64
# beside cuBLAS's, then the kernels timed at both widths. (b) STREAM_ROWS x 768 rows (phase 15's
# block; the script's time limit cut it from phase 16's 4,194,304) of seeded fp16
# shards: build_int8_store, then a fresh MipsIndex filled by load_int8_store
# with device_rows half the rows (half the blocks streamed from the host),
# the first search of STREAM_QUERIES questions at k = RETRIEVAL_K, batches
# of STREAM_BATCH; cold start against building the index from the shards;
# q/s streamed against all blocks on the device; the card's busy share in
# the streamed search; peak device memory; fused and groupmax with every
# block host-resident against a brute force. (c) cli.train on conf/nq.yaml
# at phase 19's batch under GradCache with trainer.strategy=ddp_sharded, in
# a world-size-1 NCCL group (DPR_* variables), against the same run
# without a group: the same losses and parameters, and its ZeRO-1
# checkpoint loaded without a group. (d) cli.sweep over two one-step runs.
# The cut: the corpus (the JAX tool's 21M rows need ~64 GB of fp32 shards
# and 16 GB of store), the steps. Two ranks need two cards: their parity
# is a CPU test (tests/test_torch_data_parallel.py).
WIDE_D, SPLADE_D = 30528, 30522
WIDE_ROWS, WIDE_TIMED_ROWS, WIDE_BATCH = 4096, 65536, 256
STREAM_ROWS, STREAM_SHARD_ROWS, STREAM_DIM = 1 << 21, 1 << 20, 768
STREAM_QUERIES, STREAM_BATCH = 1024, 256
DP_BATCH, DP_STEPS, DP_LR, DP_WARMUP = 256, 3, 1e-5, 2
DP_OVERRIDES = (*NQ_OWN, "task.grad_cache_chunks=2")
SWEEP_BATCH, SWEEP_LAYERS = 16, 2  # the sweep's runs: bert_base's width, 2 layers


def _scale_counters():
    """{name: (wrapper object, count attribute)} of phase 22's kernels."""
    from dpr_scale_tpu_torch.ops import attention
    from dpr_scale_tpu_torch.ops import int_kernels as ik
    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    return {"attention_fwd": (attention.attention_fwd_kernel, "launches"),
            "attention_fwd_dropout": (attention.attention_fwd_kernel, "dropout_launches"),
            "attention_bwd": (attention.attention_bwd_kernel, "launches"),
            "count_above_groups": (mk.count_above_groups_kernel, "launches"),
            "groupmax": (mk.groupmax_kernel, "launches"),
            "tile_max_scores": (mk.tile_max_scores_kernel, "launches"),
            "topk_candidates": (mk.topk_candidates_kernel, "launches"),
            "int_groupmax": (ik.int_groupmax_kernel, "launches")}


def _search_all(index, q, batch, k):
    """Every batch of ``q`` searched; (scores, rows) numpy, stacked."""
    import numpy as np

    parts = [index.search(q[lo : lo + batch], k) for lo in range(0, q.shape[0], batch)]
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def _as_ctxs(scores, rows):
    return [[{"id": str(int(r)), "score": float(s)} for s, r in zip(ss, rr)]
            for ss, rr in zip(scores, rows)]


def _wide_sweeps(dev, card, shape):
    """Phase 22 (a): C11's sweeps at D = WIDE_D and SPLADE_D, and each
    width's wall time."""
    import torch

    from dpr_scale_tpu_torch.tools import sweep_accuracy

    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    wall = dict.fromkeys((WIDE_D, SPLADE_D), 0.0)
    for D, route in ((WIDE_D, "wgmma"), (SPLADE_D, "wgmma_cp_async")):
        t0 = time.perf_counter()
        for kind in ("dense_nonneg", "normal"):
            before = _route_delta({})
            got = sweep_accuracy.case(kind, WIDE_BATCH, WIDE_ROWS, D, RETRIEVAL_K, g, dev)
            routes = _route_delta(before)
            print(f"scale (a) D = {D} {kind}, B = {WIDE_BATCH}, N = {WIDE_ROWS}: "
                  f"{json.dumps(got)}; routes {routes}; {card}")
            if got["route"] != route or any(n for r in routes.values() for k, n in r.items()
                                            if k != route):
                raise AssertionError(f"the D = {D} sweeps left the {route} route: {routes}")
            if got["clear_counts_differing"] or got["clear_group_counts_differing"]:
                raise AssertionError(f"D = {D} {kind}: counts differ from plain at clear "
                                     "thresholds")
            if (got["tile_max_err_kernel"]
                    > 8 * got["tile_max_err_plain"] + MAX_REL * got["max_score"]):
                raise AssertionError(f"D = {D} {kind}: tile maxima {got['tile_max_err_kernel']} "
                                     f"from fp64, cuBLAS {got['tile_max_err_plain']}")
        torch.cuda.empty_cache()
        wall[D] += time.perf_counter() - t0
    for D in (WIDE_D, SPLADE_D):
        t0 = time.perf_counter()
        what = f"B={WIDE_BATCH} N={WIDE_TIMED_ROWS} D={D} bf16"
        shape("count_above_groups", what, phase_count(dev, cases=((WIDE_BATCH, WIDE_TIMED_ROWS,
                                                                    D),), plain_reps=2))
        for name, entry in phase_mips_kernels(dev, cases=(
                (WIDE_BATCH, WIDE_TIMED_ROWS, D, "bfloat16", 4096, True),), plain_reps=2).items():
            shape(name, what, entry)
        torch.cuda.empty_cache()
        wall[D] += time.perf_counter() - t0
    print("scale (a) wall: " + ", ".join(f"D = {D} {t:.1f} s" for D, t in wall.items()))


def _write_stream_shards(embs, n_rows, shard_rows, dim, dev):
    """Seeded normal rows as fp16 ``reps_*.npy`` shards, made on ``dev``."""
    import numpy as np
    import torch

    os.makedirs(embs, exist_ok=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 62)
    for i, lo in enumerate(range(0, n_rows, shard_rows)):
        n = min(shard_rows, n_rows - lo)
        np.save(f"{embs}/reps_{i:04}.npy",
                torch.randn(n, dim, generator=g, device=dev).half().cpu().numpy())


def _stream(work, dev, card, runs, n_rows, shard_rows, dim, n_queries, batch, k):
    """Phase 22 (b): the store, cold start and streaming."""
    import numpy as np
    import torch

    from dpr_scale_tpu_torch.index import store
    from dpr_scale_tpu_torch.index.mips import HostBlock, MipsIndex
    from dpr_scale_tpu_torch.retrieve.retrieval import build_index

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    embs, st = f"{work}/stream_embs", f"{work}/stream_store"
    t0 = time.perf_counter()
    _write_stream_shards(embs, n_rows, shard_rows, dim, dev)
    t_write = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(SEED + 63)
    q = torch.randn(n_queries, dim, generator=g, device=dev)
    t0 = time.perf_counter()
    manifest = store.build_int8_store(embs, st, max_block_rows=shard_rows)
    t_store = time.perf_counter() - t0
    n_pad = manifest["blocks"][0]["n_pad"]
    half = n_pad * (len(manifest["blocks"]) // 2)
    warm = MipsIndex(dev, method="int8")  # the first search's one-time costs, paid here
    warm.add(np.zeros((2048, dim), np.float32))
    warm.search(q[:batch], k)
    del warm

    def cold(label, make):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = make()
        sync()
        t_load = time.perf_counter() - t0
        out = runs(label, lambda: _search_all(index, q, batch, k), needs=("int_groupmax",))
        sync()
        return index, out, t_load, time.perf_counter() - t0

    streamed, (s_str, i_str), load_str, first_str = cold("b store, half streamed, first search",
        lambda: _load(MipsIndex(dev, method="int8"), st, half))
    on_host = [isinstance(b, HostBlock) for b, _n, _o in streamed._blocks]
    if on_host.count(True) != len(manifest["blocks"]) - half // n_pad:
        raise AssertionError(f"device_rows={half}: host blocks {on_host}")
    built, (s_b, i_b), load_b, first_b = cold(
        "b from the shards, first search", lambda: build_index(embs, dev, method="int8",
                                                               max_block_rows=shard_rows))
    del built
    resident = _load(MipsIndex(dev, method="int8"), st, None)
    s_dev, i_dev = _search_all(resident, q, batch, k)
    _same_topk("streamed int8 vs all on the device", _as_ctxs(s_str, i_str), s_dev, i_dev)
    _same_topk("store vs built from the shards", _as_ctxs(s_b, i_b), s_dev, i_dev)

    def rate(index):
        ticks = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            _search_all(index, q, batch, k)
            sync()
            ticks.append(time.perf_counter() - t0)
        return statistics.median(ticks)

    t_dev = rate(resident)
    del resident
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_str = rate(streamed)
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    host = [b for b, _n, _o in streamed._blocks if isinstance(b, HostBlock)]
    t0 = time.perf_counter()
    for b in host:  # the uploads alone, one after another
        streamed._stream.take(streamed._stream.start(b), b)
    sync()
    t_up = time.perf_counter() - t0
    # per query batch (each search call uploads every host block once): the
    # busy share is the resident search's share of the streamed one (the
    # uploads' copies run on their own engine); "hidden" is the share of the
    # shorter of upload and search that overlapped the other (0: serial)
    n_batches = -(-n_queries // batch)
    t_dev_b, t_str_b = t_dev / n_batches, t_str / n_batches
    busy = min(t_dev_b / t_str_b, 1.0)
    hidden = max(0.0, t_dev_b + t_up - t_str_b) / max(min(t_dev_b, t_up), 1e-9)
    host_bytes = sum(b.rows.nbytes + b.row_scales.nbytes + b.col_scales.nbytes for b in host)
    print(f"scale (b) {n_rows} x {dim} rows in {len(manifest['blocks'])} blocks of {n_pad}: "
          f"shards written in {t_write:.2f} s, build_int8_store {t_store:.2f} s; cold start "
          f"(load_int8_store with device_rows={half}, then the first {n_queries} questions at "
          f"k={k}, B={batch}): {load_str:.3f} s load + {first_str - load_str:.3f} s search = "
          f"{first_str:.3f} s, against build_index from the shards {load_b:.3f} s + "
          f"{first_b - load_b:.3f} s = {first_b:.3f} s; warm search {n_queries / t_str:.1f} q/s "
          f"streamed ({len(host)} of {len(manifest['blocks'])} blocks from the host), "
          f"{n_queries / t_dev:.1f} q/s all on the device; per batch of {batch}: streamed "
          f"{t_str_b * 1e3:.2f} ms, all on the device {t_dev_b * 1e3:.2f} ms, the host blocks' "
          f"uploads alone {t_up * 1e3:.2f} ms ({host_bytes / t_up / 1e9:.2f} GB/s, staged "
          f"from a warm page cache); busy share of the streamed search (resident / streamed) "
          f"{busy:.3f}, overlap {min(hidden, 1.0):.3f} of the shorter of upload and search; peak "
          f"device memory of the streamed search {peak:.2f} GiB; streamed top-{k} equal to "
          f"all-on-device; {card}")
    del streamed
    # fused and groupmax with every block host-resident, against a brute force
    rows = torch.cat([torch.from_numpy(np.load(f"{embs}/{n}")).to(dev, torch.bfloat16)
                      for n in sorted(os.listdir(embs))])
    for method in ("fused", "groupmax"):
        index = build_index(embs, dev, method=method, host_resident=True,
                            max_block_rows=shard_rows)
        need = "count_above_groups" if method == "fused" else "groupmax"
        t0 = time.perf_counter()
        s, i = runs(f"b host-resident {method}", lambda: _search_all(index, q, batch, k),
                    needs=(need,))
        sync()
        wall = time.perf_counter() - t0
        check_exact(_rows_index(rows, torch.bfloat16), q, _as_ctxs(s, i), k)
        print(f"scale (b) host-resident {method}, {n_rows} rows bf16 streamed: "
              f"{n_queries / wall:.1f} q/s (first search), top-{k} equal to a brute force, "
              f"fallbacks {index.last_repair}; {card}")
        del index
    del rows
    shutil.rmtree(embs, ignore_errors=True)
    shutil.rmtree(st, ignore_errors=True)


def _load(index, st, device_rows):
    from dpr_scale_tpu_torch.index import store

    store.load_int8_store(index, st, device_rows=device_rows)
    return index


def _train_dp(work, dev, card, runs, batch, steps, extra, config="nq.yaml",
              overrides=DP_OVERRIDES, needs=("attention_fwd_dropout", "attention_bwd"),
              label="scale (c)"):
    """Phase 22 (c), and 23 (c) on conf/citadel.yaml: cli.train on
    ``config`` with ``overrides`` with and without a world-size-1 group."""
    import socket

    import numpy as np
    import torch

    from dpr_scale_tpu_torch.cli import train
    from dpr_scale_tpu_torch.train.checkpoint import CheckpointManager

    tok_dir, _gold = write_keyed_data(work, batch * steps, 8, min(OWN_VAL_ROWS, batch * steps))
    base = ["--config", os.path.join(ROOT, "conf", config), "--device", str(dev),
            f"task.transform.model_path={tok_dir}", f"datamodule.train_path={work}/train.jsonl",
            f"datamodule.val_path={work}/val.jsonl", f"datamodule.test_path={work}/val.jsonl",
            f"datamodule.batch_size={batch}", f"trainer.max_steps={steps}", "trainer.log_every=1",
            f"task.optim.lr={DP_LR}", f"task.warmup_steps={DP_WARMUP}", *overrides, *extra]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    walls = {}
    for name, env, more in (("plain", {}, []),
                            ("nccl", {"DPR_COORDINATOR": f"127.0.0.1:{port}",
                                      "DPR_NUM_PROCESSES": "1", "DPR_PROCESS_ID": "0"},
                             ["trainer.strategy=ddp_sharded"])):
        os.environ.update(env)
        t0 = time.perf_counter()
        try:
            runs(f"c cli.train {name}", lambda: train.main(base + more + [
                f"trainer.metrics_jsonl={work}/{name}.jsonl",
                f"checkpoint_callback.dirpath={work}/ckpt_{name}"]), needs=needs)
        finally:
            for key in env:
                os.environ.pop(key, None)
        walls[name] = time.perf_counter() - t0
    if torch.distributed.is_initialized():
        raise AssertionError("cli.train left its process group running")
    logs = {}
    for name in walls:
        with open(f"{work}/{name}.jsonl") as f:
            logs[name] = [json.loads(l)["train_loss"] for l in f if "train_loss" in l]
    states = {name: CheckpointManager(f"{work}/ckpt_{name}").restore_last() for name in walls}
    # the ZeRO-1 run's checkpoint, loaded into a state built without a group
    from dpr_scale_tpu_torch.cli.common import build_optimizer, build_task
    from dpr_scale_tpu_torch.config import load_config

    cfg = load_config(base[1], base[4:])
    task = build_task(cfg, build_optimizer(cfg, steps), dev)
    state = task.init_state(0)
    state.load_state_dict(states["nccl"])
    diffs = [(states["nccl"]["params"][n] - states["plain"]["params"][n]).abs()
             for n in states["plain"]["params"]]
    max_diff = max(d.max().item() for d in diffs)
    n_diff = sum(int((d > 0).sum()) for d in diffs)
    n_all = sum(d.numel() for d in diffs)
    moments = max((states["nccl"]["mu"][n] - states["plain"]["mu"][n]).abs().max().item()
                  for n in states["plain"]["mu"])
    print(f"{label} cli.train conf/{config}, batch {batch}, {steps} steps, "
          f"{' '.join(overrides)}: without a group {walls['plain']:.2f} s wall, losses "
          f"{logs['plain']}; NCCL world size 1 with trainer.strategy=ddp_sharded "
          f"{walls['nccl']:.2f} s, losses {logs['nccl']}; parameters after {steps} steps: "
          f"{n_diff} of {n_all} differ, max |diff| {max_diff:.3g} (lr {DP_LR}); first "
          f"moments max |diff| {moments:.3g}; the ZeRO-1 checkpoint (step "
          f"{states['nccl']['step']}) loads without a group; {card}")
    if len(logs["nccl"]) != steps or not np.allclose(logs["nccl"], logs["plain"], rtol=1e-3):
        raise AssertionError(f"NCCL run losses {logs['nccl']} vs {logs['plain']}")
    if max_diff > 2 * steps * DP_LR or n_diff > 1e-3 * n_all:
        raise AssertionError(f"NCCL run's parameters differ from the plain run's: max "
                             f"{max_diff}, {n_diff} of {n_all}")
    if "zero1_owner" in states["nccl"]:
        raise AssertionError("the ZeRO-1 checkpoint kept its partition map")
    return tok_dir


def _sweep_runs(work, dev, card, tok_dir, batch, extra):
    """Phase 22 (d): cli.sweep over two one-step runs of ``batch`` queries."""
    from dpr_scale_tpu_torch.cli import sweep

    t0 = time.perf_counter()
    results = sweep.main([
        "--config", os.path.join(ROOT, "conf", "nq.yaml"), "--sweep-dir", f"{work}/sweep",
        "--device", str(dev), "task.optim.lr=1e-5,2e-5", f"task.transform.model_path={tok_dir}",
        f"datamodule.train_path={work}/train.jsonl", f"datamodule.val_path={work}/val.jsonl",
        f"datamodule.test_path={work}/val.jsonl", f"datamodule.batch_size={batch}",
        "trainer.max_steps=1", f"task.model.num_layers={SWEEP_LAYERS}", *NQ_OWN, *extra])
    wall = time.perf_counter() - t0
    with open(f"{work}/sweep/best.json") as f:
        best = json.load(f)
    print(f"scale (d) cli.sweep over {len(results)} one-step runs of batch {batch} "
          f"({SWEEP_LAYERS} layers): "
          f"{wall:.2f} s (each its own cli.train process); metrics "
          f"{[round(m['mrr'], 4) if m else None for _i, _o, m in results]}; best run "
          f"{best['run']}; {card}")
    if len(results) != 2 or not all(m and "mrr" in m for _i, _o, m in results):
        raise AssertionError(f"a sweep run failed: {results}")


def phase_scale(work, dev, card="", n_rows=STREAM_ROWS, shard_rows=STREAM_SHARD_ROWS,
                dim=STREAM_DIM, n_queries=STREAM_QUERIES, batch=STREAM_BATCH,
                dp_batch=DP_BATCH, dp_steps=DP_STEPS, extra=(), sweep_extra=()):
    """Phase 22 on ``dev`` (see the comment above): (a) on the card only,
    (b) the store and the host tiers, (c) world-size-1 data-parallel
    training, (d) the sweep driver. The other arguments only shrink it for
    a rehearsal on the CPU. Returns (the main path's launches, the new
    shapes' kernel entries)."""
    t_phase = time.perf_counter()
    runs, shapes = _RestRuns(_scale_counters, "scale"), {}

    def shape(name, what, entry):
        entry.pop("single_ms", None)
        shapes.setdefault(name, []).append({"shape": what, **entry})

    if dev.type == "cuda":
        _wide_sweeps(dev, card, shape)
    _stream(work, dev, card, runs, n_rows, shard_rows, dim, n_queries, batch, RETRIEVAL_K)
    tok_dir = _train_dp(work, dev, card, runs, dp_batch, dp_steps, extra)
    _sweep_runs(work, dev, card, tok_dir, min(SWEEP_BATCH, dp_batch), sweep_extra)
    total = runs.total()
    print(f"scale main-path launches by run: {runs.by_run}; summed {total}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if runs.missing:
        raise AssertionError(f"a kernel of phase 22's path never launched: {runs.missing}")
    return total, shapes


# phase 23 (phase_expert_parallel): the last two modules of the port on one
# card. (a) ROADMAP A12 at phase 13's size: the 8.8M-doc index laid out over
# EP_SHARDS shards of the card and on the card alone from the same tensors,
# every search of the sharded layout against the single-device one (the
# dense combine with CLS, the sorted one without); (b) cli.citadel_retrieval
# and /search_citadel with expert_parallel on phase 20's export, the device
# list replaced in-process by EP_SHARDS x the card, against the same runs
# without it; (c) A13: cli.train on conf/citadel.yaml at its own batch in a
# world-size-1 NCCL group with ZeRO-1 against the run without a group
EP_SHARDS = 4
EP_DP_STEPS = 3
EP_SERVE_QUESTIONS = 32


def _ep_counters():
    """{name: (wrapper object, count attribute)} of phase 23's kernels."""
    from dpr_scale_tpu_torch.ops import attention
    from dpr_scale_tpu_torch.ops import gather_score as gs

    return {"attention_fwd": (attention.attention_fwd_kernel, "launches"),
            "attention_fwd_dropout": (attention.attention_fwd_kernel, "dropout_launches"),
            "attention_bwd": (attention.attention_bwd_kernel, "launches"),
            "gather_run_max": (gs.gather_run_max_kernel, "launches"),
            "gather_score_serial": (gs.gather_score_serial_kernel, "launches"),
            "gather_score_streamed": (gs.gather_score_streamed_kernel, "launches")}


def _ranked_rows(scores, rows):
    return [list(zip(d.tolist(), s.tolist())) for s, d in zip(scores, rows)]


def _ep_search(dev, card, runs, shape, shards=EP_SHARDS, n_docs=CITADEL_DOCS, plan=CITADEL_PLAN,
               batch=CITADEL_BATCH, qtokens=CITADEL_QTOKENS, dim=CITADEL_DIM,
               cls_dim=CITADEL_CLS_DIM, reps=5):
    """Phase 23 (a) on ``dev`` (the sizes only shrink for a rehearsal on the
    CPU): both layouts of phase 13's index, the sharded one's searches as a
    main-path run, each against the single-device search within
    CITADEL_SAME_REL (the same docs but for near-ties); on the card, the
    gather kernels held against plain at the shards' bucket shapes."""
    from unittest import mock

    import torch

    from dpr_scale_tpu_torch.ops import gather_score as gs

    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    (one, ep), _docs, first = _citadel_index(dev, n_docs, plan, dim, cls_dim,
                                            (None, [dev] * shards))
    if cuda:
        torch.cuda.synchronize()
    ncols = ep._tiles()[1] // shards
    print(f"expert-parallel (a) {n_docs} docs, {first} experts, on {dev} alone and over {shards} "
          f"shards of it, built in {time.perf_counter() - t0:.2f} s; experts a shard "
          f"{ {b: v['epd'] for b, v in ep.buckets.items()} }; the largest shard's accumulator "
          f"({batch}, {ncols}) fp32 = {batch * ncols * 4} bytes, one device's ({batch}, {n_docs}) "
          f"= {batch * n_docs * 4}; CLS rows a shard {ncols}")
    query, no_cls = _citadel_queries(first, batch, qtokens, dim, cls_dim)
    cases = (("with CLS", query), ("without CLS", no_cls))

    def timed(index, q):
        """(ms a search, the index's latency dict in ms a search)."""
        index.latency.clear()
        if cuda:
            ms = cuda_ms(lambda: index.search(q, 100), reps=reps, warmup=1)
        else:
            ms = host_ms(lambda: index.search(q, 100), reps=reps)
        return ms, {k: round(v / (reps + 1) * 1e3, 3) for k, v in index.latency.items()}

    want = {tag: one.search(q, 100) for tag, q in cases}
    ms_one = {tag: timed(one, q) for tag, q in cases}
    got, ms_ep, peak, plans = {}, {}, {}, {}
    import numpy as np

    def searches():
        for tag, q in cases:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            got[tag] = ep.search(q, 100)
            plans[tag] = sorted(ep.last_plan, key=lambda p: (p[3], p[0]))
            ms_ep[tag] = timed(ep, q)
            peak[tag] = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")

    runs(f"a {shards}-shard searches", searches, needs=("gather_run_max",))
    if cuda:
        one_each = runs.by_run[f"a {shards}-shard searches"]
        n_search = 2 * (reps + 2)  # each case: one search, then timed's warm-up and reps
        if (one_each["gather_run_max"] != shards * n_search or one_each["gather_score_serial"]
                or one_each["gather_score_streamed"]):
            raise AssertionError(f"the {shards}-shard searches did not launch gather_run_max "
                                 f"once a shard, and only it: {one_each}")
    for tag, _q in cases:
        if not np.isfinite(got[tag][0]).all() or got[tag][0].shape != (batch, 100):
            raise AssertionError(f"expert-parallel search {tag}: not all finite")
        bad = _same_runs(_ranked_rows(*want[tag]), _ranked_rows(*got[tag]),
                         _rel_tol(CITADEL_SAME_REL))
        diff = np.abs(got[tag][0] - want[tag][0]).max()
        print(f"expert-parallel (a) search {tag} (B={batch}, {qtokens} tokens, k=100): {shards} "
              f"shards {ms_ep[tag][0]:.3f} ms, one device {ms_one[tag][0]:.3f} ms a search "
              f"({'CUDA events' if cuda else 'host clock'} around the call; latency ms a search "
              f"{ms_ep[tag][1]} and {ms_one[tag][1]}); {bad} of {batch} queries disagree beyond {CITADEL_SAME_REL} "
              f"relative (ranked scores differ by at most {diff:.3g}); peak device memory of the "
              f"sharded searches {peak[tag]:.2f} GiB; plan (bucket, entries, scorer, shard) "
              f"{plans[tag]}; {card}")
        if bad:
            raise AssertionError(f"expert-parallel search {tag} disagrees with one device's")
    if cuda:  # the kernels at the shards' shapes: one CLS search's calls
        captured = []
        fused = gs.gather_run_max

        def record(parts, table):
            captured.append(([p._replace(q=p.q.clone(), qrows=p.qrows.clone()) for p in parts],
                             table.clone()))
            return fused(parts, table)

        with mock.patch.object(gs, "gather_run_max", record):
            ep.search(query, 100)
        held = check_run_max(captured)
        n_buckets = sum(len(parts) for parts, _t in captured)
        print(f"expert-parallel (a): gather_run_max triples equal the per-bucket route's bit for "
              f"bit on the {held} buckets of {len(captured)} shards")
        what = (f"one B={batch} CLS search's {n_buckets} buckets over {shards} shards, one "
                f"gather_run_max launch a shard (phase 23)")
        for name, entry in citadel_kernel_entries(captured).items():
            shape(name, what, entry)
        del captured
    del one, ep
    if cuda:
        torch.cuda.empty_cache()


def _served_answers(retriever, questions, k):
    """``/search_citadel``'s answers of ``retriever`` behind ``make_server``
    on a free localhost port, one request."""
    from dpr_scale_tpu_torch.retrieve.server import make_server

    server = make_server(None, "127.0.0.1", 0, citadel_retriever=retriever)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        return post(f"http://127.0.0.1:{server.server_address[1]}", questions, k,
                    "/search_citadel")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def _ep_clis(work, dev, card, runs, d20, shards=EP_SHARDS, n_questions=EP_SERVE_QUESTIONS,
             extra=()):
    """Phase 23 (b) on phase 20's directory ``d20`` (its tokenizer,
    passages, questions, export and index): cli.citadel_retrieval with the
    device index, and the cli.serve tower, each without and with
    expert_parallel over ``shards`` x ``dev`` (the device list replaced
    in-process); the expert-parallel runs are main-path runs."""
    from unittest import mock

    import torch

    from dpr_scale_tpu_torch.cli import citadel_retrieval, serve
    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.parallel import mesh

    cfg_path = os.path.join(ROOT, "conf", "citadel.yaml")
    model = [f"task.transform.model_path={d20}/tok", f"task.checkpoint_path={d20}/ckpt/params_best",
             f"datamodule.passages_path={d20}/passages.tsv", *extra]
    argv = ["--config", cfg_path, "--device", str(dev), *model,
            f"datamodule.test_path={d20}/questions.csv", f"task.ctx_embeddings_dir={d20}/index_export",
            "task.device_index=true"]
    def devices():
        return mock.patch.object(mesh, "get_mesh", lambda device, n=None: [dev] * shards)

    out = {}
    for name in ("one", "ep"):
        more = [f"task.output_trec_path={work}/{name}.trec"]
        t0 = time.perf_counter()
        if name == "one":
            out[name] = citadel_retrieval.main(argv + more)
        else:
            with devices():
                out[name] = runs(f"b cli.citadel_retrieval expert_parallel x{shards}",
                                 lambda: citadel_retrieval.main(
                                     argv + more + ["task.expert_parallel=true"]),
                                 needs=("gather_run_max",))
        out[name + "_s"] = time.perf_counter() - t0
    bad = _same_runs(_ranked(out["one"]), _ranked(out["ep"]), _rel_tol(CITADEL_SAME_REL))
    with open(f"{work}/one.trec") as a, open(f"{work}/ep.trec") as b:
        same_bytes = a.read() == b.read()
    print(f"expert-parallel (b) cli.citadel_retrieval on phase 20's export ({len(out['one'])} "
          f"questions, top-100): one device {out['one_s']:.2f} s, expert_parallel over {shards} "
          f"shards {out['ep_s']:.2f} s; {bad} queries disagree beyond {CITADEL_SAME_REL} relative; "
          f"TREC files byte-equal: {same_bytes}; {card}")
    if bad:
        raise AssertionError("cli.citadel_retrieval with expert_parallel disagrees")

    over = model + [f"serve_citadel.ctx_embeddings_dir={d20}/index_export",
                    "serve_citadel.add_cls=true", "serve_citadel.query_topk=1"]
    questions = _questions(f"{d20}/questions.csv")[:n_questions]
    plain = serve.build_citadel_retriever(load_config(cfg_path, over), dev)
    want = _ranked(_served_answers(plain, questions, 10))
    del plain
    with devices():
        sharded = serve.build_citadel_retriever(
            load_config(cfg_path, over + ["serve_citadel.expert_parallel=true"]), dev)
    if sharded.index.ndev != shards:
        raise AssertionError(f"the served index has {sharded.index.ndev} shards")
    t0 = time.perf_counter()
    got = _ranked(runs(f"b /search_citadel expert_parallel x{shards}",
                       lambda: _served_answers(sharded, questions, 10),
                       needs=("gather_run_max",)))
    ms_req = (time.perf_counter() - t0) * 1e3
    del sharded
    bad = _same_runs(want, got, _rel_tol(CITADEL_SAME_REL))
    print(f"expert-parallel (b) /search_citadel ({len(questions)} questions, k=10) with "
          f"serve_citadel.expert_parallel over {shards} shards: {ms_req:.1f} ms; {bad} disagree "
          f"with the single-device tower beyond {CITADEL_SAME_REL} relative; {card}")
    if bad:
        raise AssertionError("/search_citadel with expert_parallel disagrees")
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def phase_expert_parallel(work, dev, d20, card="", search=None, extra=(), dp_batch=TRAIN_BATCH,
                          dp_steps=EP_DP_STEPS, dp_extra=()):
    """Phase 23 on ``dev`` (see the comment above): (a) ``_ep_search`` with
    ``search`` (its keyword arguments: a rehearsal on the CPU shrinks it),
    (b) ``_ep_clis`` on phase 20's directory ``d20`` (``extra``: its model
    overrides), (c) ``_train_dp`` on conf/citadel.yaml. Returns (the main
    path's launches, the kernels' entries at the shards' shapes)."""
    t_phase = time.perf_counter()
    runs, shapes = _RestRuns(_ep_counters, "expert-parallel"), {}

    def shape(name, what, entry):
        entry.pop("single_ms", None)
        shapes.setdefault(name, []).append({"shape": what, **entry})

    _ep_search(dev, card, runs, shape, **(search or {}))
    _ep_clis(work, dev, card, runs, d20, extra=extra)
    os.makedirs(f"{work}/dp", exist_ok=True)
    _train_dp(f"{work}/dp", dev, card, runs, dp_batch, dp_steps, dp_extra, config="citadel.yaml",
              overrides=NQ_OWN, needs=(), label="expert-parallel (c)")
    total = runs.total()
    print(f"expert-parallel main-path launches by run: {runs.by_run}; summed {total}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if runs.missing:
        raise AssertionError(f"a kernel of phase 23's path never launched: {runs.missing}")
    return total, shapes


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dpr_scale_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    walls, t_last = {}, [t_start]

    def wall(label):  # the wall time since the last phase ended
        now = time.perf_counter()
        walls[label] = round(now - t_last[0], 1)
        t_last[0] = now

    smi = phase_device()
    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s:")
    print("\n".join(l for l in cuda_lib.build_log().splitlines() if "Used" in l))
    wall("device and build")
    attn = phase_attention()
    wall("attention")
    count = phase_count(torch.device("cuda", 0))
    wall("count")
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        launches = phase_slice(work, torch.device("cuda", 0))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall("slice")
    print(f"device {smi}; peak device memory of serving "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    train_kernels = phase_train_kernels()
    wall("train kernels")
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        train_launches, _stats, data = phase_train(work, torch.device("cuda", 0))
        phase_train_grads(torch.device("cuda", 0), data)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall("train")
    torch.cuda.empty_cache()
    ffn_kernels = phase_ffn_kernels()
    wall("ffn kernels")
    torch.cuda.empty_cache()
    fused_ffn = ["task.model.fused_ffn=true"]
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        ffn_launches = phase_slice(work, torch.device("cuda", 0), n_rows=FFN_INDEX_ROWS,
                                   extra=fused_ffn)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall("slice, fused ffn")
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        ffn_train_launches, _stats, data = phase_train(work, torch.device("cuda", 0),
                                                      extra=fused_ffn)
        phase_train_grads(torch.device("cuda", 0), data, extra=fused_ffn)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall("train, fused ffn")
    torch.cuda.empty_cache()
    gather_errs = phase_gather_kernels()
    wall("gather kernels")
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        citadel_launches = phase_citadel_cli(work, torch.device("cuda", 0))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall("citadel cli")
    torch.cuda.empty_cache()
    search_launches, _stats, captured = phase_citadel_search(torch.device("cuda", 0))
    wall("citadel search")
    gather = citadel_kernel_entries(captured)
    del captured
    for name, err in gather_errs.items():
        gather[name]["max_abs_err"] = max(gather[name]["max_abs_err"], err)
    for name, n in search_launches.items():
        citadel_launches[name] = citadel_launches.get(name, 0) + n
    torch.cuda.empty_cache()
    mips = phase_mips_kernels(torch.device("cuda", 0))
    wall("mips kernels")
    from dpr_scale_tpu_torch.ops.mips_kernels import topk_candidates_kernel

    pass1_tile = topk_candidates_kernel.launches_by_route["score_tile"]  # the fp32 case
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        retrieval_launches = phase_retrieval_cli(work, torch.device("cuda", 0))
        wall("retrieval cli")
        torch.cuda.empty_cache()
        int_entries = phase_int_kernels(torch.device("cuda", 0))
        wall("int kernels")
        torch.cuda.empty_cache()
        int_launches = phase_int_retrieval(work, torch.device("cuda", 0))
        wall("int retrieval")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    # phase 18's and phase 20's data and exports stay for phase 21 (and
    # phase 23 (b) searches phase 20's export after phase 22)
    work18, work20, work19, work21, work22, work23 = (
        tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build")) for _ in range(6))
    try:
        ckpt_launches = phase_checkpoint(work18, torch.device("cuda", 0))
        wall("checkpoint")
        torch.cuda.empty_cache()
        own_launches = phase_own_batch(work19, torch.device("cuda", 0), card=smi)
        wall("own batch")
        shutil.rmtree(work19, ignore_errors=True)
        torch.cuda.empty_cache()
        mv_launches = phase_multivec(work20, torch.device("cuda", 0), card=smi)
        wall("multivec")
        torch.cuda.empty_cache()
        rest_launches, rest_shapes = phase_rest(
            work21, torch.device("cuda", 0), work18, f"{work18}/ckpt_b/params_best",
            f"{work20}/ckpt/params_best", work20, f"{work20}/splade_ckpt/params_best", card=smi)
        wall("rest")
        for path in (work18, work21):
            shutil.rmtree(path, ignore_errors=True)
        torch.cuda.empty_cache()
        scale_launches, scale_shapes = phase_scale(work22, torch.device("cuda", 0), card=smi)
        wall("scale")
        shutil.rmtree(work22, ignore_errors=True)
        torch.cuda.empty_cache()
        ep_launches, ep_shapes = phase_expert_parallel(work23, torch.device("cuda", 0), work20,
                                                       card=smi)
        wall("expert parallel")
    finally:
        for path in (work18, work19, work20, work21, work22, work23):
            shutil.rmtree(path, ignore_errors=True)
    left = stop_started_processes()
    if left:
        raise RuntimeError(f"processes left running after the phases: {left}")
    print(f"phase walls (s): {walls}")
    from dpr_scale_tpu_torch.ops import mips_kernels as mk

    topk = mk.topk_candidates_kernel
    print(f"pass 1 over the script: launches by route {topk.launches_by_route} ({pass1_tile} "
          f"of them on the score tile up to phase 14: its fp32 case), "
          f"{topk.overflow_reruns} queries swept again for overflow")
    if topk.launches_by_route["score_tile"] != pass1_tile:
        raise AssertionError("a pass 1 after phase 14 took the score tile, not the wgmma loop: "
                             f"{topk.launches_by_route}, phase 14's {pass1_tile}")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"device {smi}")
    source = "dpr_scale_tpu_torch/csrc/"
    kernels = [
        {"name": "attention_fwd", "route": "cuda", "source": source + "attention_fwd.cu",
         "replaces": "dpr_scale_tpu/ops/attention.py:210",
         "launches": launches["attention_fwd"] + ckpt_launches["attention_fwd"]
         + mv_launches["attention_fwd"], **attn},
        {"name": "attention_fwd_dropout", "route": "cuda", "source": source + "attention_fwd.cu",
         "replaces": "dpr_scale_tpu/ops/attention.py:210",
         "launches": train_launches["attention_fwd_dropout"]
         + ckpt_launches["attention_fwd_dropout"] + own_launches["attention_fwd_dropout"]
         + mv_launches["attention_fwd_dropout"],
         **train_kernels["attention_fwd_dropout"]},
        {"name": "attention_bwd", "route": "cuda", "source": source + "attention_bwd.cu",
         "replaces": "dpr_scale_tpu/ops/attention.py:237",
         "launches": train_launches["attention_bwd"] + ckpt_launches["attention_bwd"]
         + own_launches["attention_bwd"] + mv_launches["attention_bwd"],
         **train_kernels["attention_bwd"]},
        {"name": "count_above_groups", "route": "cuda", "source": source + "count_groups.cu",
         "replaces": "dpr_scale_tpu/ops/mips_kernels.py:134",
         "launches": launches["count_above_groups"] + retrieval_launches["count_above_groups"]
         + ckpt_launches["count_above_groups"],
         **count},
        {"name": "ffn_fwd", "route": "cuda", "source": source + "ffn_fwd.cu",
         "replaces": "dpr_scale_tpu/ops/ffn.py:169",
         "launches": ffn_train_launches["ffn_fwd"] + own_launches["ffn_fwd"]
         + mv_launches["ffn_fwd"],
         **ffn_kernels["ffn_fwd"]},
        {"name": "ffn_ln_fwd", "route": "cuda", "source": source + "ffn_fwd.cu",
         "replaces": "dpr_scale_tpu/ops/ffn.py:387",
         "launches": ffn_launches["ffn_ln_fwd"], **ffn_kernels["ffn_ln_fwd"]},
        *({"name": name, "route": "cuda", "source": source + "gather_score.cu",
           "replaces": f"dpr_scale_tpu/index/inverted_device.py:{line}",
           "launches": citadel_launches[name] + mv_launches.get(name, 0), **gather[name]}
          for name, line in (("gather_run_max", 431), ("gather_score_serial", 431),
                             ("gather_score_pipelined", 550), ("gather_score_streamed", 648))),
        *({"name": name, "route": "cuda", "source": source + "mips_scan.cu",
           "replaces": f"dpr_scale_tpu/ops/mips_kernels.py:{line}",
           "launches": retrieval_launches.get(name, 0), **mips[name]}
          for name, line in (("count_above", 71), ("groupmax", 208), ("tile_max_scores", 242))),
        {"name": "topk_candidates", "route": "cuda", "source": source + "topk_sweep.cu",
         "replaces": "dpr_scale_tpu/index/mips.py:801",
         "launches": retrieval_launches["topk_candidates"], **mips["topk_candidates"]},
        *({"name": name, "route": "cuda", "source": source + "int_scan.cu",
           "replaces": f"tools/microbench_int4_kernel.py:{line}",
           "launches": int_launches[name], **int_entries[name]}
          for name, line in (("int8_tile_max", 111), ("int_groupmax", 160))),
    ]
    for entry in kernels:  # phases 21-23: their launches, and the kernels held at their shapes
        name = entry["name"]
        entry["launches"] += (rest_launches.get(name, 0) + scale_launches.get(name, 0)
                              + ep_launches.get(name, 0))
        held = rest_shapes.get(name, []) + scale_shapes.get(name, []) + ep_shapes.get(name, [])
        if held:
            entry["shapes"] = held
            entry["max_abs_err"] = max(entry["max_abs_err"], *(e["max_abs_err"] for e in held))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_started_processes()
    sys.exit(rc)
