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
     (B=128, 12 heads, L=256, head_dim 64, bf16, ragged key masks);
  3. group-count kernel vs its plain version at B=64, N=1,048,576, D=768
     bf16, thresholds at each query's 99.99th score percentile;
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
     times;
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
     attention (TF32 off): the losses and every parameter's gradient
     (cosine) must agree.

Weights and data are made from fixed seeds. Needs a CUDA device; exits
non-zero without one, or when any check fails. The last two lines of
standard output are a JSON object of per-kernel results and a JSON object
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
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
# phase 7 (phase_train_grads): GRAD_SEEDS weight seeds, each with its own
# batch, weights at GRAD_WEIGHT_STD. The loss (10-31 there) is a logsumexp
# minus a gold score, each in the hundreds, and any change of bf16 rounding
# order moves it by up to 2% on an H100 (the paths without the kernels
# included); a kernel that drops a term or a mask moves the loss by
# multiples or the gradient cosines far below 0.99. Per seed, the kernel
# path against the same model with the plain versions on the card and
# against fp32 plain attention: the loss within LOSS_REL, every cosine
# at least GRAD_COS.
LOSS_REL = 2e-2
GRAD_COS = 0.99
GRAD_SEEDS = 4
GRAD_WEIGHT_STD = 0.05


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
    for mod in ("transformers", "tokenizers", "yaml"):
        try:
            probe[mod] = importlib.import_module(mod).__version__
        except ImportError:
            probe[mod] = None
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; packages {probe}")
    return smi


def phase_attention():
    import torch

    from dpr_scale_tpu_torch.ops import attention

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    B, nh, L, hd = 128, 12, 256, 64
    q, k, v = (
        torch.randn(B, nh, L, hd, generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)
    )
    lens = torch.randint(16, L + 1, (B,), generator=g, device=dev)
    lens[0] = L
    bias = (torch.arange(L, device=dev)[None, :] >= lens[:, None]).float() * -1e9
    bias = bias[:, None, :].contiguous()
    out = attention.attention_fwd_kernel(q, k, v, bias)
    torch.cuda.synchronize()
    ref = attention.attention_plain(q, k, v, bias)
    err = (out.float() - ref.float()).abs()
    bad = (err > ATTN_ATOL + ATTN_RTOL * ref.float().abs()).sum().item()
    max_err = err.max().item()
    ms = cuda_ms(lambda: attention.attention_fwd_kernel(q, k, v, bias))
    plain_ms = cuda_ms(lambda: attention.attention_plain(q, k, v, bias))
    print(
        f"attention_fwd (B={B} nh={nh} L={L} hd={hd} bf16): max_abs_err {max_err:.3g}, "
        f"{bad} outside {ATTN_ATOL}+{ATTN_RTOL}|ref|; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
    )
    if bad or not torch.isfinite(out).all():
        raise AssertionError("attention kernel disagrees with its plain version")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_count():
    import torch

    from dpr_scale_tpu_torch.ops import mips_kernels

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, N, D = 64, 1 << 20, 768
    q = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
    corpus = torch.randn(N, D, generator=g, device=dev).to(torch.bfloat16)
    scores = torch.cat([
        q.float() @ corpus[lo : lo + 131072].float().T for lo in range(0, N, 131072)
    ], dim=1)
    tau = torch.topk(scores, N // 10000 + 1, dim=1).values[:, -1].contiguous()  # p99.99
    del scores
    out = mips_kernels.count_above_groups_kernel(q, corpus, tau)
    torch.cuda.synchronize()
    plain = mips_kernels.count_above_groups_plain(q, corpus, tau)
    m = COUNT_MARGIN_REL * tau.abs()
    lo = mips_kernels.count_above_groups_plain(q, corpus, tau + m)
    hi = mips_kernels.count_above_groups_plain(q, corpus, tau - m)
    diff = (out - plain).abs().max().item()
    out_of_band = ((out < lo) | (out > hi)).sum().item()
    ms = cuda_ms(lambda: mips_kernels.count_above_groups_kernel(q, corpus, tau))
    plain_ms = cuda_ms(lambda: mips_kernels.count_above_groups_plain(q, corpus, tau))
    print(
        f"count_above_groups (B={B} N={N} D={D} bf16, tau p99.99): "
        f"{(out != plain).sum().item()} counts differ (max {diff}), {out_of_band} outside "
        f"the {COUNT_MARGIN_REL} relative margin of tau; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
    )
    if out_of_band or out.shape != (B, N // 256):
        raise AssertionError("count kernel disagrees with its plain version")
    return {"max_abs_err": float(diff), "ms": ms, "plain_ms": plain_ms}


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


def check_exact(index, q, results, k):
    """Served ids against a brute-force fp32-accumulated top-k over the
    index's own bf16 rows; swaps only among scores within TOPK_REL of the
    k-th best."""
    import torch

    s = torch.cat([
        q.to(index.dtype).float() @ emb[:n].float().T for emb, n, _off in index._blocks
    ], dim=1)
    best = torch.topk(s, k, dim=1)
    for b, ctxs in enumerate(results):
        ids = [int(c["id"]) for c in ctxs]
        kth = best.values[b, -1].item()
        tol = TOPK_REL * abs(kth)
        true = s[b, torch.tensor(ids, device=s.device)]
        served = torch.tensor([c["score"] for c in ctxs], device=s.device)
        if len(ids) != k or len(set(ids)) != k:
            raise AssertionError(f"query {b}: {len(ids)} ids, {len(set(ids))} distinct, k={k}")
        if ((served - true).abs() > TOPK_REL * true.abs() + 1e-6).any():
            raise AssertionError(f"query {b}: served scores differ from brute force")
        if (true < kth - tol).any():
            raise AssertionError(f"query {b}: served a row below the exact k-th score")
        missed = set(best.indices[b].tolist()) - set(ids)
        if any(s[b, j].item() > kth + tol for j in missed):
            raise AssertionError(f"query {b}: missed an exact top-{k} row")


def phase_slice(work, dev, n_rows=1 << 20, n_encoded=4096, extra=()):
    """The serving slice on ``dev``; ``n_rows``/``n_encoded``/``extra``
    config overrides only shrink it for a rehearsal on the CPU."""
    import numpy as np
    import torch

    from dpr_scale_tpu.config import load_config
    from dpr_scale_tpu_torch.cli import generate_embeddings, serve
    from dpr_scale_tpu_torch.cli.common import build_biencoder, build_tokenizer
    from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder
    from dpr_scale_tpu_torch.ops import attention, mips_kernels
    from dpr_scale_tpu_torch.retrieve.server import make_server

    rng = np.random.default_rng(SEED)
    words = [f"w{i}" for i in range(30522 - 5)]
    tok_dir, tsv, embs = (os.path.join(work, n) for n in ("tok", "passages.tsv", "embs"))
    write_tokenizer(tok_dir, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
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

    attention.attention_fwd_kernel.launches = 0
    mips_kernels.count_above_groups_kernel.launches = 0
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
    cfg = load_config(cfg_path, overrides)
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
        "task.model.dtype=float32", "task.model.fused_attention=false"])
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
    fwd_ms = cuda_ms(lambda: attention.attention_fwd_kernel(q, k, v, bias, seed, 0.1))
    fwd_plain = cuda_ms(lambda: attention.attention_plain(q, k, v, bias, seed, 0.1))
    bwd_ms = cuda_ms(lambda: attention.attention_bwd_kernel(q, k, v, bias, go, seed, 0.1))
    bwd_plain = cuda_ms(lambda: attention.attention_bwd_plain(q, k, v, bias, go, seed, 0.1))
    bwd0_ms = cuda_ms(lambda: attention.attention_bwd_kernel(q, k, v, bias, go, seed, 0.0))
    bwd0_plain = cuda_ms(lambda: attention.attention_bwd_plain(q, k, v, bias, go, seed, 0.0))
    print(f"B={B}: seed repeats and varies; rate 0.1: forward kernel {fwd_ms:.4f} ms, plain "
          f"{fwd_plain:.4f} ms; backward kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms; "
          f"rate 0: backward kernel {bwd0_ms:.4f} ms, plain {bwd0_plain:.4f} ms")
    return {
        "attention_fwd_dropout": {"max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain},
        "attention_bwd": {"max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain},
    }


def phase_train_kernels():
    """Phase 5: both training kernels against their plain versions at the
    shapes phase 6 gives them, the contexts' batch (2 x TRAIN_BATCH) and
    the queries' (TRAIN_BATCH), both padded to L = 256; returns the errors
    (the larger of the two) and the contexts' times."""
    import torch

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
    from dpr_scale_tpu_torch.ops import attention

    rng = np.random.default_rng(SEED + 4)
    words = [f"w{i}" for i in range(30522 - 5)]
    tok_dir = os.path.join(work, "tok")
    write_tokenizer(tok_dir, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
    train_path, val_path = os.path.join(work, "train.jsonl"), os.path.join(work, "val.jsonl")
    write_dpr_jsonl(train_path, rng, words, batch_size * steps)
    write_dpr_jsonl(val_path, rng, words, batch_size)
    data = [f"task.transform.model_path={tok_dir}", f"datamodule.train_path={train_path}",
            f"datamodule.val_path={val_path}", *extra]
    log = os.path.join(work, "metrics.jsonl")
    argv = ["--config", os.path.join(ROOT, "conf", "nq.yaml"), "--device", str(dev), *data,
            f"datamodule.test_path={val_path}", "datamodule.num_test_negative=10",
            f"trainer.max_steps={steps}", f"datamodule.batch_size={batch_size}",
            "trainer.log_every=1", f"trainer.metrics_jsonl={log}"]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    attention.attention_fwd_kernel.dropout_launches = 0
    attention.attention_bwd_kernel.launches = 0
    t0 = time.perf_counter()
    test = train.main(argv)
    wall = time.perf_counter() - t0
    launches = {"attention_fwd_dropout": attention.attention_fwd_kernel.dropout_launches,
                "attention_bwd": attention.attention_bwd_kernel.launches}

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


def phase_train_grads(dev, data, seeds=GRAD_SEEDS):
    """Phase 7: the loss and gradients of one batch of 16 queries and 32
    contexts, dropout 0, at each of ``seeds`` weight seeds (each with its
    own batch), through four paths from the same weights:

    * "kernel bf16": the model as phase 6 trains it, through the kernels;
    * "fused plain bf16": the same model with the wrappers' plain versions
      on the card, which round where the kernels round;
    * "unfused bf16": the einsum attention path;
    * "plain fp32": unfused attention in fp32, TF32 off.

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
    from contextlib import nullcontext
    from unittest import mock

    import torch

    from dpr_scale_tpu.config import load_config
    from dpr_scale_tpu_torch.cli.common import build_datamodule, build_task, build_tokenizer
    from dpr_scale_tpu_torch.models.convert import init_params
    from dpr_scale_tpu_torch.ops import attention
    from dpr_scale_tpu_torch.optim.factory import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    common = [*data, "datamodule.batch_size=16", "task.model.hidden_dropout=0",
              "task.model.attention_dropout=0"]
    cfg_path = os.path.join(ROOT, "conf", "nq.yaml")
    cfgs = {"kernel bf16": load_config(cfg_path, common),
            "unfused bf16": load_config(cfg_path, common + ["task.model.fused_attention=false"]),
            "plain fp32": load_config(cfg_path, common + [
                "task.model.dtype=float32", "task.model.fused_attention=false"])}
    dm = build_datamodule(cfgs["kernel bf16"], build_tokenizer(cfgs["kernel bf16"]))
    batches = list(itertools.islice(dm.train_batches(0), seeds))
    dm.close()
    if len(batches) < seeds:
        raise AssertionError(f"{len(batches)} training batches of 16 for {seeds} seeds")
    tasks = {n: build_task(c, make_optimizer(), dev) for n, c in cfgs.items()}
    states = {n: t.init_state(SEED) for n, t in tasks.items()}
    plain_on_card = mock.patch.object(attention, "_dispatch", lambda q, kernel, plain: plain)
    paths = {"kernel bf16": ("kernel bf16", nullcontext()),
             "fused plain bf16": ("kernel bf16", plain_on_card),
             "unfused bf16": ("unfused bf16", nullcontext()),
             "plain fp32": ("plain fp32", nullcontext())}
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
            state.model.load_state_dict(weights)
            with ctx:
                l, g = task.loss_and_grads(state, task.to_device(batch))
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dpr_scale_tpu_torch.ops import cuda_lib

    smi = phase_device()
    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s:")
    print("\n".join(l for l in cuda_lib.build_log().splitlines() if "Used" in l))
    attn = phase_attention()
    count = phase_count()
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
         "launches": launches["count_above_groups"], **count},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
