"""Whether a training step of the port gives the same bits twice.

    python -m dpr_scale_tpu_torch.tools.determinism \
        [--config conf/citadel.yaml] [--batch 32] [--steps 2] [--strict] [overrides ...]

Run from the repository root, on one CUDA GPU (``--device cpu`` with a tiny
model only checks the script). At the config's model width (random weights
from a seed, random token sequences as ``profile_train`` lays them out) it

1. computes the step's loss and gradients twice from one state (dropout on,
   the step's own generators) and names every parameter whose gradient
   differs between the two, in the model's order, with its largest
   difference: the parameters nearest the loss that differ point at the
   operation that is not deterministic;
2. runs ``--steps`` training steps twice from the same seed on the same
   batches and counts the parameters that differ after them (what
   ``chip_smoke.py`` phase 23 (c) compares, without the process group);
3. with ``--strict``, runs one more gradient under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the first cuBLAS call) and
   prints each operation PyTorch names as having no deterministic
   implementation.

It prints one JSON object on its last line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings


def seeded_batch(task, B, L, dev, seed):
    """``B`` queries of 8-32 tokens and two contexts each of 40 tokens to
    ``L`` (ragged masks), positives at even contexts, teacher scores 0."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def tokens(n, lo, hi):
        lens = torch.randint(lo, hi + 1, (n,), generator=g, device=dev)
        ids = torch.randint(5, task.cfg.vocab_size, (n, L), generator=g, device=dev)
        mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        return ids * mask, mask

    q_ids, q_mask = tokens(B, min(8, L), min(32, L))
    c_ids, c_mask = tokens(2 * B, min(40, L), L)
    return {"query_ids": q_ids, "query_mask": q_mask, "contexts_ids": c_ids,
            "contexts_mask": c_mask, "pos_ctx_indices": torch.arange(B, device=dev) * 2,
            "ctx_mask": torch.zeros(2 * B, dtype=torch.bool, device=dev),
            "scores": torch.zeros(B, 2, device=dev)}


def build(config, overrides, dev):
    """(task, its max_seq_len) of ``config`` with ``overrides`` on ``dev``."""
    from dpr_scale_tpu_torch.cli.common import build_optimizer, build_task
    from dpr_scale_tpu_torch.config import load_config

    cfg = load_config(config, list(overrides))
    task = build_task(cfg, build_optimizer(cfg, 1000), dev)
    return task, cfg.task.transform.get("max_seq_len", 256)


def gradients(task, state, batch):
    """(loss, gradients) of one step's dropout, the state left as it was."""
    from dpr_scale_tpu_torch.train.multivec import step_dropout_rng

    rng = step_dropout_rng(state.dropout_seed, state.step, task.device, False)
    loss, _metrics, grads = task.loss_and_grads(state, batch, rng)
    return loss.detach().clone(), [g.detach().clone() for g in grads]


def differing(names, a, b):
    """[(name, count of elements that differ, max |diff|)] where a and b differ."""
    out = []
    for name, x, y in zip(names, a, b):
        d = (x.float() - y.float()).abs()
        n = int((x != y).sum())
        if n:
            out.append((name, n, float(d.max())))
    return out


def trained_params(config, overrides, dev, B, steps, seed):
    """The parameters after ``steps`` seeded steps of a fresh state, and the
    wall time of each step (ms, synchronised)."""
    import torch

    task, L = build(config, overrides, dev)
    state = task.init_state(seed)
    ms = []
    for s in range(steps):
        batch = seeded_batch(task, B, L, dev, seed + 1 + s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        task.train_step(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}, ms


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="conf/citadel.yaml")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--strict", action="store_true")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if args.strict:  # read by cuBLAS at its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("determinism: no CUDA device", file=sys.stderr)
        return 1
    task, L = build(args.config, args.overrides, dev)
    state = task.init_state(args.seed)
    names = [n for n, _ in state.model.named_parameters()]
    batch = seeded_batch(task, args.batch, L, dev, args.seed + 1)
    (la, ga), (lb, gb) = gradients(task, state, batch), gradients(task, state, batch)
    grads = differing(names, ga, gb)
    out = {"config": args.config, "batch": args.batch, "loss_equal": bool(torch.equal(la, lb)),
           "gradients_differing": len(grads), "of": len(names),
           "first_differing": grads[:12]}
    print(f"gradients twice from one state: loss {la.item()!r} / {lb.item()!r}; "
          f"{len(grads)} of {len(names)} parameters' gradients differ")
    for name, n, d in grads:
        print(f"  {name}: {n} elements, max |diff| {d:.3g}")
    del ga, gb
    pa, ms_a = trained_params(args.config, args.overrides, dev, args.batch, args.steps, args.seed)
    pb, ms_b = trained_params(args.config, args.overrides, dev, args.batch, args.steps, args.seed)
    params = differing(list(pa), list(pa.values()), list(pb.values()))
    n_all = sum(p.numel() for p in pa.values())
    out.update(steps=args.steps, params_differing=sum(n for _, n, _ in params), params_of=n_all,
               params_max_diff=max((d for _, _, d in params), default=0.0),
               step_ms=ms_a + ms_b)
    print(f"{args.steps} steps twice from seed {args.seed}: "
          f"{out['params_differing']} of {n_all} parameters differ, max |diff| "
          f"{out['params_max_diff']:.3g}; step ms {[round(m, 2) for m in ms_a + ms_b]}")
    if args.strict:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gradients(task, state, batch)
        ops = sorted({str(w.message).split("\n")[0] for w in caught
                      if "deterministic" in str(w.message)})
        torch.use_deterministic_algorithms(False)
        out["nondeterministic_ops"] = ops
        print("operations without a deterministic implementation: " + (json.dumps(ops) or "none"))
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
