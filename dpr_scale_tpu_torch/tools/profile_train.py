"""Where the device time goes in one training step of the port.

    python -m dpr_scale_tpu_torch.tools.profile_train \
        [--config conf/nq.yaml] [--batch 128] [--out FILE] [overrides ...]

Run from the repository root, on one CUDA GPU (``--device cpu`` with a tiny
model only checks the script). At the config's model width (conf/nq.yaml:
bert_base, L = 256, bf16, fused attention, dropout 0.1; random weights from
a seed) it times and profiles the task's ``train_step`` on random token
sequences with ragged masks: ``--batch`` queries of 8-32 tokens and two
contexts per query of 40 tokens to L, as the datamodule lays them out
(num_negative 1), teacher scores 0. ``--config conf/citadel.yaml``
profiles the multi-vector task's step (L = 128). It prints, as ``profile_serve`` does, the host-clock wall
time of one step, the device kernel time of one step, the busy share and
the kernel time by class, then the peak device memory; a step that does not
fit the card prints the allocator's out-of-memory message and the peak
reached before it. The override ``task.model.fused_ffn=true`` profiles the
fused-FFN configuration, ``task.grad_cache_chunks=N`` the GradCache step,
``task.model.arch=bert_large task.model.remat=true`` bert_large's.
"""
from __future__ import annotations

import argparse
import sys

import torch

from dpr_scale_tpu_torch.cli.common import build_optimizer, build_task
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.tools.profile_serve import SEED, report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="conf/nq.yaml")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--out", default=None, help="file for the profiler tables")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    cfg = load_config(args.config, args.overrides)
    task = build_task(cfg, build_optimizer(cfg, 1000), dev)
    state = task.init_state(SEED)
    L = cfg.task.transform.get("max_seq_len", 256)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def tokens(B, lo, hi):
        lens = torch.randint(lo, hi + 1, (B,), generator=g, device=dev)
        ids = torch.randint(5, task.cfg.vocab_size, (B, L), generator=g, device=dev)
        mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        return ids * mask, mask

    B = args.batch
    q_ids, q_mask = tokens(B, min(8, L), min(32, L))
    c_ids, c_mask = tokens(2 * B, min(40, L), L)
    batch = {
        "query_ids": q_ids, "query_mask": q_mask,
        "contexts_ids": c_ids, "contexts_mask": c_mask,
        "pos_ctx_indices": torch.arange(B, device=dev) * 2,
        "ctx_mask": torch.zeros(2 * B, dtype=torch.bool, device=dev),
        "scores": torch.zeros(B, 2, device=dev),
    }
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = open(args.out, "w") if args.out else None
    try:
        report(f"train step, {B} queries + {2 * B} contexts, L={L}",
               lambda: task.train_step(state, batch), dev, out)
    except torch.cuda.OutOfMemoryError as err:
        print(f"train step, {B} queries + {2 * B} contexts, L={L}: out of device memory: "
              f"{str(err).splitlines()[0]}")
    finally:
        if out is not None:
            out.close()
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(dev)}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
