"""Train/test driver of the port (counterpart of ``dpr_scale_tpu.cli.train``).

Usage:
    python -m dpr_scale_tpu_torch.cli.train --config conf/nq.yaml --device cuda:0 \\
        datamodule.train_path=nq-train.jsonl datamodule.val_path=nq-dev.jsonl \\
        trainer.max_steps=100 datamodule.batch_size=128

One device. ``task.type`` dense (the CLS bi-encoder, or SPLADE with
``task.model.family=splade``) or multivec (CITADEL / COIL / ColBERT, e.g.
``--config conf/citadel.yaml``). Weights start from ``init_params`` (seed
``seed``, default 0),
or from the params export ``task.pretrained_checkpoint_path``. With
``checkpoint_callback.dirpath`` each validation saves a checkpoint (top
``save_top_k`` on ``monitor`` / ``mode``, ``save_last``, ``async_save``),
``--resume`` continues from ``<dirpath>/last``, the test runs on the best
step, and the best step's params are exported to
``checkpoint_callback.params_export`` (default ``<dirpath>/params_best``),
which ``task.checkpoint_path`` of the encode / retrieve / serve CLIs reads
(``cli.generate_multivec_embeddings``, ``cli.citadel_retrieval`` and the
``serve_citadel`` tower for a multi-vector model).
``trainer.profile_dir`` records the training in a torch.profiler trace.
``task.grad_cache_chunks``, ``task.model.remat``, ``task.optim.name``
(adamw, adam, lamb, madgrad) and ``trainer.accumulate_grad_batches`` train
as in the JAX CLI. More than one device (``trainer.num_devices``, ROADMAP
A5), ``datamodule.num_workers`` (A8) and ``task.type=distill`` (A8) are
refused.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from dpr_scale_tpu_torch.cli.common import (
    build_datamodule,
    build_optimizer,
    build_task,
    build_tokenizer,
    check_vocab_compat,
)
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.train.checkpoint import CheckpointManager, load_params, save_params
from dpr_scale_tpu_torch.train.loop import Trainer
from dpr_scale_tpu_torch.utils.logging import MetricLogger


def _refuse_unported(cfg, device) -> None:
    tr = cfg.trainer
    # the JAX trainer runs data-parallel over num_devices devices, every
    # visible one when the key is absent or null; the port trains on one
    n = tr.get("num_devices")
    if (n is not None and n > 1) or (
        n is None and device.type == "cuda" and torch.cuda.device_count() > 1
    ):
        raise NotImplementedError(
            f"trainer.num_devices={n} with {torch.cuda.device_count()} CUDA devices "
            "visible: the port trains on one device, multi-GPU training is not "
            "ported yet (ROADMAP.md A5); set trainer.num_devices=1"
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--test-only", action="store_true")
    parser.add_argument(
        "--resume", action="store_true",
        help="restore the last checkpoint and continue training",
    )
    parser.add_argument("--metrics-out", default=None, help="final test metrics as JSON")
    parser.add_argument("--device", default=None, help="cuda:0, cpu, ... (default cuda:0, which must exist)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    device = resolve_device(args.device)
    _refuse_unported(cfg, device)

    tokenizer = build_tokenizer(cfg)
    dm = build_datamodule(cfg, tokenizer)
    tr = cfg.trainer
    max_epochs = tr.get("max_epochs", 1)
    max_steps = tr.get("max_steps")
    if max_steps:
        total_steps = max_steps
    elif args.test_only:
        total_steps = 1  # schedule unused; avoids requiring a train set
    else:
        total_steps = dm.steps_per_epoch() * max_epochs
    print(
        f"Total {total_steps} training steps, {cfg.task.get('warmup_steps', 0)} "
        f"warmup; device {device}"
    )
    task = build_task(cfg, build_optimizer(cfg, total_steps), device)
    check_vocab_compat(tokenizer, task.cfg)
    ckpt_cfg = cfg.get("checkpoint_callback") or {}
    checkpoint = None
    if ckpt_cfg.get("dirpath"):
        checkpoint = CheckpointManager(
            ckpt_cfg["dirpath"],
            monitor=ckpt_cfg.get("monitor", "mrr"),
            mode=ckpt_cfg.get("mode", "max"),
            save_top_k=ckpt_cfg.get("save_top_k", 3),
            save_last=ckpt_cfg.get("save_last", True),
            async_save=ckpt_cfg.get("async_save", False),
        )
    trainer = Trainer(
        task,
        dm,
        checkpoint=checkpoint,
        max_epochs=max_epochs,
        max_steps=max_steps,
        log_every=tr.get("log_every", 10),
        eval_every_steps=tr.get("eval_every_steps"),
        logger=MetricLogger(
            jsonl_path=tr.get("metrics_jsonl"), tensorboard_dir=tr.get("tensorboard_dir")
        ),
        profile_dir=tr.get("profile_dir"),
    )
    state = task.init_state(cfg.get("seed", 0))
    pretrained = cfg.task.get("pretrained_checkpoint_path")
    if pretrained:
        state = task.load_params(state, load_params(pretrained))
        print(f"Loaded params from {pretrained}")
    if args.resume and checkpoint is not None:
        try:
            state = checkpoint.restore_last(state)
            print(f"Resumed from last checkpoint at step {state.step}")
        except FileNotFoundError:
            print("No last checkpoint found; starting fresh")
    if args.test_only:
        metrics = trainer.test(state, restore_best=False)
    else:
        state = trainer.fit(state)
        metrics = trainer.test(state)
    print("test metrics:", metrics)
    if args.metrics_out and metrics:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)
    if checkpoint is not None and not args.test_only:
        # test() restored the best step into state (the final state when no
        # step was kept): its params are the export for the encode /
        # retrieve / serve CLIs
        export = ckpt_cfg.get("params_export") or os.path.join(ckpt_cfg["dirpath"], "params_best")
        save_params(export, state.model.state_dict())
        print(f"Exported best params to {export}")
        checkpoint.close()
    dm.close()
    return metrics


if __name__ == "__main__":
    main()
