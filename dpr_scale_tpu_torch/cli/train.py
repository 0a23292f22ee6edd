"""Train/test driver of the port (counterpart of ``dpr_scale_tpu.cli.train``).

Usage:
    python -m dpr_scale_tpu_torch.cli.train --config conf/nq.yaml --device cuda:0 \\
        datamodule.train_path=nq-train.jsonl datamodule.val_path=nq-dev.jsonl \\
        trainer.max_steps=100 datamodule.batch_size=128

One device. Weights start from ``init_params`` (seed ``seed``, default 0);
checkpoints, ``--resume`` and ``task.pretrained_checkpoint_path`` are not
ported yet (ROADMAP.md A5) and are refused.
"""
from __future__ import annotations

import argparse
import json
import os

from dpr_scale_tpu.config import load_config
from dpr_scale_tpu.utils.logging import MetricLogger
from dpr_scale_tpu_torch.cli.common import (
    build_datamodule,
    build_optimizer,
    build_task,
    build_tokenizer,
    check_vocab_compat,
)
from dpr_scale_tpu_torch.device import resolve_device
from dpr_scale_tpu_torch.train.loop import Trainer


def _refuse_unported(cfg, args) -> None:
    if args.resume:
        raise NotImplementedError(
            "--resume needs checkpoints, which the port does not have yet "
            "(ROADMAP.md A5)"
        )
    if cfg.get("checkpoint_callback", {}).get("dirpath"):
        raise NotImplementedError(
            "checkpoint_callback.dirpath is set, but the port has no checkpoint "
            "manager yet (ROADMAP.md A5); unset it"
        )
    if cfg.task.get("pretrained_checkpoint_path"):
        raise NotImplementedError(
            "task.pretrained_checkpoint_path: the port cannot read orbax "
            "checkpoints yet (ROADMAP.md A5 and the exporter in A1); unset it"
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--test-only", action="store_true")
    parser.add_argument("--resume", action="store_true", help="not ported yet")
    parser.add_argument("--metrics-out", default=None, help="final test metrics as JSON")
    parser.add_argument("--device", default=None, help="cuda:0, cpu, ... (default cuda:0, which must exist)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    _refuse_unported(cfg, args)
    device = resolve_device(args.device)

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
    trainer = Trainer(
        task,
        dm,
        max_epochs=max_epochs,
        max_steps=max_steps,
        log_every=tr.get("log_every", 10),
        eval_every_steps=tr.get("eval_every_steps"),
        logger=MetricLogger(jsonl_path=tr.get("metrics_jsonl")),
    )
    state = task.init_state(cfg.get("seed", 0))
    if not args.test_only:
        state = trainer.fit(state)
    metrics = trainer.test(state)
    print("test metrics:", metrics)
    if args.metrics_out and metrics:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)
    dm.close()
    return metrics


if __name__ == "__main__":
    main()
