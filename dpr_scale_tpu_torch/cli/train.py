"""Train/test driver of the port (counterpart of ``dpr_scale_tpu.cli.train``).

Usage:
    python -m dpr_scale_tpu_torch.cli.train --config conf/nq.yaml --device cuda:0 \\
        datamodule.train_path=nq-train.jsonl datamodule.val_path=nq-dev.jsonl \\
        trainer.max_steps=100 datamodule.batch_size=128

One device a process. ``task.type`` dense (the CLS bi-encoder, or SPLADE with
``task.model.family=splade``), multivec (CITADEL / COIL / ColBERT, e.g.
``--config conf/citadel.yaml``) or distill (a query encoder regressing onto
teacher vectors, ``--config conf/distill.yaml``). Weights start from ``init_params`` (seed
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
as in the JAX CLI; ``datamodule.num_workers`` worker processes build the
batches.

Data parallel, one process a device: a process group configured in the
environment (``DPR_COORDINATOR`` / ``DPR_NUM_PROCESSES`` /
``DPR_PROCESS_ID``, or torchrun's variables; :mod:`..parallel.launch`) is
started first, NCCL on CUDA devices, gloo with ``--device cpu``. Without
one, ``trainer.num_devices`` > 1 (or absent / null with several CUDA
devices visible, as the JAX trainer takes every visible device) makes this
process rank 0 of a group it starts on ``localhost`` and launches the other
ranks with the same arguments. Every rank trains on its slice of each
global batch of ``datamodule.batch_size``; rank 0 logs, checkpoints, tests
and writes ``--metrics-out``. ``trainer.strategy: ddp_sharded`` (or
``zero1``) partitions the optimizer state (ZeRO-1). Every task trains so,
the multi-vector one on the global batch's routing statistics.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

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
from dpr_scale_tpu_torch.parallel import launch
from dpr_scale_tpu_torch.parallel.mesh import Zero1, is_main, local_device, world_size
from dpr_scale_tpu_torch.train.checkpoint import CheckpointManager, load_params, save_params
from dpr_scale_tpu_torch.train.loop import Trainer
from dpr_scale_tpu_torch.utils.logging import MetricLogger


def num_processes(cfg, device) -> int:
    """The processes (one a device) a run trains on: ``trainer.num_devices``;
    absent or null, every visible CUDA device, as the JAX trainer takes
    every visible device (one on the CPU)."""
    n = cfg.trainer.get("num_devices")
    if n is not None:
        return int(n)
    return max(torch.cuda.device_count(), 1) if device.type == "cuda" else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_ranks(argv, n: int, device) -> list:
    """Start ranks 1 .. n - 1 of a group on localhost running this CLI with
    ``argv``, then join it as rank 0. Returns the child processes."""
    coordinator = f"127.0.0.1:{_free_port()}"
    children = []
    for i in range(1, n):
        env = dict(os.environ, DPR_COORDINATOR=coordinator, DPR_NUM_PROCESSES=str(n),
                   DPR_PROCESS_ID=str(i), LOCAL_RANK=str(i))
        children.append(subprocess.Popen(
            [sys.executable, "-m", "dpr_scale_tpu_torch.cli.train", *argv], env=env))
    try:
        launch.maybe_initialize_distributed(coordinator, n, 0, device=device)
    except BaseException:
        _stop(children)
        raise
    return children


def _stop(children) -> None:
    for child in children:
        if child.poll() is None:
            child.kill()
        child.wait()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
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
    children = []
    started = launch.maybe_initialize_distributed(device=device)
    if not started and world_size() == 1 and num_processes(cfg, device) > 1:
        children = _launch_ranks(argv, num_processes(cfg, device), device)
        started = True
    try:
        metrics = _run(cfg, args, local_device(device))
        if children:
            _stop_when_done(children)
        return metrics
    except BaseException:
        _stop(children)
        raise
    finally:
        if started:
            launch.shutdown()


def _stop_when_done(children) -> None:
    codes = [child.wait() for child in children]
    if any(codes):
        raise RuntimeError(f"ranks 1..{len(children)} of the run exited with {codes}")


def _run(cfg, args, device):
    n = cfg.trainer.get("num_devices")
    if n is not None and int(n) != world_size():
        raise ValueError(
            f"trainer.num_devices={n} but the process group has {world_size()} processes"
        )
    zero1 = cfg.trainer.get("strategy", "ddp") in ("ddp_sharded", "zero1")
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
        f"warmup; device {device}, {world_size()} process(es)"
    )
    optimizer = build_optimizer(cfg, total_steps)
    task = build_task(cfg, Zero1(optimizer) if zero1 else optimizer, device)
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
    if not is_main():  # rank 0 tests, writes the metrics and exports
        dm.close()
        return metrics
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
