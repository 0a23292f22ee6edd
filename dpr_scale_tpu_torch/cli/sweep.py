"""Multirun sweep driver (counterpart of :mod:`dpr_scale_tpu.cli.sweep`;
the reference's ``python main.py -m``).

The reference sweeps hyperparameters with hydra multirun and the submitit
SLURM launcher (dpr_scale/main.py:32, conf/trainer/slurm.yaml:16-27):
``key=a,b key2=x,y`` expands into the cross product, one training run per
combination, each in its own output directory. Here each combination runs
in turn as its own ``python -m dpr_scale_tpu_torch.cli.train`` subprocess
(crash isolation, a fresh CUDA context) on the local host; an external
scheduler can fan one sweep out over jobs with ``--run-index``.

Usage:
    python -m dpr_scale_tpu_torch.cli.sweep --config conf/nq.yaml \
        --sweep-dir sweep task.optim.lr=1e-5,3e-5 \
        datamodule.batch_size=16,32 [--monitor mrr] [--dry-run] [--device cuda:0]

Every override value containing a comma becomes a sweep axis (a bracketed
or braced value is one value); plain overrides pass through to every run.
``--device`` is handed to each run. The best run by ``--monitor`` goes to
``<sweep-dir>/best.json``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
from typing import List, Tuple


def expand_overrides(overrides: List[str]) -> Tuple[List[List[str]], List[str]]:
    """Split overrides into sweep axes (comma-valued) and constants.

    Returns (runs, axis_keys) where runs is the cross product, each a full
    override list. Bracketed values (``k=[a,b]``) are NOT treated as axes.
    """
    axes = []  # list of (key, [values])
    constants = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        key, val = ov.split("=", 1)
        if "," in val and not (val.startswith("[") or val.startswith("{")):
            axes.append((key, val.split(",")))
        else:
            constants.append(ov)
    if not axes:
        return [list(constants)], []
    runs = []
    for combo in itertools.product(*(vals for _k, vals in axes)):
        runs.append(constants + [f"{k}={v}" for (k, _), v in zip(axes, combo)])
    return runs, [k for k, _ in axes]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--sweep-dir", required=True)
    parser.add_argument(
        "--monitor", default="mrr", help="test-metric key used to rank runs"
    )
    parser.add_argument(
        "--mode", default="max", choices=("max", "min"), help="monitor direction"
    )
    parser.add_argument(
        "--run-index", type=int, default=None,
        help="execute only this sweep index (for external schedulers that "
        "fan one sweep out across jobs, like the reference's submitit array)",
    )
    parser.add_argument("--dry-run", action="store_true", help="print the plan only")
    parser.add_argument("--device", default=None, help="handed to every run's cli.train")
    parser.add_argument("overrides", nargs="*", help="key=val or key=v1,v2 axes")
    args = parser.parse_args(argv)

    runs, axis_keys = expand_overrides(args.overrides)
    os.makedirs(args.sweep_dir, exist_ok=True)
    print(f"sweep: {len(runs)} runs over axes {axis_keys or '(none)'}")

    selected = range(len(runs)) if args.run_index is None else [args.run_index]
    results = []
    for idx in selected:
        run_dir = os.path.join(args.sweep_dir, f"run_{idx:03d}")
        metrics_path = os.path.join(run_dir, "metrics.json")
        cmd = [
            sys.executable,
            "-m",
            "dpr_scale_tpu_torch.cli.train",
            "--config",
            args.config,
            "--metrics-out",
            metrics_path,
            *(["--device", args.device] if args.device else []),
            *runs[idx],
            f"checkpoint_callback.dirpath={os.path.join(run_dir, 'ckpt')}",
            f"trainer.metrics_jsonl={os.path.join(run_dir, 'metrics.jsonl')}",
        ]
        print(f"[run {idx}] {' '.join(runs[idx]) or '(base config)'}")
        if args.dry_run:
            results.append((idx, runs[idx], None))
            continue
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "cmd.txt"), "w") as f:
            f.write(" ".join(cmd) + "\n")
        proc = subprocess.run(cmd)
        metrics = None
        if proc.returncode != 0:
            print(f"[run {idx}] FAILED rc={proc.returncode}")
        elif os.path.exists(metrics_path):
            with open(metrics_path) as f:
                metrics = json.load(f)
        results.append((idx, runs[idx], metrics))

    if args.dry_run:
        return results

    if args.run_index is not None:
        # fan-out mode: this job ran ONE run, but best.json must describe
        # the whole sweep — re-read every peer run's metrics.json, so the
        # last finisher leaves the true sweep-wide best behind (a single
        # job's own result alone would overwrite best.json with whichever
        # run finished last, e.g. the worst lr)
        ranked = []
        for idx in range(len(runs)):
            mp = os.path.join(args.sweep_dir, f"run_{idx:03d}", "metrics.json")
            m = None
            if os.path.exists(mp):
                with open(mp) as f:
                    m = json.load(f)
            ranked.append((idx, runs[idx], m))
        missing = sum(1 for _i, _o, m in ranked if not m)
        if missing:
            print(f"(fan-out: {missing}/{len(runs)} runs have no metrics yet)")
    else:
        ranked = results

    scored = [
        (idx, ovs, m) for idx, ovs, m in ranked if m and args.monitor in m
    ]
    print("\n=== sweep summary ===")
    for idx, ovs, m in ranked:
        val = m.get(args.monitor) if m else None
        print(f"run_{idx:03d} {' '.join(ovs):60s} {args.monitor}={val}")
    if scored:
        best = (max if args.mode == "max" else min)(
            scored, key=lambda r: r[2][args.monitor]
        )
        print(
            f"best: run_{best[0]:03d} ({' '.join(best[1])}) "
            f"{args.monitor}={best[2][args.monitor]}"
        )
        best_path = os.path.join(args.sweep_dir, "best.json")
        tmp = best_path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "run": best[0],
                    "overrides": best[1],
                    "metrics": best[2],
                    "monitor": args.monitor,
                    "runs_scored": len(scored),
                    "runs_total": len(runs),
                },
                f,
                indent=2,
            )
        os.replace(tmp, best_path)
    return results


if __name__ == "__main__":
    main()
