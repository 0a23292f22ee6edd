"""One rank of the data-parallel CPU tests (``test_torch_data_parallel.py``,
``test_torch_multivec_parallel.py``).

    DPR_COORDINATOR=127.0.0.1:<port> DPR_NUM_PROCESSES=2 DPR_PROCESS_ID=<r> \\
        python tests/torch_dp_worker.py <spec.pt> <out.pt>

Starts a gloo group through ``parallel.launch``, runs every case of the
spec (a few training steps of the dense, distill or multi-vector task on
each rank's slice of the spec's global batch) and, on rank 0, saves each case's
losses, gradient norms, parameters and whole optimizer state. The test
process runs the same :func:`run_case` alone for the single-process
reference. Imports no jax.
"""
from __future__ import annotations

import sys

import torch

from dpr_scale_tpu_torch.optim.factory import make_optimizer
from dpr_scale_tpu_torch.parallel import launch, mesh
from dpr_scale_tpu_torch.train.distill import DPRDistillTask
from dpr_scale_tpu_torch.train.multivec import MultiVecRetrieverTask
from dpr_scale_tpu_torch.train.schedule import linear_warmup_decay
from dpr_scale_tpu_torch.train.task import DenseRetrieverTask


def build_task(spec, case):
    opt = make_optimizer(case.get("optim", "adamw"),
                         linear_warmup_decay(base_lr=1e-3, warmup_steps=1, total_steps=10),
                         weight_decay=0.01, grad_clip_norm=0.5,
                         accumulate_steps=case.get("accumulate", 1))
    if case.get("zero1"):
        opt = mesh.Zero1(opt)
    cfg = spec["cfg_dropout"] if case.get("dropout") else spec["cfg"]
    if case.get("task") == "distill":
        return DPRDistillTask(cfg=cfg, optimizer=opt)
    if case.get("task") == "multivec":
        return MultiVecRetrieverTask(cfg=cfg, optimizer=opt, grad_cache_chunks=case.get("chunks", 1),
                                     **case["multivec"])
    return DenseRetrieverTask(cfg=cfg, optimizer=opt, grad_cache_chunks=case.get("chunks", 1))


def run_case(spec, case, load=None):
    """``case["steps"]`` steps from the spec's weights (or the state dict
    ``load``, a checkpoint of any world size) on this rank's slice of the
    global batch, at ``case["epoch"]`` (default 0). The spec's keys
    ``state_dict`` and ``batch`` by default, ``distill_*`` for the distill
    task, or the case's ``state_key`` / ``batch_key``. Returns losses, grad
    norms, every other metric and the state dict (gathered whole: every
    rank calls this)."""
    task = build_task(spec, case)
    prefix = "distill_" if case.get("task") == "distill" else ""
    state = task.init_state(state_dict=spec[case.get("state_key", prefix + "state_dict")])
    if load is not None:
        state.load_state_dict(load)
    batch = spec[case.get("batch_key", prefix + "batch")]
    losses, norms, metrics = [], [], []
    for _ in range(case["steps"]):
        local, sharded = mesh.shard_batch(batch)
        dev = task.to_device(local)
        if sharded:
            dev[mesh.SHARDED] = True
        state, m = task.train_step(state, dev, case.get("epoch", 0.0))
        losses.append(float(m["train_loss"]))
        norms.append(float(m["grad_norm"]))
        metrics.append({k: float(v) for k, v in m.items()})
    sd = state.state_dict()
    host = {k: ({n: t.detach().clone() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in sd.items()}
    return {"loss": losses, "grad_norm": norms, "metrics": metrics, "state": host}


def masks_differ(seed=0, step=3):
    """Whether the ranks' dropout draws of one step differ (they must)."""
    rng = mesh.step_dropout_rng(seed, step, "cpu", sharded=True).fold(0)
    draw = torch.rand(64, generator=rng.device)
    both = mesh.all_gather_cat(draw).view(mesh.world_size(), -1)
    return not torch.equal(both[0], both[1])


def main(spec_path, out_path):
    launch.maybe_initialize_distributed(device="cpu", timeout_s=120)
    spec = torch.load(spec_path, weights_only=False)
    out = {"world": mesh.world_size(), "masks_differ": masks_differ()}
    for case in spec["cases"]:
        out[case["name"]] = run_case(spec, case, spec.get("loads", {}).get(case["name"]))
    if mesh.is_main():
        torch.save(out, out_path)
    launch.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
