"""Process-group start for data-parallel training (counterpart of
:mod:`dpr_scale_tpu.parallel.launch`; the reference's SLURM / submitit
launcher, SURVEY.md §2.9).

The coordinator, the number of processes and each process's id come from
the environment, as in the JAX package:

    DPR_COORDINATOR=host:port DPR_NUM_PROCESSES=2 DPR_PROCESS_ID=0 \\
        python -m dpr_scale_tpu_torch.cli.train ...

or from torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK`` (``torchrun --nproc-per-node 8 -m dpr_scale_tpu_torch.cli.train
...``). The backend is NCCL on CUDA devices and gloo when the caller asks
for the CPU. With nothing configured, :func:`maybe_initialize_distributed`
does nothing and the run trains alone. A run configured for several
processes that fails to start its group raises: it never falls back to
training alone, where every process would train the whole data with the
same seed (a wrong global batch, colliding checkpoints) and nothing would
fail. On SLURM map DPR_PROCESS_ID=$SLURM_PROCID,
DPR_NUM_PROCESSES=$SLURM_NTASKS, DPR_COORDINATOR=<first node>:<port>.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

INIT_TIMEOUT_S = 1800.0


def _int_env(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else None


def configured() -> Optional[tuple]:
    """(coordinator "host:port", world size, rank) from the environment:
    the DPR_* variables first, then torchrun's; None when neither is set."""
    coordinator = os.environ.get("DPR_COORDINATOR")
    if coordinator:
        return coordinator, _int_env("DPR_NUM_PROCESSES"), _int_env("DPR_PROCESS_ID")
    if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        return coordinator, _int_env("WORLD_SIZE"), _int_env("RANK")
    return None


def maybe_initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = INIT_TIMEOUT_S,
) -> bool:
    """Start ``torch.distributed`` when configured (arguments first, then
    the environment); returns True if it did, False with nothing configured
    or a group already running. ``device``: a CUDA device (the default)
    takes NCCL and is set to the process's local rank; ``"cpu"`` takes
    gloo."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    env = configured()
    if coordinator is None and env is not None:
        coordinator, env_n, env_id = env
        num_processes = num_processes or env_n
        process_id = process_id if process_id is not None else env_id
    if coordinator is None:
        return False
    if num_processes is None or process_id is None:
        raise RuntimeError(
            f"coordinator {coordinator} is set but the number of processes ({num_processes}) "
            f"or this process's id ({process_id}) is not: set DPR_NUM_PROCESSES and "
            "DPR_PROCESS_ID (or torchrun's WORLD_SIZE and RANK)"
        )
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo" if cpu else "nccl"
    if not cpu:
        local = _int_env("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else process_id % torch.cuda.device_count())
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=int(num_processes),
            rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s),
        )
    except Exception as e:  # noqa: BLE001 -- any failure refuses the run
        raise RuntimeError(
            f"the run is configured for {num_processes} processes (coordinator "
            f"{coordinator}, this is process {process_id}) but the {backend} process group "
            "failed to start; refusing to fall back to training alone. Fix the coordinator "
            f"or unset DPR_COORDINATOR / MASTER_ADDR for a single-process run. Cause: {e}"
        ) from e
    return True


def shutdown() -> None:
    """Destroy the process group this process started, if any."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
