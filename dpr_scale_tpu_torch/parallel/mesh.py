"""Device lists and data-parallel helpers (counterpart of
:mod:`dpr_scale_tpu.parallel.mesh`).

Two kinds of parallelism, as in the JAX package:

  * expert parallelism, in one process: :func:`get_mesh` is the list of
    ``torch.device``s an expert-parallel index
    (``index.inverted_device.DeviceExpertIndex(mesh=...)``) shards its
    experts and its accumulator columns over. The JAX package runs that
    search as one single-controller ``shard_map`` program over its mesh, and
    the HTTP server is one process, so the port's "mesh" is a plain list:
    the process launches each shard's work on its device and moves tensors
    between them with ``Tensor.to``. A device may repeat (several shards on
    one card, or on the CPU, as the JAX tests force 8 CPU devices);
  * data parallelism over ``torch.distributed``, one process (rank) a
    device. The reference trains with NCCL DDP, an all_gather of the
    embeddings with the local slice spliced back in so that it keeps its
    graph (dpr_scale/task/dpr_task.py:163-196), and fairscale's ZeRO
    sharding of the optimizer state (``trainer.strategy: ddp_sharded``);
    the JAX package does the same as one SPMD program over a device mesh.
    Here each rank holds a replica of the parameters:

      - :func:`shard_batch`: each rank takes its contiguous slice of every
        global batch (a batch whose leading axes do not divide by the world
        size is replicated, as the JAX rule does);
      - :func:`gather_splice`: the embeddings of every rank, this rank's
        slice being its own tensor with its graph, so the loss over the
        global score matrix back-propagates into this rank's encoder alone;
        each rank then holds its share of the gradient, and
        :func:`all_reduce_sum` adds them into the single-process gradient of
        the global batch;
      - :class:`Zero1`: ZeRO-1, the optimizer state partitioned across ranks
        by whole parameters (the semantics of ``ZeroRedundancyOptimizer``
        and fairscale's OSS): each rank updates the parameters it owns and
        then broadcasts them.

    At world size 1 (or without a process group) every helper is the
    identity.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

SHARDED = "sharded"  # set on a device batch that is this rank's slice of the global one
ZERO1_KEY = "zero1_owner"  # a ZeRO-1 optimizer state: the rank owning each parameter


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def get_mesh(device=None, n: Optional[int] = None) -> List[torch.device]:
    """The devices an expert-parallel index shards over (the JAX
    ``get_mesh``: every local device, or the first ``n``). For a CUDA
    ``device`` (the default, ``cuda:0``) every visible CUDA device, or the
    first ``n``; for any other device, ``n`` (default 1) shards of it."""
    from dpr_scale_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        return [device] * (1 if n is None else n)
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devices if n is None else devices[:n]


def world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def is_main() -> bool:
    """True on the rank that logs, checkpoints and writes results."""
    return rank() == 0


def local_device(device) -> torch.device:
    """This rank's device: on CUDA the one :func:`launch.maybe_initialize_distributed`
    made current (the local rank), else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and _dist() is not None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_batch(batch: Mapping, world: Optional[int] = None,
                at: Optional[int] = None) -> Tuple[Mapping, bool]:
    """(this rank's slice of a global numpy batch, sharded?). Every array
    with a leading axis is cut into ``world`` contiguous slices and the
    rank keeps slice ``rank``; a batch with a leading axis that does not
    divide comes back whole (replicated: every rank computes all of it)."""
    world = world_size() if world is None else world
    at = rank() if at is None else at
    arrays = {k: v for k, v in batch.items() if getattr(v, "ndim", 0) >= 1}
    if world == 1 or any(v.shape[0] % world for v in arrays.values()):
        return batch, False
    out = dict(batch)
    for k, v in arrays.items():
        n = v.shape[0] // world
        out[k] = v[at * n : (at + 1) * n]
    return out, True


def step_dropout_rng(seed: int, step: int, device, sharded: bool):
    """The dropout randomness of a training step: with a sharded batch each
    rank folds its rank in first, so that the ranks' slices draw
    independent masks (equal masks would correlate the global batch)."""
    from dpr_scale_tpu_torch.models.transformer import DropoutRng

    rng = DropoutRng(seed, step, device)
    return rng.fold(rank()) if sharded else rng


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order (no gradient)."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return x
    src = x.detach().contiguous()
    if src.dtype == torch.bool:  # not every backend reduces bools
        return all_gather_cat(src.to(torch.uint8)).bool()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts)


def gather_splice(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_gather_cat` with this rank's part replaced by ``x`` itself,
    so the result carries ``x``'s graph (the other parts are constants)."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return x
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    parts[dist.get_rank()] = x
    return torch.cat(parts)


def all_reduce_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The ranks' tensors summed element-wise, in place (one flat buffer a
    dtype, one collective each)."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1 or not tensors:
        return tensors
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        torch._foreach_copy_(group, [p.view_as(t) for p, t in
                                     zip(flat.split([t.numel() for t in group]), group)])
    return tensors


def distributed_global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm`` of the union of every rank's ``tensors`` (each
    rank holding a disjoint part, as ZeRO-1's owned parameters)."""
    dev = tensors[0].device if tensors else torch.device("cpu")
    sq = (torch.stack([t.float().square().sum() for t in tensors]).sum() if tensors
          else torch.zeros((), device=dev))
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1:
        dist.all_reduce(sq)
    return sq.sqrt()


def partition(params: Sequence[torch.Tensor], world: int) -> List[int]:
    """The rank owning each parameter: the largest first, each to the rank
    with the fewest elements so far (the lowest rank on ties), as
    ``ZeroRedundancyOptimizer`` balances them; deterministic, so every rank
    computes the same map."""
    load = [0] * world
    owner = [0] * len(params)
    for i in sorted(range(len(params)), key=lambda i: (-params[i].numel(), i)):
        r = min(range(world), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += params[i].numel()
    return owner


class Zero1:
    """ZeRO-1 around one of the port's optimizers (``optim.factory``): the
    state of the parameters this rank owns (:func:`partition`) and nothing
    else. :meth:`update` takes the full, all-reduced gradients and their
    global norm (the clip sees the whole gradient before the partitioned
    step); the inner optimizer updates the owned parameters (a Lamb trust
    ratio stays per whole parameter), then each owner broadcasts its
    parameters. Under ``MultiSteps`` the clip of the accumulated mean takes
    its norm across ranks (:func:`distributed_global_norm`). The state dict
    carries the owner map under ``ZERO1_KEY``; ``TrainState.state_dict``
    gathers the partitions into a whole checkpoint, which loads at any
    world size."""

    def __init__(self, inner, world: Optional[int] = None, at: Optional[int] = None):
        self.inner = inner
        self.world = world_size() if world is None else world
        self.rank = rank() if at is None else at
        self.name = inner.name
        base = getattr(inner, "inner", inner)  # MultiSteps' optimizer
        if self.world > 1:
            base.norm = distributed_global_norm
        self.owner: Optional[List[int]] = None

    def init(self, params: List[torch.Tensor]) -> Dict:
        self.owner = partition(params, self.world)
        state = self.inner.init(self.owned(params))
        state[ZERO1_KEY] = tuple(self.owner)
        return state

    def owned(self, items: Sequence) -> list:
        return [x for x, o in zip(items, self.owner) if o == self.rank]

    def applied_lr(self, state: Dict) -> float:
        return self.inner.applied_lr(state)

    @torch.no_grad()
    def update(self, params, grads, state: Dict, g_norm: Optional[torch.Tensor] = None) -> None:
        self.inner.update(self.owned(params), self.owned(grads), state, g_norm)
        dist = _dist()
        if dist is not None and self.world > 1:
            for p, o in zip(params, self.owner):
                dist.broadcast(p.data, src=o)


def gather_zero1(values: List[torch.Tensor], owner: Sequence[int],
                 params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A ZeRO-1 per-parameter state list (this rank's owned entries, in
    parameter order) made whole on every rank: each owner broadcasts its
    entries. A collective: every rank calls it."""
    dist = _dist()
    me = rank()
    it = iter(values)
    out = []
    for p, o in zip(params, owner):
        t = next(it) if o == me else torch.empty_like(p)
        if dist is not None and dist.get_world_size() > 1:
            dist.broadcast(t, src=o)
        out.append(t)
    return out

