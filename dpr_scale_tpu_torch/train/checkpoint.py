"""Checkpoints of the port: top-k on a metric, an always-kept last state,
and the params-only export the encode / retrieve / serve CLIs read.

Counterpart of :mod:`dpr_scale_tpu.train.checkpoint` in the port's own
format (orbax needs jax):

  * ``<directory>/<step>/`` holds ``state.pt`` (``torch.save`` of the state
    dict: the fp32 master parameters keyed by name, the optimizer's name
    and its per-parameter state keyed by the same names (AdamW / lamb
    ``mu`` / ``nu``, madgrad's sums and ``x0``, an accumulator), its
    counters, ``step``, ``dropout_seed``) and ``metrics.json``;
  * ``<directory>/last/state/`` holds the newest save in the same layout
    (its ``state.pt`` a hard link to the step's when that step was kept);
  * a params export (``save_params``) is a directory holding ``params.pt``,
    a state dict of the model.

Every directory is written under a ``.tmp`` name and renamed into place, so
a process killed in the middle of a write leaves the previous save whole:
``last/state`` moves to ``last/state.old`` only once ``last/state.tmp`` is
complete, and ``restore_last`` reads ``state.old`` when ``state`` is
missing. Files are read with ``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from dpr_scale_tpu_torch.models.convert import from_jax_params

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
PARAMS_FILE = "params.pt"


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _write_dir(path: str, host_state: Mapping, metrics: Mapping,
               link: Optional[str] = None) -> None:
    """A fresh directory ``path`` holding ``state.pt`` (a hard link to the
    file ``link`` where given, else ``host_state`` serialized) and
    ``metrics.json``."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    if link is None:
        torch.save(host_state, os.path.join(path, STATE_FILE))
    else:
        os.link(link, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, METRICS_FILE), "w") as f:
        json.dump(metrics, f)


class CheckpointManager:
    """Saves at each validation, keeps the ``save_top_k`` best steps on
    ``monitor`` (``mode`` "max" or "min") and, with ``save_last``, the
    newest state under ``last/``.

    ``save`` takes a :class:`~dpr_scale_tpu_torch.train.task.TrainState` (or
    anything with ``state_dict()``, or a mapping of tensors and ints). It
    copies the state to host memory before it returns, since the train step
    updates the state's tensors in place; with ``async_save`` the disk write
    then runs on a thread. One save is in flight at a time, and the readers
    (``best_step``, ``restore``, ``restore_last``, ``close``) wait for it.
    A failed async save raises at the next barrier, naming its step.
    """

    def __init__(
        self,
        directory: str,
        monitor: str = "mrr",
        mode: str = "max",
        save_top_k: int = 3,
        save_last: bool = True,
        async_save: bool = False,
    ):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', not {mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.async_save = async_save
        # a save without the monitored metric ranks as the WORST value for
        # the mode, never as the best (dpr_scale_tpu/train/checkpoint.py)
        self._worst = float("-inf") if mode == "max" else float("inf")
        self._last_dir = os.path.join(self.directory, "last")
        self._steps: Dict[int, Dict[str, float]] = {}
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name, METRICS_FILE)
            if name.isdigit() and os.path.exists(path):
                with open(path) as f:
                    self._steps[int(name)] = json.load(f)
        self._host: Dict[str, torch.Tensor] = {}  # snapshot buffers, reused
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self._pending_step: Optional[int] = None

    # ------------------------------------------------------------------ #
    # retention: orbax's BestN over the steps in step order

    def _ranked(self, steps: Dict[int, Mapping]) -> List[int]:
        """Steps from worst to best. A stable sort, as orbax's: of equal
        values the later step ranks better."""
        return [
            s for s, _ in sorted(
                sorted(steps.items()),
                key=lambda item: item[1].get(self.monitor, self._worst),
                reverse=self.mode == "min",
            )
        ]

    def _kept(self, steps: Dict[int, Mapping]) -> List[int]:
        """The steps that stay on disk. ``save_top_k <= 0`` keeps none, as
        the JAX manager's orbax options do (only ``last`` is written)."""
        if self.save_top_k <= 0:
            return []
        return sorted(self._ranked(steps)[-self.save_top_k:])

    # ------------------------------------------------------------------ #

    def _snapshot(self, state) -> Dict[str, Any]:
        """A host copy of ``state``'s state dict in buffers that outlive the
        call (pinned when the tensors are on a GPU): device -> host copies
        on the current stream, then one synchronize."""
        sd = state.state_dict() if hasattr(state, "state_dict") else state
        out: Dict[str, Any] = {}
        on_cuda = []

        def copy(key, value):
            if not isinstance(value, torch.Tensor):
                return value
            buf = self._host.get(key)
            if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
                buf = torch.empty(value.shape, dtype=value.dtype,
                                  pin_memory=value.is_cuda)
                self._host[key] = buf
            if value.is_cuda:
                on_cuda.append(value.device)
            return buf.copy_(value.detach(), non_blocking=value.is_cuda)

        for key, value in sd.items():
            if isinstance(value, Mapping):
                out[key] = {k: copy(f"{key}/{k}", v) for k, v in value.items()}
            else:
                out[key] = copy(key, value)
        for device in set(on_cuda):
            torch.cuda.current_stream(device).synchronize()
        return out

    def save(self, step: int, state, metrics: Optional[Mapping[str, float]] = None) -> None:
        """Save ``state`` as step ``step`` with its validation ``metrics``.
        With ``async_save`` a failure of the previous save raises here, after
        this save has been scheduled."""
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        earlier: Optional[BaseException] = None
        try:
            self.wait()
        except RuntimeError as err:  # the previous async save failed
            earlier = err
        host = self._snapshot(state)
        if not self.async_save:
            self._save_host(step, host, metrics)
            return

        def _bg():
            try:
                self._save_host(step, host, metrics)
            except BaseException as err:  # raised at the next barrier
                self._pending_error = err

        self._pending_step = step
        self._pending = threading.Thread(target=_bg, name=f"ckpt-save-{step}", daemon=True)
        self._pending.start()
        if earlier is not None:
            raise earlier

    def _save_host(self, step: int, host_state: Mapping, metrics: Dict[str, float]) -> None:
        steps = {**self._steps, step: metrics}
        kept = self._kept(steps)
        written = None
        if step in kept:  # a step that does not rank is never written
            path = os.path.join(self.directory, str(step))
            _write_dir(path + ".tmp", host_state, metrics)
            shutil.rmtree(path, ignore_errors=True)
            os.rename(path + ".tmp", path)
            written = os.path.join(path, STATE_FILE)
        for s in sorted(steps):
            if s not in kept:
                shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)
        self._steps = {s: steps[s] for s in kept}
        if self.save_last:
            self._write_last(host_state, {**metrics, "step": step}, written)

    def _write_last(self, host_state: Mapping, metrics: Mapping,
                    written: Optional[str] = None) -> None:
        """Replace ``last/state`` so that a kill at any point leaves a whole
        save: the new one lands in ``state.tmp``, the old one stays as
        ``state.old`` until the rename. A state just ``written`` to its step
        directory is hard-linked, not serialized again; the link keeps the
        file when that step is evicted."""
        os.makedirs(self._last_dir, exist_ok=True)
        dst = os.path.join(self._last_dir, "state")
        tmp, old = dst + ".tmp", dst + ".old"
        _write_dir(tmp, host_state, metrics, link=written)
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(dst):
            os.rename(dst, old)
        os.rename(tmp, dst)
        shutil.rmtree(old, ignore_errors=True)

    def wait(self) -> None:
        """Barrier on the in-flight async save (no-op when idle). Its failure
        raises here once, as a RuntimeError naming the step."""
        t, self._pending = self._pending, None
        if t is not None:
            t.join()
        if self._pending_error is not None:
            err, self._pending_error = self._pending_error, None
            raise RuntimeError(
                f"async checkpoint save of step {self._pending_step} under "
                f"{self.directory} failed: {err!r}"
            ) from err

    # ------------------------------------------------------------------ #

    def all_steps(self) -> List[int]:
        self.wait()
        return sorted(self._steps)

    def best_step(self) -> Optional[int]:
        self.wait()
        ranked = self._ranked(self._steps)
        return ranked[-1] if ranked else None

    @staticmethod
    def _into(state_like, loaded):
        if state_like is not None and hasattr(state_like, "load_state_dict"):
            state_like.load_state_dict(loaded)
            return state_like
        return loaded

    def restore(self, state_like=None, step: Optional[int] = None):
        """Load the best step (or ``step``) into ``state_like`` in place and
        return it; without one (or for a plain mapping) return the loaded
        state dict."""
        self.wait()
        step = step if step is not None else self.best_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        loaded = _load(os.path.join(self.directory, str(step), STATE_FILE))
        return self._into(state_like, loaded)

    def restore_last(self, state_like=None):
        """Load ``last/state`` (or ``last/state.old``, left by a kill during
        the write) like :meth:`restore`."""
        self.wait()
        path = os.path.join(self._last_dir, "state")
        if not os.path.isdir(path) and os.path.isdir(path + ".old"):
            path += ".old"
        path = os.path.join(path, STATE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no last checkpoint under {self._last_dir}")
        return self._into(state_like, _load(path))

    def close(self) -> None:
        self.wait()


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Params-only export: ``path/params.pt``, the model's state dict on
    the host (what ``task.checkpoint_path`` and
    ``task.pretrained_checkpoint_path`` read)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A model state dict from a params export directory (``save_params``),
    or from a ``.npz`` of a Flax params tree with ``/``-joined keys (what
    ``tools/orbax_params_to_npz.py`` writes from a JAX export). Raises
    ``FileNotFoundError`` when ``path`` holds neither."""
    if path.endswith(".npz") and os.path.isfile(path):
        with np.load(path) as flat:
            return from_jax_params(_unflatten({k: flat[k] for k in flat.files}))
    file = os.path.join(path, PARAMS_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(
            f"no params export at {path!r}: expected a directory holding "
            f"{PARAMS_FILE} (train/checkpoint.save_params) or a .npz of a Flax "
            "params tree (tools/orbax_params_to_npz.py)"
        )
    return _load(file)
