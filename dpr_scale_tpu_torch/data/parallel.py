"""Multiprocess batch building: JSONL parse, sampling and tokenization in
worker processes, feeding the training loop or the corpus encoder through
the prefetch queue.

The port's copy of ``dpr_scale_tpu/data/parallel.py``. Each worker
rebuilds a serial datamodule from a spec (memory-mapped datasets reopen
from their cached offset index; the tokenizer from ``HFTokenizer.spec``,
since the wrapper holds a ``threading.local`` and cannot be pickled) and
assembles whole batches; results stream back in order.

Start method: **forkserver**, not fork. The parent holds a CUDA context and
threads (the prefetch threads, the tokenizer's pool); a child forked from it
would inherit both. The forkserver's server process is a fresh
single-threaded interpreter, so children fork from a thread-free image.
Workers never touch CUDA: each one hides every device
(``CUDA_VISIBLE_DEVICES=""``) before it builds anything, so nothing it
imports can initialise a context on the card. Workers use numpy and the
Rust tokenizer only.

The server and multiprocessing's resource tracker outlive every pool: left
to themselves they end only after this process has exited, as orphans.
``stop_worker_processes`` stops the live pools, then both helpers, and waits
for each; it runs at interpreter exit once a pool has started.
"""
from __future__ import annotations

import atexit
import gc
import multiprocessing as mp
import os
import weakref
from collections import deque
from multiprocessing import forkserver, resource_tracker
from typing import Callable, Iterable, Iterator

_STATE: dict = {}
_LIVE: weakref.WeakSet = weakref.WeakSet()
_AT_EXIT: list = []


def stop_worker_processes() -> None:
    """Stop every process the pools of this process started and wait for
    each: the live pools' workers, then the forkserver's server, then the
    resource tracker (which ends when its last writer, the server included,
    has closed). A later pool starts both helpers anew."""
    for pool in list(_LIVE):
        pool.close()
    # the stdlib's own stop: close the pipe each helper waits on, then reap it
    forkserver._forkserver._stop()
    gc.collect()  # the closed pools' semaphores unregister from the tracker
    resource_tracker._resource_tracker._stop()


def _init_worker(factory: Callable, spec) -> None:
    # no CUDA in a worker: hidden before anything can initialise it
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # HF tokenizers disables its internal thread pool after a fork with a
    # loud warning; batch-level parallelism comes from the workers instead
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
    _STATE["obj"] = factory(spec)


def _run(payload):
    method, args = payload
    return getattr(_STATE["obj"], method)(*args)


class WorkerPool:
    """A forkserver pool whose workers each hold an object rebuilt by
    ``factory(spec)``."""

    # modules the server imports once, when it starts, besides the factory's
    # and ``__main__``; each worker forks with them loaded (the tokenizer
    # stack takes seconds to import)
    preload = ("transformers.models.auto.tokenization_auto",)

    def __init__(self, num_workers: int, factory: Callable, spec):
        try:
            ctx = mp.get_context("forkserver")
            ctx.set_forkserver_preload(["__main__", factory.__module__, *self.preload])
        except ValueError:  # a platform without forkserver
            ctx = mp.get_context("spawn")
        if not _AT_EXIT:  # before multiprocessing's own exit hook, which leaves both helpers
            _AT_EXIT.append(atexit.register(stop_worker_processes))
        self._pool = ctx.Pool(num_workers, initializer=_init_worker, initargs=(factory, spec))
        self._workers = num_workers
        _LIVE.add(self)

    def imap(self, method: str, args_list: Iterable[tuple], ahead: int = 0) -> Iterator:
        """Ordered, pipelined map of ``obj.method(*args)`` over the workers.

        At most ``ahead`` tasks are in flight (default twice the workers): a
        plain ``Pool.imap`` buffers finished results without bound, which
        for an epoch-sized iterator means the whole epoch in host memory."""
        ahead = ahead or 2 * self._workers
        pending: deque = deque()
        for args in args_list:
            pending.append(self._pool.apply_async(_run, ((method, args),)))
            if len(pending) >= ahead:
                yield pending.popleft().get()
        while pending:
            yield pending.popleft().get()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None  # and with it the queues' semaphores
        _LIVE.discard(self)

    def __del__(self):
        try:
            if self._pool is not None:
                self._pool.terminate()
        except Exception:
            pass
