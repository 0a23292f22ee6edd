"""Profiling: torch.profiler traces and per-stage wall-clock accounting
(counterpart of :mod:`dpr_scale_tpu.utils.profiling`). Usage:

    with trace_if("/tmp/trace"):             # no-op when dir is falsy
        run_training()

    timer = StageTimer()
    with timer.stage("encode"):
        ...
    print(timer.summary())

``trace_if`` records host operations and, where CUDA is available, device
kernels, and writes one Chrome trace (``trace.json``, viewable in Perfetto
or ``chrome://tracing``) into the directory when the block ends. The
profiler may drop some of the port's own kernels from the device timeline;
time those with CUDA events around each launch
(``ops.cuda_lib.timed_launches``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str]):
    """Capture a torch.profiler trace into ``trace_dir/trace.json`` when
    ``trace_dir`` is set; otherwise a no-op."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


class StageTimer:
    """Accumulating wall-clock per named stage (device work must be
    synchronised by the caller for accurate numbers)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }

    def __str__(self) -> str:
        return " ".join(
            f"{k}={v['total_s']:.2f}s/{v['count']}x" for k, v in self.summary().items()
        )
