"""Profiling hooks, the port of gnn_rag_tpu/utils/profiling.py (the
reference has none, SURVEY.md §5).

``trace(logdir, device)`` runs ``torch.profiler.profile`` over its block and
writes a Chrome/TensorBoard trace (``*.pt.trace.json``) into ``logdir``: CPU
activity always, CUDA activity when ``device`` is a CUDA device (the
caller's device, not a probe of the machine). A falsy ``logdir`` makes it a
no-op. ``annotate(name)`` marks a host region (``record_function``);
``StepTimer`` aggregates wall-clock per named phase.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: Optional[str], device="cuda"):
    """Device trace context; no-op when logdir is falsy."""
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    return record_function(name)


class StepTimer:
    """Accumulates wall-clock per phase; report() -> {phase: (total_s, n)}."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, tuple]:
        return {k: (round(self.totals[k], 4), self.counts[k])
                for k in sorted(self.totals)}
