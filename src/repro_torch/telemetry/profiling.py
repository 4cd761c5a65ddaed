"""Profiling hooks for ad-hoc runs (counterpart of
``repro.telemetry.profiling``).

``profiled()`` wraps a block of device work and reports the wall-clock
split between the first (build-bearing) call and the steady state, and
the peak memory:

    with profiled("serve") as prof:
        first_call()        # builds or loads the kernels
        prof.split()        # first-call / steady boundary
        steady_state_calls()
    prof.report()           # {compile_time_s, run_time_s, ...}

The port runs eagerly, so a host clock read without a synchronize times
the enqueue: ``split()`` and the block's exit synchronize ``device``
first.  Memory is ``torch.cuda.max_memory_allocated`` on a CUDA device,
else the process peak RSS (``ru_maxrss``); ``memory_source`` says which.
``trace_dir`` also records a ``torch.profiler`` trace of the block there
(``<trace_dir>/<label>.json``, for Perfetto or chrome://tracing).  There
is no environment flag.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import resource
import time

import torch

from repro_torch.device import resolve_device, synchronize


def host_peak_rss_bytes() -> int:
    # ru_maxrss is KiB on Linux, bytes on macOS
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(rss) * (1 if rss > 1 << 32 else 1024)


@dataclasses.dataclass
class Profile:  # repro-lint: allow=unfrozen-config-dataclass — host-side stopwatch, filled in as the block runs
    label: str
    device: torch.device = torch.device("cpu")
    compile_time_s: float | None = None
    run_time_s: float | None = None
    total_time_s: float | None = None
    peak_memory_mb: float | None = None
    memory_source: str | None = None
    _t0: float = 0.0
    _t_split: float | None = None

    def split(self) -> None:
        """Mark the first-call / steady boundary (after the device has
        finished what was queued before it)."""
        synchronize(self.device)
        self._t_split = time.perf_counter()

    def _finalize(self) -> None:
        synchronize(self.device)
        t1 = time.perf_counter()
        self.total_time_s = t1 - self._t0
        if self._t_split is not None:
            self.compile_time_s = self._t_split - self._t0
            self.run_time_s = t1 - self._t_split
        else:  # no split marked: the whole block is run time
            self.compile_time_s = 0.0
            self.run_time_s = self.total_time_s
        if self.device.type == "cuda":
            mem = torch.cuda.max_memory_allocated(self.device)
            self.memory_source = "device"
        else:
            mem = host_peak_rss_bytes()
            self.memory_source = "host_rss"
        self.peak_memory_mb = mem / 2 ** 20

    def report(self) -> dict:
        return {"label": self.label,
                "compile_time_s": round(self.compile_time_s, 3),
                "run_time_s": round(self.run_time_s, 3),
                "total_time_s": round(self.total_time_s, 3),
                "peak_memory_mb": round(self.peak_memory_mb, 1),
                "memory_source": self.memory_source}


@contextlib.contextmanager
def profiled(label: str = "run", trace_dir: str | None = None,
             device="cuda"):
    """Yield a :class:`Profile` whose ``split()`` the caller invokes after
    the first call; on exit its timing and memory fields are final.
    ``device`` is the card by default (the CPU when asked for); on a
    CUDA device the peak-memory statistic is reset on entry.
    ``trace_dir`` writes a ``torch.profiler`` trace of the block."""
    dev = resolve_device(device)
    prof = Profile(label, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tracer = contextlib.nullcontext()
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        tracer = profile(activities=acts)
    with tracer as tp:
        synchronize(dev)
        prof._t0 = time.perf_counter()
        try:
            yield prof
        finally:
            prof._finalize()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        tp.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
