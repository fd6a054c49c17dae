"""Structured tracing: torch.profiler traces + named host annotations.

Port of ``simpleslam_tpu/utils/profiling.py``. The reference's observability
is tictoc prints at stage boundaries (e.g. PCR/src/LoamRegister.cpp:110-111);
here ``trace(out_dir)`` captures a ``torch.profiler`` run (host operators and,
on a CUDA device, its kernels and copies) and writes it as a Chrome trace
(``trace.json``, viewable in Perfetto or chrome://tracing) into ``out_dir``,
and ``annotate(name)`` wraps a host-side stage in
``torch.profiler.record_function`` so pipeline stages show up on the trace
timeline alongside the kernels they launch.

Neither costs anything worth naming when no trace is active:
``record_function`` outside a profiler run is a pair of cheap callbacks.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(out_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace into ``out_dir`` (no-op if falsy)."""
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def annotate(name: str):
    """Context manager naming a host-side stage on the profiler timeline."""
    import torch

    return torch.profiler.record_function(name)
