"""Structured tracing: a torch.profiler trace of a run.

Port of ``simpleslam_tpu/utils/profiling.py``. The reference's observability
is tictoc prints at stage boundaries (e.g. PCR/src/LoamRegister.cpp:110-111);
here ``trace(out_dir)`` captures a ``torch.profiler`` run (host operators and,
on a CUDA device, its kernels and copies) and writes it as a Chrome trace
(``trace.json``, viewable in Perfetto or chrome://tracing) into ``out_dir``.
The executors' stages (``utils/tictoc.py`` spans) open a host-side
profiler range while a session runs, so they show on the timeline alongside
the kernels they launch; the session records every thread
(``profile_all_threads``), so the backend worker's and the scan-prep
thread's ranges show beside the main thread's.
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
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
