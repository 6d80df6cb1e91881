"""Optional ``torch.profiler`` hook around a run.

The simulator's own telemetry is simulated-time; this is the *device*
side: wrapping a run in ``profile_trace`` captures a Chrome trace of the
host ops and the CUDA kernels they launch (the FGC, AIO and norm
kernels among them) under ``<out_dir>/torch_profile/trace.json``.
Strictly opt-in (``--torch-profile``): disabled, or with no
``out_dir``, the body runs with no profiler.  A profiler that fails to
start or stop raises: a run asked for a profile gets one or fails.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str], enabled: bool = True
                  ) -> Iterator[Optional[str]]:
    """Run the body under ``torch.profiler``; yields the profile
    directory (None, with no profiler started, when disabled or without
    an ``out_dir``).  The Chrome trace is written on exit."""
    if not enabled or out_dir is None:
        yield None
        return
    prof_dir = os.path.join(out_dir, "torch_profile")
    os.makedirs(prof_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof_dir
    finally:
        prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
