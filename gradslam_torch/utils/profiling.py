r"""Profiling hooks of the PyTorch port.

Counterpart of ``gradslam_tpu/utils/profiling.py`` (``annotate``, ``trace``,
``device_timer``) over ``torch.profiler`` and CUDA events:

- :data:`annotate` names a region, which shows in a profile's trace;
- :func:`trace` captures a profile of the enclosed block (host, and the
  card's kernels on a CUDA device) and writes its trace into ``log_dir``,
  viewable in TensorBoard or Perfetto;
- :func:`device_timer` times the enclosed block on the card's clock: CUDA
  events recorded on the current stream around it, synchronized at the end.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Union

import torch

__all__ = ["annotate", "trace", "device_timer"]

annotate = torch.profiler.record_function
"""Context manager naming a region inside a profile's trace."""


@contextlib.contextmanager
def trace(log_dir: str, device: Union[str, torch.device] = "cuda"):
    r"""Profile the enclosed block and write its trace to ``log_dir``. With
    ``device`` a CUDA device the card's activity is captured beside the
    host's; yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


@contextlib.contextmanager
def device_timer(label: str = "", result_box: Optional[list] = None,
                 device: Union[str, torch.device] = "cuda"):
    r"""Time the enclosed block; its seconds are appended to the yielded
    list (``result_box`` when given) and, with a ``label``, printed. On a
    CUDA ``device`` the time is the card's between two events recorded on
    the current stream, read after a synchronize; on the CPU it is the host
    clock's."""
    box = result_box if result_box is not None else []
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield box
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        yield box
        dt = time.perf_counter() - t0
    if label:
        print(f"[device_timer] {label}: {dt * 1000:.2f} ms")
    box.append(dt)
