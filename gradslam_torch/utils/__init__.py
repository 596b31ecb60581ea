"""Utilities of the PyTorch port."""

from .checkpoint import load_state, save_state
from .cli import parse_pyramid
from .precision import disable_tf32, tf32_disabled
from .profiling import annotate, device_timer, trace
from .trajectory_io import load_trajectory_tum, save_trajectory_tum

__all__ = [
    "annotate",
    "device_timer",
    "disable_tf32",
    "load_state",
    "load_trajectory_tum",
    "parse_pyramid",
    "save_state",
    "save_trajectory_tum",
    "tf32_disabled",
    "trace",
]
