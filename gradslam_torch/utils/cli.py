r"""Small CLI helpers shared by the port's example scripts.

Counterpart of ``gradslam_tpu/utils/cli.py`` (``parse_pyramid`` :31), so
every example accepts the same syntax with the same error messages. The JAX
module's ``enable_compile_cache`` points XLA at a compilation cache; eager
PyTorch compiles nothing, so it has no counterpart.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = ["parse_pyramid"]


def parse_pyramid(spec: Optional[str]) -> Optional[List[Tuple[int, int]]]:
    """Parse a coarse-to-fine odometry schedule ``'ds:iters,ds:iters,...'``.

    ``'8:6,4:4' -> [(8, 6), (4, 4)]``; ``None`` passes through. Raises
    ``SystemExit`` with a readable message on a malformed spec (this is a
    CLI-argument parser: tracebacks help nobody at the shell).
    """
    if spec is None:
        return None
    try:
        levels = [tuple(int(x) for x in level.split(":")) for level in spec.split(",")]
    except ValueError as e:
        raise SystemExit(f"Bad --pyramid spec {spec!r}: {e}")
    for level in levels:
        if len(level) != 2:
            raise SystemExit(
                f"Bad --pyramid spec {spec!r}: each level must be "
                f"'dsratio:numiters', got {':'.join(map(str, level))!r}"
            )
    return levels
