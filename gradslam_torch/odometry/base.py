r"""Abstract odometry provider interface (counterpart of
``gradslam_tpu/odometry/base.py``)."""

from abc import ABC, abstractmethod

__all__ = ["OdometryProvider"]


class OdometryProvider(ABC):
    r"""Base class of the odometry providers. ``provide`` returns relative
    transforms ``(B, 1, 4, 4)`` aligning the second argument to the first."""

    @abstractmethod
    def provide(self, *args, **kwargs):
        """Relative transforms ``(B, 1, 4, 4)`` aligning the second argument
        to the first."""
        raise NotImplementedError
