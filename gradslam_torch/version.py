"""The port's version, the JAX package's (``gradslam_tpu/version.py``)."""

__version__ = "0.1.0"
