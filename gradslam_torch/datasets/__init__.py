"""Datasets of the PyTorch port: the TUM, ICL and ScanNet loaders (CPU
tensors read with the port's own PNG codec) and the synthetic numpy
generators."""

from . import datautils, frameio, tumutils
from .base import RGBDSequenceDataset, chunk_sequence
from .icl import ICL
from .scannet import Scannet, get_color_encoding, nyu40_to_scannet20
from .synthetic import hard_sequence, synthetic_sequence
from .tum import TUM

__all__ = [
    "ICL",
    "RGBDSequenceDataset",
    "Scannet",
    "TUM",
    "chunk_sequence",
    "datautils",
    "frameio",
    "get_color_encoding",
    "hard_sequence",
    "nyu40_to_scannet20",
    "synthetic_sequence",
    "tumutils",
]
