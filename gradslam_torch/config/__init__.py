"""Configuration trees of the PyTorch port."""

from .cfgnode import CfgNode, load_cfg

__all__ = ["CfgNode", "load_cfg"]
