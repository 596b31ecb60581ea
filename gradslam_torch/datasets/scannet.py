r"""ScanNet dataset loader of the PyTorch port.

Counterpart of ``gradslam_tpu/datasets/scannet.py`` (``_natsort_key`` :26,
``get_color_encoding`` :84, ``nyu40_to_scannet20`` :93, ``Scannet`` :104;
reference ``gradslam/datasets/scannet.py:19``): pre-extracted ScanNet scans
driven by sequence-metadata ``.txt`` files (``sceneXXXX_XX-seq_Y.txt``),
per-scene intrinsics read from file, depth scale 1/1000, semantic labels
with the nyu40 -> scannet20 remap and colour palettes. Colour frames are
JPEG, read through Pillow (:func:`~gradslam_torch.datasets.frameio.
read_image`); depth and labels are PNG.
"""

from __future__ import annotations

import glob
import os
import re
from collections import OrderedDict
from typing import Union

import numpy as np

from .base import RGBDSequenceDataset, resize_nearest
from .datautils import scale_intrinsics
from .frameio import read_image

__all__ = ["Scannet", "get_color_encoding", "nyu40_to_scannet20"]


def _natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


# nyu40 -> scannet20 remap (source, target) pairs — classes absent from
# scannet20 map to 0; survivors are packed contiguously into [0, 20]
# (reference scannet.py:494-524).
_NYU40_TO_SCANNET20 = [
    (0, 0), (13, 0), (15, 0), (17, 0), (18, 0), (19, 0), (20, 0), (21, 0),
    (22, 0), (23, 0), (25, 0), (26, 0), (27, 0), (29, 0), (30, 0), (31, 0),
    (32, 0), (35, 0), (37, 0), (38, 0), (40, 0),
    (14, 13), (16, 14), (24, 15), (28, 16), (33, 17), (34, 18), (36, 19),
    (39, 20),
]

_NYU40_PALETTE = OrderedDict(
    [
        ("unlabeled", (0, 0, 0)), ("wall", (174, 199, 232)),
        ("floor", (152, 223, 138)), ("cabinet", (31, 119, 180)),
        ("bed", (255, 187, 120)), ("chair", (188, 189, 34)),
        ("sofa", (140, 86, 75)), ("table", (255, 152, 150)),
        ("door", (214, 39, 40)), ("window", (197, 176, 213)),
        ("bookshelf", (148, 103, 189)), ("picture", (196, 156, 148)),
        ("counter", (23, 190, 207)), ("blinds", (178, 76, 76)),
        ("desk", (247, 182, 210)), ("shelves", (66, 188, 102)),
        ("curtain", (219, 219, 141)), ("dresser", (140, 57, 197)),
        ("pillow", (202, 185, 52)), ("mirror", (51, 176, 203)),
        ("floormat", (200, 54, 131)), ("clothes", (92, 193, 61)),
        ("ceiling", (78, 71, 183)), ("books", (172, 114, 82)),
        ("refrigerator", (255, 127, 14)), ("television", (91, 163, 138)),
        ("paper", (153, 98, 156)), ("towel", (140, 153, 101)),
        ("showercurtain", (158, 218, 229)), ("box", (100, 125, 154)),
        ("whiteboard", (178, 127, 135)), ("person", (120, 185, 128)),
        ("nightstand", (146, 111, 194)), ("toilet", (44, 160, 44)),
        ("sink", (112, 128, 144)), ("lamp", (96, 207, 209)),
        ("bathtub", (227, 119, 194)), ("bag", (213, 92, 176)),
        ("otherstructure", (94, 106, 211)), ("otherfurniture", (82, 84, 163)),
        ("otherprop", (100, 85, 144)),
    ]
)

_SCANNET20_PALETTE = OrderedDict(
    [
        ("unlabeled", (0, 0, 0)), ("wall", (174, 199, 232)),
        ("floor", (152, 223, 138)), ("cabinet", (31, 119, 180)),
        ("bed", (255, 187, 120)), ("chair", (188, 189, 34)),
        ("sofa", (140, 86, 75)), ("table", (255, 152, 150)),
        ("door", (214, 39, 40)), ("window", (197, 176, 213)),
        ("bookshelf", (148, 103, 189)), ("picture", (196, 156, 148)),
        ("counter", (23, 190, 207)), ("desk", (247, 182, 210)),
        ("curtain", (219, 219, 141)), ("refrigerator", (255, 127, 14)),
        ("showercurtain", (158, 218, 229)), ("toilet", (44, 160, 44)),
        ("sink", (112, 128, 144)), ("bathtub", (227, 119, 194)),
        ("otherfurniture", (82, 84, 163)),
    ]
)


def get_color_encoding(seg_classes: str) -> OrderedDict:
    r"""Label-name -> color palette for ``"nyu40"`` or ``"scannet20"``."""
    if seg_classes.lower() == "nyu40":
        return OrderedDict(_NYU40_PALETTE)
    if seg_classes.lower() == "scannet20":
        return OrderedDict(_SCANNET20_PALETTE)
    raise ValueError(f"Unknown seg_classes: {seg_classes}")


def nyu40_to_scannet20(label: np.ndarray) -> np.ndarray:
    r"""Remap a label image from nyu40 to scannet20 classes via a lookup
    table (vectorised, unlike the reference's sequential in-place rewrite —
    which is also order-correct here since sources and targets are disjoint).
    """
    lut = np.arange(41, dtype=np.int64)
    for src, tar in _NYU40_TO_SCANNET20:
        lut[src] = tar
    return lut[np.clip(np.asarray(label, dtype=np.int64), 0, 40)]


class Scannet(RGBDSequenceDataset):
    def __init__(
        self,
        basedir: str,
        seqmetadir: str,
        scenes: Union[tuple, str, None],
        start: int = 0,
        end: int = -1,
        height: int = 480,
        width: int = 640,
        seg_classes: str = "scannet20",
        channels_first: bool = False,
        normalize_color: bool = False,
        return_depth: bool = True,
        return_intrinsics: bool = True,
        return_pose: bool = True,
        return_transform: bool = True,
        return_names: bool = True,
        return_labels: bool = True,
        loader: str = "cv2",
        pin_memory: bool = False,
    ):
        super().__init__(
            seqlen=0,  # set by each metadata file
            height=height, width=width, channels_first=channels_first,
            normalize_color=normalize_color, return_depth=return_depth,
            return_intrinsics=return_intrinsics, return_pose=return_pose,
            return_transform=return_transform, return_names=return_names,
            loader=loader, depth_scale=1000.0, pin_memory=pin_memory,
        )
        self.seg_classes = seg_classes
        self.return_labels = return_labels
        self.color_encoding = get_color_encoding(seg_classes)
        if start < 0:
            raise ValueError("Start frame cannot be less than 0.")
        if not (end == -1 or end > start):
            raise ValueError(
                f"End frame ({end}) should be equal to -1 or greater than start ({start})")

        if isinstance(scenes, str):
            if os.path.isfile(scenes):
                with open(scenes) as f:
                    scenes = tuple(s for s in f.read().split("\n") if s)
            else:
                raise ValueError(f"incorrect filename: {scenes} doesn't exist")
        elif not (scenes is None or isinstance(scenes, tuple)):
            raise TypeError(
                "scenes should either be path to split.txt or tuple of scenes or "
                f"None, but was of type {type(scenes)} instead")

        seqmetapaths = sorted(glob.glob(os.path.join(seqmetadir, "*.txt")), key=_natsort_key)
        for seqmetapath in seqmetapaths:
            scene_name = os.path.basename(seqmetapath).split("-")[0]
            if scenes is not None and scene_name not in scenes:
                continue
            with open(seqmetapath) as f:
                lines = [ln for ln in f.readlines() if ln.strip()]
            seq_end = len(lines) if end == -1 else end
            lines = lines[start:seq_end]
            color_paths, depth_paths, pose_paths, label_paths = [], [], [], []
            intrinsics_path = None
            for line in lines:
                fields = line.strip().split()
                msg = "incorrect reading from scannet metadata"
                if fields[0] != "color" or fields[2] != "depth" or fields[4] != "pose":
                    raise ValueError(msg)
                color_paths.append(os.path.join(basedir, fields[1]))
                depth_paths.append(os.path.join(basedir, fields[3]))
                pose_paths.append(os.path.join(basedir, fields[5]))
                if fields[6] != "label-filt":
                    raise ValueError(msg)
                label_paths.append(os.path.join(basedir, fields[7]))
                if fields[14] != "intrinsic_depth":
                    raise ValueError(msg)
                intrinsics_path = intrinsics_path or os.path.join(basedir, fields[15])
            self.samples.append(dict(
                color_paths=color_paths,
                depth_paths=depth_paths,
                pose_paths=pose_paths,
                label_paths=label_paths,
                intrinsics_path=intrinsics_path,
                name=os.path.basename(seqmetapath).split(".")[0],
            ))

    def intrinsics_for(self, idx: int) -> np.ndarray:
        """Per-scene intrinsics read from the scan's intrinsics file and
        scaled to the target resolution (reference scannet.py:264)."""
        K = np.loadtxt(self.samples[idx]["intrinsics_path"]).astype(np.float32)
        if K.shape == (3, 3):
            K4 = np.eye(4, dtype=np.float32)
            K4[:3, :3] = K
            K = K4
        # ScanNet depth intrinsics are for 640x480 depth images.
        return scale_intrinsics(K, self.height / 480.0, self.width / 640.0)

    def _preprocess_label(self, label: np.ndarray) -> np.ndarray:
        label = resize_nearest(label, self.height, self.width)
        if self.seg_classes.lower() == "scannet20":
            label = nyu40_to_scannet20(label)
        return np.expand_dims(label, -1)

    def __getitem__(self, idx: int):
        sample = self.samples[idx]
        colors, depths = self._load_frames(sample)
        poses = np.stack([np.loadtxt(p).astype(np.float32) for p in sample["pose_paths"]])
        output = [self._tensor(colors)]
        if self.return_depth:
            output.append(self._tensor(depths))
        if self.return_intrinsics:
            output.append(self._tensor(self.intrinsics_for(idx)))
        output += self._pose_outputs(poses)
        if self.return_names:
            output.append(sample["name"])
        if self.return_labels:
            labels = np.stack([self._preprocess_label(read_image(p))
                               for p in sample["label_paths"]])
            output.append(self._tensor(labels))
        return tuple(output)
