r"""Host-side helpers of the structures (PyTorch).

Counterpart of ``gradslam_tpu/structures/structutils.py``: ``coerce_torch``
(:25), the plotly helpers (:41-148), ``list_to_padded`` (:150) and
``padded_to_list`` (:178). The plotly helpers are plain dicts and strings
equal to the JAX package's; ``img_to_b64str`` imports ``cv2`` and
``numpy_to_plotly_image`` imports plotly when called, never at import.

``coerce_torch`` runs the JAX package's coercion the other way round: there
a torch tensor becomes a host numpy array, here a host array (numpy, a JAX
array, anything with ``__array__``) becomes a tensor. :func:`host_tensor` is
the one conversion of host arrays into the port's tensors: the structure
constructors, ``gradslam_torch.interop`` and ``Pointclouds.from_list`` all
go through it, and a host array lands on the card unless the caller names
another device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "coerce_torch",
    "host_tensor",
    "list_to_padded",
    "padded_to_list",
    "numpy_to_plotly_image",
    "plotly_image_hovertemplate",
    "img_to_b64str",
    "animation_slider",
    "animation_updatemenus",
]

Device = Union[str, torch.device]


def host_tensor(x, dtype, device: Device = "cuda") -> Optional[torch.Tensor]:
    r"""A new tensor of numpy ``dtype`` on ``device`` (the card by default)
    holding the host array ``x`` (numpy, a JAX array, a list, a CPU
    tensor); None stays None. The data is copied, never aliased."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return torch.tensor(np.asarray(x, dtype=dtype), device=device)


def coerce_torch(x, dtype=np.float32, device: Device = "cuda"):
    r"""``x`` as a tensor when it is a host array: anything with
    ``__array__`` that is not a tensor (numpy, a JAX array, recognised by
    that method with no JAX import) becomes a ``dtype`` tensor on ``device``
    through :func:`host_tensor`. Tensors, None and everything else pass
    through untouched."""
    if x is None or isinstance(x, torch.Tensor) or not hasattr(x, "__array__"):
        return x
    return host_tensor(x, dtype, device)


def landing_device(values) -> torch.device:
    r"""Where a structure's host arrays land: on the device of its first
    tensor field, else on the card."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cuda")


def _frame_args(duration):
    return {
        "frame": {"duration": duration, "redraw": True},
        "mode": "immediate",
        "fromcurrent": True,
        "transition": {"duration": duration, "easing": "linear"},
    }


def animation_slider(num_frames: int) -> list:
    r"""Plotly slider of a frame-by-frame animation (the reference's
    layout)."""
    steps = [
        {"args": [[i], _frame_args(0)], "label": i, "method": "animate"}
        for i in range(num_frames)
    ]
    return [
        {
            "active": 0,
            "yanchor": "top",
            "xanchor": "left",
            "currentvalue": {"prefix": "Frame: "},
            "pad": {"b": 10, "t": 60},
            "len": 0.9,
            "x": 0.1,
            "y": 0,
            "steps": steps,
        }
    ]


def animation_updatemenus(ms_per_frame: int) -> list:
    r"""Plotly play and stop buttons (the reference's layout)."""
    return [
        {
            "buttons": [
                {
                    "args": [None, _frame_args(ms_per_frame)],
                    "label": "&#9654;",
                    "method": "animate",
                },
                {
                    "args": [[None], _frame_args(0)],
                    "label": "&#9724;",
                    "method": "animate",
                },
            ],
            "direction": "left",
            "pad": {"r": 10, "t": 70},
            "showactive": False,
            "type": "buttons",
            "x": 0.1,
            "xanchor": "right",
            "y": 0,
            "yanchor": "top",
        }
    ]


def img_to_b64str(img: np.ndarray, quality: int = 95) -> str:
    r"""JPEG-encode an ``(H, W, 3)`` RGB or ``(H, W)`` grey image to a
    base64 data URI (cv2's encoder, imported here)."""
    import base64

    import cv2

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, buf = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    if not ok:
        raise ValueError("JPEG encoding failed")
    return "data:image/jpeg;base64," + base64.b64encode(buf.tobytes()).decode()


def plotly_image_hovertemplate(is_depth: bool = False, scale=None) -> str:
    r"""Hover template of an image trace (the reference's strings)."""
    hovertemplate = "x: %%{x}<br>y: %%{y}<br>%s: %s"
    if not is_depth:
        hovertemplate = hovertemplate % ("color", "[%{z[0]}, %{z[1]}, %{z[2]}]")
    else:
        hovertemplate = hovertemplate % ("depth", "%{z[0]}")
    if scale is not None:
        scale = int(scale) if int(scale) == scale else scale
        hovertemplate += f"<br>scale: x{scale}<br>"
    hovertemplate += "<extra></extra>"
    return hovertemplate


def numpy_to_plotly_image(img: np.ndarray, name=None, is_depth: bool = False,
                          scale=None, quality: int = 95):
    r"""An image as a ``plotly.graph_objects.Image`` trace with the
    reference's hover text. Needs plotly."""
    import plotly.graph_objects as go

    return go.Image(
        source=img_to_b64str(np.asarray(img), quality),
        hovertemplate=plotly_image_hovertemplate(is_depth, scale),
        name=name,
    )


def list_to_padded(
    x: Sequence,
    pad_size: Optional[Tuple[int, ...]] = None,
    pad_value: float = 0.0,
    equisized: bool = False,
    *,
    device: Device = "cuda",
) -> torch.Tensor:
    r"""Pad a list of ``(N_b,)`` or ``(N_b, K)`` arrays (numpy, tensors or
    JAX arrays) into one ``(B, maxN[, maxK])`` tensor on ``device`` (the
    card by default), keeping the first array's dtype; ``pad_size`` fixes
    the padded sizes, ``equisized`` stacks arrays of one shape."""
    arrs = [y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            for y in x]
    if equisized:
        return torch.from_numpy(np.stack(arrs, axis=0)).to(device)
    if pad_size is None:
        pad_dim0 = max(a.shape[0] for a in arrs)
        pad_dim1 = max(a.shape[1] for a in arrs) if arrs[0].ndim == 2 else None
    else:
        if any(a.ndim != len(pad_size) for a in arrs):
            raise ValueError("Pad size must contain target size for all dimensions.")
        pad_dim0, pad_dim1 = pad_size[0], (pad_size[1] if len(pad_size) > 1 else None)
    shape = (len(arrs), pad_dim0) if arrs[0].ndim == 1 else (len(arrs), pad_dim0, pad_dim1)
    out = np.full(shape, pad_value, dtype=arrs[0].dtype)
    for b, a in enumerate(arrs):
        out[(b,) + tuple(slice(0, n) for n in a.shape)] = a
    return torch.from_numpy(out).to(device)


def padded_to_list(
    x, split_size: Optional[Union[Sequence[int], int]] = None
) -> List[torch.Tensor]:
    r"""Split a padded ``(B, maxN, *)`` tensor into a list of its batch
    rows, each cut to ``split_size[b]`` rows (an int) or ``split_size[b]``
    rows and columns (a pair). The rows are views of ``x``, on its device."""
    x = torch.as_tensor(x)
    out = list(x.unbind(0))
    if split_size is None:
        return out
    if len(split_size) != x.shape[0]:
        raise ValueError(
            f"Split size must be of same length as inputs first dimension. "
            f"Got {len(split_size)} and {x.shape[0]}."
        )
    return [
        out[b][: split_size[b]] if isinstance(split_size[b], int)
        else out[b][: split_size[b][0], : split_size[b][1]]
        for b in range(x.shape[0])
    ]
