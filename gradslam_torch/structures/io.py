r"""Pointcloud file IO of the PyTorch port: PLY export and import with
numpy alone.

Counterpart of ``gradslam_tpu/structures/io.py`` (``save_ply`` :36,
``load_ply`` :144), the same code: the port keeps its own copy because
importing ``gradslam_tpu`` imports JAX, so a file written by either package
reads equal in the other. Binary (little-endian) and ASCII formats are
supported; colours are stored as uchar (the PLY convention viewers expect),
points and normals as float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["save_ply", "load_ply"]

_PLY_TO_NUMPY = {
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "char": np.int8,
    "short": np.int16,
    "ushort": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
}


def save_ply(
    path: str,
    points,
    normals=None,
    colors=None,
    binary: bool = True,
    color_range: str = None,
) -> None:
    r"""Write one pointcloud to a PLY file.

    Args:
        path: output filename.
        points: ``(N, 3)`` float array.
        normals: optional ``(N, 3)`` float array (nx/ny/nz properties).
        colors: optional ``(N, 3)`` array, stored as uchar red/green/blue.
            The default convention is dtype-driven (no value-range
            guessing): floating dtypes are interpreted as [0, 1] and scaled
            by 255 (values outside are clipped); integer dtypes are
            interpreted as [0, 255] and clipped. Float colors that exceed
            1.0 (e.g. datasets loaded with ``normalize_color=False`` keep
            0-255 floats) would clip to solid white — a warning is emitted
            and ``color_range`` overrides the convention.
        binary: binary little-endian (default) or ASCII.
        color_range: ``None`` (dtype convention), ``'unit'`` (values in
            [0, 1], scale by 255) or ``'byte'`` (values already in
            [0, 255]).
    """
    if color_range not in (None, "unit", "byte"):
        raise ValueError(f"Unknown color_range: {color_range!r}.")
    points = np.asarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[-1] != 3:
        raise ValueError(f"points must have shape (N, 3). Got {points.shape}.")
    n = points.shape[0]
    cols = [("x", points[:, 0]), ("y", points[:, 1]), ("z", points[:, 2])]
    header = [
        "ply",
        "format "
        + ("binary_little_endian 1.0" if binary else "ascii 1.0"),
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        if normals.shape != points.shape:
            raise ValueError(
                f"normals must match points shape {points.shape}. "
                f"Got {normals.shape}."
            )
        header += [
            "property float nx",
            "property float ny",
            "property float nz",
        ]
        cols += [("nx", normals[:, 0]), ("ny", normals[:, 1]), ("nz", normals[:, 2])]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.shape != points.shape:
            raise ValueError(
                f"colors must match points shape {points.shape}. "
                f"Got {colors.shape}."
            )
        if colors.dtype != np.uint8:
            # Explicit dtype-driven convention: float => [0, 1], int => [0, 255];
            # color_range overrides.
            rng = color_range
            if rng is None:
                rng = ("unit" if np.issubdtype(colors.dtype, np.floating)
                       else "byte")
                if rng == "unit" and colors.size and colors.max() > 1.001:
                    import warnings

                    warnings.warn(
                        "save_ply: float colors exceed 1.0 — the [0, 1] "
                        "convention would clip them to white. Pass "
                        "color_range='byte' if the values are 0-255 floats "
                        "(e.g. a dataset loaded with normalize_color=False)."
                    )
            scale = 255.0 if rng == "unit" else 1.0
            colors = np.clip(colors * scale, 0, 255).astype(np.uint8)
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
        cols += [("red", colors[:, 0]), ("green", colors[:, 1]), ("blue", colors[:, 2])]
    header.append("end_header")

    if binary:
        rec = np.dtype([(name, vals.dtype) for name, vals in cols])
        data = np.empty(n, dtype=rec)
        for name, vals in cols:
            data[name] = vals
        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            f.write(data.tobytes())
    else:
        with open(path, "w") as f:
            f.write("\n".join(header) + "\n")
            for i in range(n):
                parts = []
                for _, vals in cols:
                    v = vals[i]
                    parts.append(str(int(v)) if vals.dtype == np.uint8 else f"{v:.6g}")
                f.write(" ".join(parts) + "\n")


def load_ply(path: str) -> Dict[str, Optional[np.ndarray]]:
    r"""Read a PLY vertex cloud (the subset :func:`save_ply` writes, plus any
    file with an x/y/z vertex element). Returns a dict with ``points`` and,
    when present, ``normals`` / ``colors`` (colors as float in [0, 1])."""
    with open(path, "rb") as f:
        line = f.readline().decode("ascii", "replace").strip()
        if line != "ply":
            raise ValueError(f"{path} is not a PLY file (first line {line!r}).")
        fmt = None
        n = None
        props = []  # (name, dtype) of the vertex element
        in_vertex = False
        while True:
            raw = f.readline()
            if not raw:  # EOF: readline() returns b'' — a blank line is b'\n'
                raise ValueError(
                    f"{path}: unexpected end of file in PLY header "
                    "(missing end_header — truncated file?)."
                )
            line = raw.decode("ascii", "replace").strip()
            if not line:
                continue
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(count)
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                if typ == "list":
                    raise ValueError("list properties are not supported")
                props.append((name, _PLY_TO_NUMPY[typ]))
            elif line == "end_header":
                break

        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"Unsupported PLY format: {fmt}")
        if n is None:
            raise ValueError("No vertex element in PLY header.")
        rec = np.dtype([(name, dt) for name, dt in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(n * rec.itemsize), dtype=rec, count=n)
        else:
            rows = []
            for _ in range(n):
                rows.append(f.readline().decode("ascii").split())
            arr = np.asarray(rows)
            data = np.empty(n, dtype=rec)
            for j, (name, dt) in enumerate(props):
                data[name] = arr[:, j].astype(dt)

    names = {name for name, _ in props}
    out: Dict[str, Optional[np.ndarray]] = {
        "points": np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(
            np.float32
        )
    }
    if {"nx", "ny", "nz"} <= names:
        out["normals"] = np.stack(
            [data["nx"], data["ny"], data["nz"]], axis=-1
        ).astype(np.float32)
    if {"red", "green", "blue"} <= names:
        out["colors"] = (
            np.stack([data["red"], data["green"], data["blue"]], axis=-1).astype(
                np.float32
            )
            / 255.0
        )
    return out
