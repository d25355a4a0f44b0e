"""Minimal PLY point-cloud I/O: the port's copy of emap_tpu/utils/ply.py,
writing the same bytes from the same arrays.

The reference writes/reads PLYs through Open3D (runner_udf.py:541-554,
eval_DTU.py:54), which is unavailable here; point clouds (optionally with
RGB colors in [0,1]) are all it ever stores. Supports ascii and
binary_little_endian, both directions.
"""

from __future__ import annotations

import os

import numpy as np


def write_ply_points(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    ascii_format: bool = True,
) -> None:
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    n = len(points)
    if colors is not None:
        colors = np.asarray(colors, dtype=np.float64).reshape(-1, 3)
        if len(colors) != n:
            raise ValueError(f"{len(colors)} colors for {n} points")
        rgb = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fmt = "ascii 1.0" if ascii_format else "binary_little_endian 1.0"
    header = ["ply", f"format {fmt}", f"element vertex {n}"]
    header += [f"property double {ax}" for ax in "xyz"]
    if colors is not None:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header.append("end_header")

    if ascii_format:
        with open(path, "w") as f:
            f.write("\n".join(header) + "\n")
            for i in range(n):
                row = f"{points[i,0]:.10g} {points[i,1]:.10g} {points[i,2]:.10g}"
                if colors is not None:
                    row += f" {rgb[i,0]} {rgb[i,1]} {rgb[i,2]}"
                f.write(row + "\n")
    else:
        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            if colors is not None:
                dtype = np.dtype(
                    [("xyz", "<f8", 3), ("rgb", "u1", 3)]
                )
                rec = np.empty(n, dtype=dtype)
                rec["xyz"] = points
                rec["rgb"] = rgb
            else:
                dtype = np.dtype([("xyz", "<f8", 3)])
                rec = np.empty(n, dtype=dtype)
                rec["xyz"] = points
            rec.tofile(f)


def read_ply_points(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Returns (points (N,3) float64, colors (N,3) float in [0,1] or None)."""
    with open(path, "rb") as f:
        # --- header ---
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.strip().decode("ascii").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                props.append((tokens[1], tokens[2]))
            elif tokens[0] == "end_header":
                break

        type_map = {
            "float": "<f4", "float32": "<f4", "double": "<f8",
            "float64": "<f8", "uchar": "u1", "uint8": "u1",
            "int": "<i4", "int32": "<i4",
        }
        names = [p[1] for p in props]
        if fmt == "ascii":
            rows = []
            for _ in range(n):
                rows.append(f.readline().split())
            arr = np.asarray(rows, dtype=np.float64)
            data = {name: arr[:, i] for i, name in enumerate(names)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(p[1], type_map[p[0]]) for p in props])
            rec = np.fromfile(f, dtype=dtype, count=n)
            data = {name: rec[name].astype(np.float64) for name in names}
        else:
            raise ValueError(f"unsupported PLY format {fmt!r}")

    points = np.stack([data["x"], data["y"], data["z"]], axis=-1)
    colors = None
    if all(c in data for c in ("red", "green", "blue")):
        colors = (
            np.stack([data["red"], data["green"], data["blue"]], axis=-1)
            / 255.0
        )
    return points, colors
