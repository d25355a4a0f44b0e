"""Scene loading and device-resident ray generation (port of
emap_tpu/data/dataset.py).

All images, cameras and per-image importance CDFs go to the device once
(`RayPool`); `sample_rays` draws a training batch there: half the pixels
uniform, half by edge importance (inverse-CDF searchsorted), then builds
the rays. Parity with the JAX package is in distribution, not in the
random sequence (torch generators and jax keys differ).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from emap_tpu_torch.data.png import read_png


@dataclasses.dataclass
class SceneData:
    """Host-side scene: images and cameras as numpy arrays."""

    scan: str
    data_dir: str
    dataset_name: str
    detector: str
    H: int
    W: int
    n_images: int
    near: float
    far: float
    radius: float
    aabb: np.ndarray  # (2, 3)
    intrinsics: np.ndarray  # (n, 4, 4)
    intrinsics_inv: np.ndarray  # (n, 4, 4)
    poses: np.ndarray  # (n, 4, 4) camera to world
    edges: np.ndarray  # (n, H, W) in [0, 1]
    colors: np.ndarray  # (n, H, W, 3) in [0, 1], BGR
    edge_paths: list
    color_paths: list

    @property
    def masks(self) -> np.ndarray:
        """(n, H, W) float32: 1 where the edge map exceeds 0.5."""
        return (self.edges > 0.5).astype(np.float32)


def load_meta(data_dir: str) -> Dict[str, Any]:
    with open(os.path.join(data_dir, "meta_data.json"), encoding="utf-8") as f:
        return json.load(f)


def edge_map_path(data_dir: str, rgb_name: str, detector: str) -> str:
    if detector == "PidiNet":
        return os.path.join(data_dir, "edge_PidiNet", rgb_name[:-4] + ".png")
    if detector == "DexiNed":
        return os.path.join(data_dir, "edge_DexiNed", rgb_name)
    raise ValueError(f"unknown detector {detector!r}")


def _read(path: str, gray: bool) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"cannot read image {path!r} (check dataset.data_dir and that the "
            f"dataset.detector edge-map directory exists)")
    return read_png(path, gray=gray).astype(np.float32) / 255.0


def load_scene(conf) -> SceneData:
    """Load a scan as described by the `dataset` conf section."""
    scan = conf.get_string("scan")
    data_dir = os.path.join(conf.get_string("data_dir"), scan)
    detector = conf.get_string("detector", "DexiNed")
    meta = load_meta(data_dir)
    H, W = int(meta["height"]), int(meta["width"])
    box = meta["scene_box"]

    intrinsics, poses, edge_paths, color_paths = [], [], [], []
    for frame in meta["frames"]:
        intrinsics.append(np.asarray(frame["intrinsics"], dtype=np.float64))
        poses.append(np.asarray(frame["camtoworld"], dtype=np.float64)[:4, :4])
        edge_paths.append(edge_map_path(data_dir, frame["rgb_path"], detector))
        color_paths.append(os.path.join(data_dir, "color", frame["rgb_path"]))
    intrinsics = np.stack(intrinsics).astype(np.float32)
    return SceneData(
        scan=scan,
        data_dir=data_dir,
        dataset_name=conf.get_string("dataset_name", "ABC"),
        detector=detector,
        H=H,
        W=W,
        n_images=len(edge_paths),
        near=float(box["near"]),
        far=float(box["far"]),
        radius=float(box["radius"]),
        aabb=np.asarray(box["aabb"], dtype=np.float32),
        intrinsics=intrinsics,
        intrinsics_inv=np.linalg.inv(intrinsics.astype(np.float64)).astype(
            np.float32),
        poses=np.stack(poses).astype(np.float32),
        edges=np.stack([_read(p, True) for p in edge_paths]),
        colors=np.stack([_read(p, False) for p in color_paths]),
        edge_paths=edge_paths,
        color_paths=color_paths,
    )


def importance_cdf(edges: np.ndarray) -> np.ndarray:
    """Per-image inverse-CDF table: probability `edge_density` for pixels
    with edge <= 0.1 and `1 - edge_density` for edge pixels, normalized;
    float64 on the host, stored float32."""
    n, H, W = edges.shape
    flat = edges.reshape(n, H * W).astype(np.float64)
    density = flat.mean(axis=1, keepdims=True)
    probs = np.where(flat > 0.1, 1.0 - density, density)
    cdf = np.cumsum(probs, axis=1)
    cdf /= cdf[:, -1:]
    return cdf.astype(np.float32)


@dataclasses.dataclass
class RayPool:
    """Device-resident arrays for ray generation."""

    edges: torch.Tensor  # (n, H*W)
    cdf: torch.Tensor  # (n, H*W)
    intrinsics_inv: torch.Tensor  # (n, 3, 3)
    rot: torch.Tensor  # (n, 3, 3) camera-to-world rotation
    origin: torch.Tensor  # (n, 3) camera centres
    H: int
    W: int
    n_images: int

    @classmethod
    def from_scene(cls, scene: SceneData, device="cuda") -> "RayPool":
        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return cls(
            edges=put(scene.edges.reshape(scene.n_images, -1)),
            cdf=put(importance_cdf(scene.edges)),
            intrinsics_inv=put(scene.intrinsics_inv[:, :3, :3]),
            rot=put(scene.poses[:, :3, :3]),
            origin=put(scene.poses[:, :3, 3]),
            H=scene.H,
            W=scene.W,
            n_images=scene.n_images,
        )

    @property
    def device(self) -> torch.device:
        return self.edges.device


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v (B, 3) @ m.T in full float32, as elementwise products and sums (no
    matmul, so no TF32 whatever the backend flags say)."""
    return (v[:, None, :] * m[None, :, :]).sum(dim=-1)


def _image_row(table: torch.Tensor, img_idx) -> torch.Tensor:
    """table[img_idx] for an int or a 0-d int64 tensor on the table's
    device, by index_select: indexing with a tensor would read it on the
    host (a sync, which a CUDA graph cannot hold)."""
    idx = torch.as_tensor(img_idx, device=table.device).reshape(1)
    return table.index_select(0, idx)[0]


def rays_from_pixels(pool: RayPool, img_idx, px, py):
    """Pixel coordinates (B,) -> world rays_o, rays_d (B, 3), depth_scale
    (B, 1) and the camera-space pixel directions (B, 3). `img_idx`: an int
    or a 0-d int64 tensor on the pool's device."""
    p = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    pc = _matvec(_image_row(pool.intrinsics_inv, img_idx), p)
    rays_v = pc / torch.linalg.norm(pc, dim=-1, keepdim=True)
    depth_scale = rays_v[:, 2:3]
    rays_d = _matvec(_image_row(pool.rot, img_idx), rays_v)
    rays_o = _image_row(pool.origin, img_idx).expand(rays_d.shape)
    return rays_o, rays_d, depth_scale, pc


def sample_rays(pool: RayPool, img_idx, generator: torch.Generator,
                batch_size: int, importance_sample: bool = True, group=None):
    """A training batch of rays on the pool's device: dict(rays_o, rays_d,
    edge, depth_scale, rays_ndc_uv), drawn from `generator` (on the same
    device). `img_idx`: an int or a 0-d int64 tensor on the pool's
    device. With a `group` (parallel/mesh.py::RayGroup) every rank draws
    the pixels of the whole `batch_size` batch and builds the rays of its
    own rows, so the generator advances alike on every rank."""
    dev = pool.device
    if importance_sample:
        n_uniform = batch_size // 2
        n_imp = batch_size - n_uniform
        px_u = torch.randint(0, pool.W, (n_uniform,), generator=generator,
                             device=dev)
        py_u = torch.randint(0, pool.H, (n_uniform,), generator=generator,
                             device=dev)
        u = torch.rand((n_imp,), generator=generator, device=dev)
        flat_idx = torch.searchsorted(_image_row(pool.cdf, img_idx), u,
                                      right=True)
        flat_idx = torch.clamp(flat_idx, 0, pool.H * pool.W - 1)
        px = torch.cat([px_u, flat_idx % pool.W]).to(torch.float32)
        py = torch.cat([py_u, flat_idx // pool.W]).to(torch.float32)
    else:
        px = torch.randint(0, pool.W, (batch_size,), generator=generator,
                           device=dev).to(torch.float32)
        py = torch.randint(0, pool.H, (batch_size,), generator=generator,
                           device=dev).to(torch.float32)
    if group is not None:
        px, py = group.shard(px), group.shard(py)
    return rays_at_pixels(pool, img_idx, px, py)


def rays_at_pixels(pool: RayPool, img_idx, px, py):
    """The batch dict of `sample_rays` at given pixel coordinates."""
    flat = py.to(torch.int64) * pool.W + px.to(torch.int64)
    edge = _image_row(pool.edges, img_idx)[flat][:, None]
    rays_o, rays_d, depth_scale, _ = rays_from_pixels(pool, img_idx, px, py)
    return {
        "rays_o": rays_o,
        "rays_d": rays_d,
        "edge": edge,
        "depth_scale": depth_scale,
        "rays_ndc_uv": torch.stack([2.0 * px / (pool.W - 1) - 1.0,
                                    2.0 * py / (pool.H - 1) - 1.0], dim=-1),
    }


def gen_rays_at(scene: SceneData, img_idx: int, resolution_level: int = 1):
    """Full-image rays (numpy): (h, w, 3) rays_o, rays_d and (h, w, 1)
    depth_scale, h = H // level, w = W // level, row-major."""
    level = resolution_level
    xs = np.linspace(0, scene.W - 1, scene.W // level, dtype=np.float32)
    ys = np.linspace(0, scene.H - 1, scene.H // level, dtype=np.float32)
    px, py = np.meshgrid(xs, ys, indexing="xy")
    p = np.stack([px, py, np.ones_like(px)], axis=-1)
    pc = p @ scene.intrinsics_inv[img_idx, :3, :3].T
    rays_v = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    depth_scale = rays_v[..., 2:].copy()
    rays_d = rays_v @ scene.poses[img_idx, :3, :3].T
    rays_o = np.broadcast_to(scene.poses[img_idx, :3, 3], rays_d.shape).copy()
    return rays_o, rays_d, depth_scale


def gen_one_ray_at(scene: SceneData, img_idx: int, x: int, y: int) -> dict:
    """The ray through one pixel (x, y) of a view, for debugging: numpy
    rays_o, rays_v (1, 3), edge and mask (1, 1), color (1, 3) and
    depth_scale (1, 1)."""
    rays_o, rays_d, depth_scale = gen_rays_at(scene, img_idx, 1)
    return {
        "rays_o": rays_o[y: y + 1, x],
        "rays_v": rays_d[y: y + 1, x],
        "edge": scene.edges[img_idx, y: y + 1, x: x + 1],
        "color": scene.colors[img_idx, y: y + 1, x],
        "mask": scene.masks[img_idx, y: y + 1, x: x + 1],
        "depth_scale": depth_scale[y: y + 1, x],
    }


def edge_at(scene: SceneData, idx: int, resolution_level: int) -> np.ndarray:
    """Ground-truth edge image (h, w) uint8 at 1/resolution_level size. At
    level 1 it equals the JAX package's cv2.resize to the same size (the map
    itself). Above 1 it is a bilinear resize with OpenCV's pixel-centre
    convention, computed in float and rounded: within one grey level of
    cv2's fixed-point INTER_LINEAR, not bit for bit."""
    edge = (scene.edges[idx] * 255.0).astype(np.uint8)
    h, w = scene.H // resolution_level, scene.W // resolution_level
    if (h, w) == edge.shape:
        return edge

    def taps(n_out, n_in):
        s = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0)
        i0 = np.minimum(np.floor(s).astype(np.int64), n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), s - i0

    y0, y1, fy = taps(h, edge.shape[0])
    x0, x1, fx = taps(w, edge.shape[1])
    e = edge.astype(np.float64)
    rows = e[y0] * (1.0 - fy[:, None]) + e[y1] * fy[:, None]
    out = rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def color_at(scene: SceneData, idx: int, resolution_level: int) -> np.ndarray:
    """Colour image (h, w, 3) uint8 at 1/resolution_level size: OpenCV's
    INTER_NEAREST resize (source pixel floor(x * src / dst)), as the JAX
    package's cv2.resize gives it."""
    img = (scene.colors[idx] * 255.0).astype(np.uint8)
    h, w = scene.H // resolution_level, scene.W // resolution_level

    def taps(n_out, n_in):
        return np.minimum(np.floor(np.arange(n_out) * (1.0 / (n_out / n_in)))
                          .astype(np.int64), n_in - 1)

    return img[taps(h, img.shape[0])][:, taps(w, img.shape[1])]
