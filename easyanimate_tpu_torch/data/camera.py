"""Camera trajectory -> per-pixel Plücker ray embeddings (CameraCtrl
protocol; reference easyanimate/data/dataset_image_video.py:107-251), the
control input of the V5.1 Control-Camera models.

A copy of easyanimate_tpu/data/camera.py (the port imports nothing of the
JAX package). Pose file (RealEstate10K style): a header line, then one row
per frame
  idx fx fy cx cy _ _ r00 r01 r02 t0 r10 r11 r12 t1 r20 r21 r22 t2
with normalized intrinsics and the world-to-camera matrix. The embedding
is (T, H, W, 6) float32: the (o x d, d) rays in the first camera's frame.
Pure numpy.
"""
import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class CameraPose:
    fx: float
    fy: float
    cx: float
    cy: float
    w2c: np.ndarray  # (4, 4)

    @property
    def c2w(self) -> np.ndarray:
        return np.linalg.inv(self.w2c)

    @classmethod
    def from_entry(cls, entry: Sequence[float]) -> "CameraPose":
        fx, fy, cx, cy = entry[1:5]
        w2c = np.eye(4)
        w2c[:3, :] = np.asarray(entry[7:], np.float64).reshape(3, 4)
        return cls(fx, fy, cx, cy, w2c)


def read_pose_file(path: str) -> List[CameraPose]:
    with open(path) as f:
        lines = f.readlines()[1:]
    return [CameraPose.from_entry([float(x) for x in ln.strip().split(" ")])
            for ln in lines if ln.strip()]


def relative_c2w(poses: List[CameraPose]) -> np.ndarray:
    """Every camera re-based so that the first is the origin."""
    target = np.eye(4)
    abs2rel = target @ poses[0].w2c
    out = [target] + [abs2rel @ p.c2w for p in poses[1:]]
    return np.asarray(out, np.float32)


def plucker_embedding(poses: List[CameraPose], height: int, width: int,
                      original_pose_width: int = 1280,
                      original_pose_height: int = 720) -> np.ndarray:
    """(T, H, W, 6) Plücker rays at pixel centres (+0.5), the intrinsics
    aspect-corrected for the target size as the reference does."""
    sample_ratio = width / height
    pose_ratio = original_pose_width / original_pose_height
    fxs, fys = [], []
    for p in poses:
        fx, fy = p.fx, p.fy
        if pose_ratio > sample_ratio:
            fx = (height * pose_ratio) * fx / width
        else:
            fy = (width / pose_ratio) * fy / height
        fxs.append(fx * width)
        fys.append(fy * height)
    cxs = np.asarray([p.cx * width for p in poses], np.float32)
    cys = np.asarray([p.cy * height for p in poses], np.float32)
    fxs = np.asarray(fxs, np.float32)
    fys = np.asarray(fys, np.float32)

    c2w = relative_c2w(poses)  # (T, 4, 4)
    j, i = np.meshgrid(np.arange(height, dtype=np.float32),
                       np.arange(width, dtype=np.float32), indexing="ij")
    i = i.reshape(-1) + 0.5  # (HW,)
    j = j.reshape(-1) + 0.5

    xs = (i[None] - cxs[:, None]) / fxs[:, None]
    ys = (j[None] - cys[:, None]) / fys[:, None]
    dirs = np.stack([xs, ys, np.ones_like(xs)], axis=-1)  # (T, HW, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    rays_d = dirs @ np.swapaxes(c2w[:, :3, :3], -1, -2)  # (T, HW, 3)
    rays_o = np.broadcast_to(c2w[:, None, :3, 3], rays_d.shape)
    plucker = np.concatenate([np.cross(rays_o, rays_d), rays_d], axis=-1)
    return plucker.reshape(len(poses), height, width, 6).astype(np.float32)


def plucker_from_file(path: str, height: int, width: int, **kw) -> np.ndarray:
    return plucker_embedding(read_pose_file(path), height, width, **kw)
