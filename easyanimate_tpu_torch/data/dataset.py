"""Datasets: json-manifest mixed image+video data (host-side, numpy).

Parity target: ImageVideoDataset (easyanimate/data/dataset_image_video.py:
329-505): json manifest entries {file_path, text, type}, stride frame
sampling, short-side resize + center crop to the bucket resolution, random
inpaint masks, failure retry by random re-index. Video decoding uses decord
when available, falling back to imageio/cv2 (all optional in this image).

Token-length curriculum: `video_length_for_resolution` maps a resolution to
a frame count at a fixed token budget (reference
training_with_video_token_length, train.py:1275-1293).

Parity: easyanimate_tpu/data/dataset.py, the same readers in the same
order (decord, imageio with pyav, cv2; PIL for images, each imported where
it is used) and the same draws from the dataset's one numpy Generator,
which the loader's worker threads share: with more than one worker the
draws depend on thread timing, as in JAX. One departure that changes no
result: resize_center_crop returns frames already at the target size as
they are (PIL's bilinear resize to the same size is the identity), so a
machine without PIL can run the loop on such frames.
"""
import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .masks import get_random_mask


def _read_video(path: str, frame_indices: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8."""
    try:
        import decord  # type: ignore
        vr = decord.VideoReader(path)
        return vr.get_batch(list(frame_indices)).asnumpy()
    except ImportError:
        pass
    try:
        import imageio.v3 as iio  # type: ignore
        frames = iio.imread(path, plugin="pyav")
        return frames[frame_indices]
    except ImportError:
        pass
    import cv2  # type: ignore

    cap = cv2.VideoCapture(path)
    want = set(int(i) for i in frame_indices)
    frames = {}
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i in want:
            frames[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        i += 1
    cap.release()
    return np.stack([frames[int(i)] for i in frame_indices])


def _probe_frame_count(path: str) -> int:
    """Actual frame count of a video file (the reference reads it via
    decord); 0 when undeterminable."""
    try:
        import decord  # type: ignore

        return len(decord.VideoReader(path))
    except ImportError:
        pass
    try:
        import cv2  # type: ignore

        cap = cv2.VideoCapture(path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        return max(total, 0)
    except ImportError:
        return 0


def _read_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def resize_center_crop(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """Short-side resize + center crop, per frame (uint8 in/out)."""
    t, h, w = frames.shape[:3]
    if (h, w) == (height, width):
        return frames
    from PIL import Image

    scale = max(height / h, width / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.empty((t, height, width, 3), np.uint8)
    top = (nh - height) // 2
    left = (nw - width) // 2
    for i in range(t):
        img = Image.fromarray(frames[i]).resize((nw, nh), Image.BILINEAR)
        out[i] = np.asarray(img)[top:top + height, left:left + width]
    return out


def video_length_for_resolution(token_length: int, height: int, width: int,
                                vae_spatial: int = 8, vae_temporal: int = 4,
                                patch: int = 2, max_frames: int = 49) -> int:
    """Frames that fit `token_length` tokens at (height, width); returns a
    `vae_temporal*k + 1` count."""
    per_frame = (height // vae_spatial // patch) * (width // vae_spatial // patch)
    latent_frames = max(token_length // per_frame, 1)
    frames = (latent_frames - 1) * vae_temporal + 1
    return min(frames, max_frames)


@dataclasses.dataclass
class ImageVideoDataset:
    """Manifest-backed dataset; __getitem__ returns a dict of numpy arrays."""

    manifest_path: str
    data_root: Optional[str] = None
    video_sample_n_frames: int = 49
    video_sample_stride: int = 4
    height: int = 384
    width: int = 672
    enable_inpaint: bool = False
    seed: int = 0

    def __post_init__(self):
        with open(self.manifest_path) as f:
            self.entries: List[Dict] = json.load(f)
        self._rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.entries)

    def sample_info(self) -> List[Tuple[str, float, float]]:
        """(type, height, width) per entry for the bucket sampler; falls back
        to declared resolution fields or the default size."""
        out = []
        for e in self.entries:
            out.append((e.get("type", "video"),
                        float(e.get("height", self.height)),
                        float(e.get("width", self.width))))
        return out

    def _path(self, e: Dict) -> str:
        p = e["file_path"]
        return os.path.join(self.data_root, p) if self.data_root else p

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for _ in range(8):  # retry-with-reindex on decode failure
            try:
                return self._load(self.entries[idx], idx)
            except Exception:
                idx = int(self._rng.integers(0, len(self.entries)))
        raise RuntimeError("too many decode failures")

    def _load(self, e: Dict, idx: int) -> Dict[str, np.ndarray]:
        kind = e.get("type", "video")
        if kind == "image":
            frames = _read_image(self._path(e))[None]
        else:
            n = self.video_sample_n_frames
            # stride sampling from a random clip start; stride shrinks for
            # short clips (reference clamps to the available range)
            total = int(e.get("num_frames") or
                        _probe_frame_count(self._path(e)) or
                        (n - 1) * self.video_sample_stride + 1)
            stride = self.video_sample_stride
            if (n - 1) * stride + 1 > total:
                stride = max((total - 1) // max(n - 1, 1), 1)
            span = (n - 1) * stride + 1
            start = int(self._rng.integers(0, max(total - span, 0) + 1))
            frame_idx = np.minimum(start + np.arange(n) * stride, total - 1)
            frames = _read_video(self._path(e), frame_idx)
        frames = resize_center_crop(frames, self.height, self.width)
        pixel_values = frames.astype(np.float32) / 255.0  # (T, H, W, 3)
        sample = {
            "pixel_values": np.transpose(pixel_values, (3, 0, 1, 2)),  # C,T,H,W
            "text": e.get("text", ""),
            "idx": np.int64(idx),
        }
        if self.enable_inpaint:
            t, h, w = pixel_values.shape[:3]
            mask = get_random_mask((t, 1, h, w), self._rng)
            sample["mask"] = np.transpose(mask, (1, 0, 2, 3)).astype(np.float32) / 255.0
        return sample


@dataclasses.dataclass
class ImageVideoControlDataset(ImageVideoDataset):
    """Adds a control video (pose/canny/depth) or camera-pose file per
    sample (reference dataset_image_video.py:507-730). Manifest entries may
    carry `control_file_path` (a video) or `camera_file_path` (a
    RealEstate10K-style pose txt -> Plucker embedding)."""

    enable_camera: bool = False

    def _load(self, e: Dict, idx: int) -> Dict[str, np.ndarray]:
        sample = super()._load(e, idx)
        t = sample["pixel_values"].shape[1]
        if self.enable_camera:
            # per-SAMPLE fallback: entries without a pose file condition on
            # zeros (reference train_control.py:1375-1385 does this in the
            # collate), so mixed batches always carry the key with one shape
            if e.get("camera_file_path"):
                from .camera import plucker_from_file

                pl = plucker_from_file(
                    self._path({"file_path": e["camera_file_path"]}),
                    self.height, self.width)
                pl = pl[:t]
                if pl.shape[0] < t:
                    pl = np.concatenate(
                        [pl, np.repeat(pl[-1:], t - pl.shape[0], 0)], 0)
                sample["control_camera_values"] = np.transpose(
                    pl, (3, 0, 1, 2)).astype(np.float32)
            else:
                h, w = sample["pixel_values"].shape[2:]
                sample["control_camera_values"] = np.zeros(
                    (6, t, h, w), np.float32)
        elif e.get("control_file_path"):
            n = t
            frame_idx = np.arange(n) * 1
            frames = _read_video(
                self._path({"file_path": e["control_file_path"]}), frame_idx)
            frames = resize_center_crop(frames, self.height, self.width)
            sample["control_pixel_values"] = np.transpose(
                frames.astype(np.float32) / 255.0, (3, 0, 1, 2))
        return sample

