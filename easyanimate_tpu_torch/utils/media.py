"""Media helpers on the host: the inpaint and control pipelines'
conditioning inputs, the 4:2:0 result the server fetches, and the video
writer.

A copy of easyanimate_tpu/utils/media.py (:15-200 but the image saver;
the port imports nothing of the JAX package). PIL, imageio and cv2 are
imported inside the functions that need them (the card's machine has none
of them): PIL only to open a path or resize an image or frame, so an array
already at the sample size needs no resize (PIL's same-size resize is a
copy) and the pipelines run where PIL is not installed.
"""
import os
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np


def _to_thwc_uint8(video: np.ndarray, rescale: bool = False) -> np.ndarray:
    """(C, T, H, W) float -> (T, H, W, C) uint8."""
    v = np.asarray(video)
    if rescale:
        v = v / 2 + 0.5
    v = np.clip(v, 0, 1)
    return (np.transpose(v, (1, 2, 3, 0)) * 255).astype(np.uint8)


class YUV420Video(NamedTuple):
    """A generation fetched as 4:2:0 planes (controller
    `fetch_yuv420=True`): y (B, T, H, W) uint8, u and v (B, T, H/2, W/2)
    uint8, full-range BT.601 -- 1.5 bytes a pixel off the card instead of
    3. The server reconstructs RGB on the host (yuv420_to_rgb) only to feed
    the mp4 encoder, whose output is 4:2:0 anyway."""
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Inverse of EasyAnimatePipeline.decode_latents_yuv420: the planes ->
    (B, 3, T, H, W) uint8 RGB, chroma nearest-upsampled (the only loss
    against the RGB fetch is the 4:2:0 subsample itself)."""
    yf = y.astype(np.float32) / 255.0
    up = lambda p: np.repeat(np.repeat(p, 2, axis=-2), 2, axis=-1)
    uf = up(u.astype(np.float32) / 255.0 - 0.5)
    vf = up(v.astype(np.float32) / 255.0 - 0.5)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    rgb = np.stack([r, g, b], axis=1)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def color_transfer(src: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Match src's per-channel LAB mean and std to ref's (reference
    utils.py:21-47); uint8 HWC RGB in and out. Pins later frames' color
    statistics to frame 0 against drift in long sliding-window videos."""
    import cv2

    s = cv2.cvtColor(src, cv2.COLOR_RGB2LAB).astype(np.float64)
    r = cv2.cvtColor(ref, cv2.COLOR_RGB2LAB).astype(np.float64)
    s_mean, s_std = s.mean(axis=(0, 1)), s.std(axis=(0, 1))
    r_mean, r_std = r.mean(axis=(0, 1)), r.std(axis=(0, 1))
    out = (s - s_mean) * (r_std / np.maximum(s_std, 1e-6)) + r_mean
    out = np.clip(out, 0, 255).astype(np.uint8)
    return cv2.cvtColor(out, cv2.COLOR_LAB2RGB)


def save_videos_grid(videos: np.ndarray, path: str, fps: int = 8,
                     rescale: bool = False,
                     color_transfer_post_process: bool = False):
    """videos (B, C, T, H, W) in [0, 1] (or [-1, 1] with rescale) -> mp4 or
    gif, the batch side by side. color_transfer_post_process pins every
    frame's color statistics to frame 0 (reference utils.py:60-62)."""
    import imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    b = videos.shape[0]
    frames = [np.concatenate([_to_thwc_uint8(videos[i], rescale)[t]
                              for i in range(b)], axis=1)
              for t in range(videos.shape[2])]
    if color_transfer_post_process and len(frames) > 1:
        frames = [frames[0]] + [color_transfer(f, frames[0])
                                for f in frames[1:]]
    if path.endswith(".gif"):
        imageio.mimsave(path, frames, duration=1000 / fps, loop=0)
        return
    try:
        imageio.mimsave(path, frames, fps=fps)
    except Exception:
        # no ffmpeg backend for imageio: cv2 ships its own codecs
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()


def _load_and_resize(image, size: Tuple[int, int]) -> np.ndarray:
    """image path / PIL image / array -> (H, W, 3) float32 in [0, 1]."""
    if not isinstance(image, np.ndarray):
        from PIL import Image

        if isinstance(image, str):
            image = Image.open(image)
        image = image.convert("RGB").resize((size[1], size[0]), Image.LANCZOS)
        return np.asarray(image, np.float32) / 255.0
    if np.issubdtype(image.dtype, np.floating):
        # float arrays are [0, 1]; a plain uint8 cast would truncate 0.x to
        # 0 and condition on a black frame
        image = np.clip(np.round(image * 255.0), 0, 255)
    image = image.astype(np.uint8)
    if image.shape[:2] != tuple(size):
        from PIL import Image

        image = np.asarray(Image.fromarray(image).resize((size[1], size[0]),
                                                         Image.LANCZOS))
    return image.astype(np.float32) / 255.0


def get_image_to_video_latent(validation_image_start, validation_image_end,
                              video_length: int, sample_size: Tuple[int, int]
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """(input_video, input_video_mask) for the inpaint pipeline: video
    (1, 3, T, H, W) in [0, 1] with the start (and end) image in place, mask
    (1, 1, T, H, W) with 1 on the frames to generate (the reference uses
    255)."""
    h, w = sample_size
    video = np.zeros((1, 3, video_length, h, w), np.float32)
    mask = np.ones((1, 1, video_length, h, w), np.float32)
    if validation_image_start is not None:
        start = _load_and_resize(validation_image_start, sample_size)
        video[0, :, 0] = np.transpose(start, (2, 0, 1))
        mask[0, :, 0] = 0.0
    if validation_image_end is not None and video_length > 1:
        end = _load_and_resize(validation_image_end, sample_size)
        video[0, :, -1] = np.transpose(end, (2, 0, 1))
        mask[0, :, -1] = 0.0
    return video, mask


def get_video_to_video_latent(input_video: Union[str, np.ndarray],
                              video_length: int, sample_size: Tuple[int, int],
                              validation_video_mask: Optional[np.ndarray] = None
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """A source clip (a path, or (T, H, W, 3) frames, cast to uint8 as JAX
    does) -> (video (1, 3, T, H, W) in [0, 1], first video_length frames,
    zero-padded; mask (1, 1, T, H, W), all ones unless
    validation_video_mask (H, W) is given). The V2V and control clips."""
    if isinstance(input_video, str):
        arr = _read_frames(input_video, video_length)
    else:
        arr = np.asarray(input_video)[:video_length]
    arr = _resize_frames(arr, sample_size)
    video = np.zeros((1, 3, video_length, *sample_size), np.float32)
    video[0, :, :arr.shape[0]] = np.transpose(arr, (3, 0, 1, 2))
    if validation_video_mask is not None:
        mask = np.asarray(validation_video_mask, np.float32)[None, None]
        mask = np.repeat(mask[:, :, None], video_length, axis=2)
    else:
        mask = np.ones((1, 1, video_length, *sample_size), np.float32)
    return video, mask


def _read_frames(path: str, video_length: int) -> np.ndarray:
    """The first video_length RGB frames of a video file."""
    try:
        import imageio

        reader = imageio.get_reader(path)
        frames = [f for _, f in zip(range(video_length), reader)]
        reader.close()
    except Exception:  # no ffmpeg backend: cv2 decodes its own codecs
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while len(frames) < video_length:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
        cap.release()
    return np.stack(frames)


def _resize_frames(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(T, H', W', 3) frames -> (T, H, W, 3) float32 in [0, 1] (LANCZOS
    through PIL, which only frames of another size need)."""
    frames = np.asarray(frames, np.uint8)
    if frames.shape[1:3] == tuple(size) and frames.shape[-1] == 3:
        return frames.astype(np.float32) / 255
    from PIL import Image

    h, w = size
    out = np.empty((frames.shape[0], h, w, 3), np.float32)
    for i, f in enumerate(frames):
        img = Image.fromarray(f).convert("RGB")
        out[i] = np.asarray(img.resize((w, h), Image.LANCZOS), np.float32) / 255
    return out
