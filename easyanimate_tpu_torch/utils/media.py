"""Conditioning inputs for the inpaint pipeline, on the host.

A copy of easyanimate_tpu/utils/media.py::get_image_to_video_latent and
_load_and_resize (the port imports nothing of the JAX package). PIL is
imported only to open a path or resize an image; an array that is already
at the sample size needs no resize (PIL's same-size resize is a copy), so
the pipeline runs where PIL is not installed.
"""
from typing import Tuple

import numpy as np


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
