"""Random inpaint-training masks.

Parity target: get_random_mask (easyanimate/data/dataset_image_video.py:27-105)
-- ten archetypes with the reference's sampling weights:
  0 whole-clip mask (p=0.2 after idx 0/1 merge -> pure T2V training)
  1 first-frame-kept (mask all but frame 0)
  2 random rectangle over all frames
  3 tail frames masked from a random start
  4 head+tail kept, middle masked
  5 per-frame independent rectangles
  6 whole-frame mask per random subset of frames
  7 random ellipse over all frames
  8 per-frame independent ellipses
  9 frame 0 kept + random rectangle elsewhere

numpy-based (host-side input pipeline, like the reference's dataloader).
Parity: easyanimate_tpu/data/masks.py, the same draws from the same
numpy Generator.
"""
from typing import Tuple

import numpy as np

# reference mask_index sampling: random.choices([0..9], weights=[...])
_WEIGHTS = [0.05, 0.2, 0.2, 0.2, 0.05, 0.05, 0.05, 0.05, 0.05, 0.1]


def get_random_mask(shape: Tuple[int, int, int, int],
                    rng: np.random.Generator,
                    image_start_only: bool = False) -> np.ndarray:
    """shape (T, 1, H, W) -> uint8 mask in {0, 255}; 255 = regenerate."""
    f, c, h, w = shape
    mask = np.zeros(shape, np.uint8)
    if image_start_only:
        mask[1:] = 255
        return mask
    idx = rng.choice(10, p=np.asarray(_WEIGHTS) / sum(_WEIGHTS))

    def rand_box():
        bh, bw = rng.integers(h // 4, 3 * h // 4 + 1), rng.integers(w // 4, 3 * w // 4 + 1)
        top, left = rng.integers(0, h - bh + 1), rng.integers(0, w - bw + 1)
        return top, left, bh, bw

    def ellipse_mask():
        ch_, cw = rng.integers(h // 4, 3 * h // 4 + 1), rng.integers(w // 4, 3 * w // 4 + 1)
        ah, aw = rng.integers(h // 8, h // 2 + 1), rng.integers(w // 8, w // 2 + 1)
        yy, xx = np.mgrid[:h, :w]
        return (((yy - ch_) / max(ah, 1)) ** 2 + ((xx - cw) / max(aw, 1)) ** 2) <= 1

    if idx == 0:
        mask[:] = 255
    elif idx == 1:
        mask[1:] = 255
    elif idx == 2:
        top, left, bh, bw = rand_box()
        mask[:, :, top:top + bh, left:left + bw] = 255
    elif idx == 3:
        start = int(rng.integers(1, max(f, 2)))
        mask[start:] = 255
    elif idx == 4:
        if f > 2:
            mask[1:-1] = 255
        else:
            mask[:] = 255
    elif idx == 5:
        for i in range(f):
            top, left, bh, bw = rand_box()
            mask[i, :, top:top + bh, left:left + bw] = 255
    elif idx == 6:
        num = int(rng.integers(1, max(f, 2)))
        frames = rng.choice(f, size=min(num, f), replace=False)
        mask[frames] = 255
    elif idx == 7:
        mask[:, :, ellipse_mask()] = 255
    elif idx == 8:
        for i in range(f):
            mask[i, :, ellipse_mask()] = 255
    else:  # 9
        top, left, bh, bw = rand_box()
        mask[1:, :, top:top + bh, left:left + bw] = 255
    return mask
