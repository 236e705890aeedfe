"""Aspect-ratio buckets & batch samplers.

Parity target: easyanimate/data/bucket_sampler.py. The reference carries a
hard-coded 40-entry table (ASPECT_RATIO_512); the table is exactly the set of
(h, w) pairs on a 32px grid with area in [0.9, 1.0] x 512^2 and aspect ratio
in [0.25, 4.0], so we derive it (and any other base size) programmatically.

Samplers group same-bucket samples into batches, keep images and videos in
separate buckets, and expose a resumable cursor (reference
RandomSampler._pos_start, bucket_sampler.py:49-111) for checkpoint/resume.
Parity: easyanimate_tpu/data/buckets.py, the same permutations and
batches. The shard fields are kept; the port runs one process.
"""
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def make_aspect_buckets(base: int = 512, step: int = 32,
                        min_ratio: float = 0.25, max_ratio: float = 4.0,
                        area_low: float = 0.9) -> Dict[str, Tuple[int, int]]:
    """ratio-string -> (height, width)."""
    target = base * base
    out: Dict[str, Tuple[int, int]] = {}
    for h in range(step, base * 4 + 1, step):
        for w in range(step, base * 4 + 1, step):
            r = h / w
            if not (min_ratio <= r <= max_ratio):
                continue
            if not (area_low * target <= h * w <= target):
                continue
            key = str(round(r, 2))
            # keep the largest-area pair per rounded ratio (matches table)
            if key not in out or h * w > out[key][0] * out[key][1]:
                out[key] = (h, w)
    return dict(sorted(out.items(), key=lambda kv: float(kv[0])))


# The reference's hand-written table omits the 672x352 entry although its
# mirror 352x672 is present; drop it for exact 40-entry parity.
ASPECT_RATIO_512 = {k: v for k, v in make_aspect_buckets(512).items()
                    if k != "1.91"}
ASPECT_RATIO_632 = make_aspect_buckets(632)
ASPECT_RATIO_960 = make_aspect_buckets(960)


def get_closest_ratio(height: float, width: float,
                      ratios: Dict[str, Tuple[int, int]] = ASPECT_RATIO_512):
    r = height / width
    key = min(ratios.keys(), key=lambda k: abs(float(k) - r))
    return ratios[key], float(key)


@dataclasses.dataclass
class ResumableRandomSampler:
    """Shuffled index stream with a persistable cursor (generator-seeded)."""

    num_samples: int
    seed: int = 0
    pos: int = 0
    epoch: int = 0

    def state_dict(self) -> dict:
        return {"pos": self.pos, "epoch": self.epoch, "seed": self.seed}

    def load_state_dict(self, s: dict):
        self.pos, self.epoch, self.seed = s["pos"], s["epoch"], s["seed"]

    def __iter__(self) -> Iterator[int]:
        while True:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(self.num_samples)
            while self.pos < self.num_samples:
                idx = int(order[self.pos])
                self.pos += 1
                yield idx
            self.pos = 0
            self.epoch += 1


@dataclasses.dataclass
class AspectRatioBatchSampler:
    """Groups sample indices into same-bucket batches; image and video
    samples never share a batch (reference
    AspectRatioBatchImageVideoSampler, bucket_sampler.py:270+)."""

    sampler: ResumableRandomSampler
    batch_size: int
    # per-sample metadata: ("image"|"video", height, width)
    sample_info: Sequence[Tuple[str, float, float]]
    ratios: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=lambda: ASPECT_RATIO_512)
    drop_last: bool = True
    # multi-host sharding: every host iterates the SAME permutation (keeping
    # the resumable cursor identical everywhere); a bucket fills to
    # batch_size*shard_count before emitting, and each host takes its own
    # batch_size slice. All shard_count hosts therefore draw from the SAME
    # (kind, ratio) bucket at the same step -- jitted global batch shapes
    # (image T=1 vs video T=f, token tiling) stay identical across
    # processes (the JAX package's multi-host batches require it)
    shard_rank: int = 0
    shard_count: int = 1

    def __post_init__(self):
        self._buckets: Dict[str, Dict[str, List[int]]] = {
            "image": {}, "video": {}}

    def __iter__(self) -> Iterator[List[int]]:
        group = self.batch_size * self.shard_count
        for idx in self.sampler:
            kind, h, w = self.sample_info[idx]
            _, ratio = get_closest_ratio(h, w, self.ratios)
            bucket = self._buckets[kind].setdefault(str(ratio), [])
            bucket.append(idx)
            if len(bucket) == group:
                lo = self.shard_rank * self.batch_size
                yield bucket[lo:lo + self.batch_size]
                bucket.clear()
