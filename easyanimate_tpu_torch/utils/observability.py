"""Tracing, metrics and failure-detection helpers of the training loop.

Parity: easyanimate_tpu/utils/observability.py (the reference's tqdm +
Lightning CUDACallback + tensorboard grad-norm dumps):
  - profile_trace(): a torch.profiler trace (CPU + CUDA) around a block
  - StepTimer: per-step host-clock seconds and device memory
    (torch.cuda.memory_stats); the caller's first read of a step's metric
    is the sync point, so tick() after it
  - MetricLogger: JSONL always, TensorBoard scalars when
    torch.utils.tensorboard imports
  - grad_norm_report(): per-parameter gradient norms, largest first, for
    abnormal-step debugging (train.py:2128-2137)
"""
import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: str):
    """A torch.profiler trace of the block, written as a Chrome trace to
    `logdir`/trace.json (view in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device=None) -> Dict[str, int]:
    """bytes_in_use and peak_bytes_in_use of a CUDA device (-1 without
    one), from torch.cuda.memory_stats."""
    if not torch.cuda.is_available():
        return {"bytes_in_use": -1, "peak_bytes_in_use": -1}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", -1),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", -1)}


class StepTimer:
    """Rolling steps/sec + memory; the CUDACallback's numbers."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []

    def tick(self) -> Dict[str, float]:
        self._times.append(time.perf_counter())
        self._times = self._times[-self.window:]
        out = dict(device_memory_stats())
        if len(self._times) >= 2:
            dt = (self._times[-1] - self._times[0]) / (len(self._times) - 1)
            out["sec_per_step"] = dt
            out["steps_per_sec"] = 1.0 / dt
        return out


def _scalar(v) -> Optional[float]:
    if torch.is_tensor(v):
        return float(v.detach().float().cpu()) if v.dim() == 0 else None
    if isinstance(v, (int, float)):
        return float(v)
    if hasattr(v, "ndim") and v.ndim == 0:  # numpy scalar or 0-d array
        return float(v)
    return None


class MetricLogger:
    """TensorBoard when torch.utils.tensorboard imports, JSONL always
    (`logdir`/metrics.jsonl, appended)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(logdir)
        except ImportError:
            self._tb = None

    def log(self, step: int, metrics: Dict[str, Any]) -> Dict[str, float]:
        """Write the 0-d values of `metrics`; reading a device tensor here
        waits for the step that made it. Returns what was written."""
        clean = {}
        for k, v in metrics.items():
            x = _scalar(v)
            if x is not None:
                clean[k] = x
        self._jsonl.write(json.dumps({"step": int(step), **clean}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)
        return clean

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def grad_norm_report(grads: Dict[str, torch.Tensor],
                     top_k: int = 20) -> Dict[str, float]:
    """Per-parameter gradient norms ({name: tensor}), largest first."""
    norms = {k: float(v.detach().float().norm()) for k, v in grads.items()}
    return dict(sorted(norms.items(), key=lambda kv: -kv[1])[:top_k])
