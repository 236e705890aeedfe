"""Device -> host copies that run beside later work on the card.

A plain `tensor.cpu()` on the default stream waits for every kernel queued
before it, so a decoded chunk fetched that way waits for the next chunk's
decode (or the next window's denoise) as well. `HostCopy` instead
copies on a side stream into pinned host memory: the side stream waits only
on an event recorded after the tensor was produced, and `record_stream`
keeps the caching allocator from handing the tensor's memory to later work
before the copy has read it. This is the port's counterpart of JAX's async
dispatch with a deferred `np.asarray` (easyanimate_tpu/pipeline/t2v.py:
604-660, easyanimate_tpu/ui/controller.py:278-395).
"""
import numpy as np
import torch


class HostCopy:
    """A copy of a tensor to host memory, started at construction;
    `result()` waits for it and returns the numpy array."""

    def __init__(self, tensor: torch.Tensor):
        tensor = tensor.detach()
        self._done = None
        if tensor.device.type != "cuda":
            self._host = tensor.cpu()
            return
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(tensor.device))
        stream = torch.cuda.Stream(tensor.device)  # from PyTorch's pool
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(stream)
        tensor.record_stream(stream)

    def result(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()
