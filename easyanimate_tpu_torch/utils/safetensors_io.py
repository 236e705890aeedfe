"""Reading and writing the safetensors format without the safetensors
package (the card's machine has none).

A file is an 8-byte little-endian header length N, N bytes of JSON (padded
with spaces), then the tensors' raw little-endian bytes. The header maps
each name to {"dtype", "shape", "data_offsets": [begin, end]}, the offsets
counted from the end of the header; an optional "__metadata__" entry maps
strings to strings. Parity: the `safetensors.numpy` / `safetensors.torch`
calls of easyanimate_tpu/models/convert.py:345 (load_safetensors),
loader.py:40 (_load_safetensors_dir) and :52 (_override_state_dict).
"""
import glob
import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64, "F8_E4M3": torch.float8_e4m3fn,
}
_NAMES = {v: k for k, v in DTYPES.items()}
METADATA = "__metadata__"


def read_header(path: str):
    """-> (header dict, byte offset of the data) of a safetensors file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: header of {n} bytes runs past the file")
    return json.loads(raw.decode("utf-8")), 8 + n


def read_metadata(path: str) -> Optional[Dict[str, str]]:
    return read_header(path)[0].get(METADATA)


def load_file(path: str, device=None) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file. With device=None the tensors
    stay on the host, memory-mapped from the file (pages are read as a
    tensor is used, one tensor at a time, and never written back); with a
    device each is copied there."""
    header, start = read_header(path)
    size = os.path.getsize(path) - start
    # copy-on-write map: writable for torch.from_numpy, the file untouched
    buf = (np.memmap(path, dtype=np.uint8, mode="c", offset=start,
                     shape=(size,)) if size else np.zeros(0, np.uint8))
    out = {}
    for name, info in header.items():
        if name == METADATA:
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or end > size:
            raise ValueError(f"{path}: {name} offsets {begin}..{end} do not "
                             f"hold {shape} {info['dtype']}")
        raw = buf[begin:end]
        if raw.ctypes.data % dtype.itemsize:
            raw = raw.copy()  # a misaligned tensor: one host copy of it alone
        t = torch.from_numpy(raw).view(dtype).reshape(shape)
        out[name] = t if device is None else t.to(device)
    return out


def _as_tensor(v) -> torch.Tensor:
    return v.detach() if torch.is_tensor(v) else torch.from_numpy(
        np.require(v, requirements=("C", "W")))


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write torch tensors (any device) or numpy arrays as one safetensors
    file; the data is laid out as the safetensors package lays it out
    (largest element first, then by name), so every tensor is aligned."""
    items = {k: _as_tensor(v) for k, v in tensors.items()}
    for k, t in items.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name")
    order = sorted(items, key=lambda k: (-items[k].dtype.itemsize, k))
    header, offset = {}, 0
    if metadata is not None:
        header[METADATA] = {str(k): str(v) for k, v in metadata.items()}
    for k in order:
        t = items[k]
        n = t.numel() * t.dtype.itemsize
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-(8 + len(raw)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in order:
            t = items[k].cpu().contiguous().reshape(-1)
            f.write(t.view(torch.uint8).numpy().data)


def load_dir(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Every `*.safetensors` under `path`, in sorted order, as one dict (a
    later file's name overrides an earlier one's); `.index.json` is not
    read, as the JAX loader does not read it."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {path}")
    sd = {}
    for f in files:
        sd.update(load_file(f, device))
    return sd
