"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled with nvcc for sm_90a into an object file, all of
them at once in parallel, and the objects are linked into one shared
library with a plain C interface, which is loaded with ctypes. The library
lands in `build/kernels/` at the repository root, named by a hash of the
sources and flags, so it is rebuilt only when a source changes. There is no
fallback: a missing nvcc or a failed build raises with the compiler's
output.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC")
HEAD_DIMS = (16, 32, 64)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, lse, bh, sq, skv, kv_valid, head_dim, stream
    "ea_flash_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, k, v, o, lse, bh, s, window, head_dim, stream
    "ea_swa_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, gk, gv, o, bh, s, sg, window, head_dim, stream
    "ea_swa_fused_fwd_bf16": (_P,) * 6 + (_I,) * 4 + (_P,),
    # q, k, v, do, lse, di, dq, bh, sq, skv, kv_valid, head_dim, stream
    "ea_flash_bwd_dq_bf16": (_P,) * 7 + (_I,) * 5 + (_P,),
    # q, k, v, do, lse, di, dk, dv, bh, sq, skv, kv_valid, head_dim, stream
    "ea_flash_bwd_dkv_bf16": (_P,) * 8 + (_I,) * 5 + (_P,),
    # q, k, v, do, lse, di, dq, bh, s, window, head_dim, stream
    "ea_swa_bwd_dq_bf16": (_P,) * 7 + (_I,) * 4 + (_P,),
    # q, k, v, do, lse, di, dk, dv, bh, s, window, head_dim, stream
    "ea_swa_bwd_dkv_bf16": (_P,) * 8 + (_I,) * 4 + (_P,),
}


def find_nvcc():
    """nvcc on PATH, else under $CUDA_HOME or the default toolkit path."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    return None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build_library() -> Path:
    """Compile csrc/*.cu into build/kernels/ unless a library for the same
    sources and flags is already there. Returns the library path."""
    cu, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib = BUILD_DIR / f"libea_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, "
            f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels in {CSRC} cannot be "
            "built, and there is no fallback")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(cu, objs)]
        failed = []
        for src, proc in zip(cu, procs):
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        so = os.path.join(tmp, lib.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(so, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, argtypes set."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_kernel_inputs(*tensors: torch.Tensor) -> None:
    """The hand kernels take contiguous, 16-byte aligned bf16 CUDA tensors
    [bh, S, d] with d in HEAD_DIMS, all on one device; raise otherwise."""
    dev = tensors[0].device
    for x in tensors:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"kernel input on {x.device}, expected {dev} (CUDA)")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"kernel input dtype {x.dtype}, expected bfloat16")
        if x.dim() != 3 or x.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"kernel input shape {tuple(x.shape)}: expected "
                             f"[bh, S, d] with d in {HEAD_DIMS}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("kernel input must be contiguous and 16-byte aligned")


def check_row_stats(x: torch.Tensor, like: torch.Tensor) -> None:
    """A per-row float32 statistic (the base-2 lse, or di) for the rows of
    `like` [bh, S, d]: contiguous [bh, S, 1] on the same device; raise
    otherwise."""
    bh, s, _ = like.shape
    if x.device != like.device or x.dtype != torch.float32:
        raise TypeError(f"row statistic {x.dtype} on {x.device}, expected "
                        f"float32 on {like.device}")
    if tuple(x.shape) != (bh, s, 1) or not x.is_contiguous():
        raise ValueError(f"row statistic shape {tuple(x.shape)}, expected a "
                         f"contiguous {(bh, s, 1)}")


def launch(name: str, device: torch.device, *args) -> None:
    """Call one C entry point on `device`'s current stream; raise on a CUDA
    error."""
    fn = getattr(load_library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
