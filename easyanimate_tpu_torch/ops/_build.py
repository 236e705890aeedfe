"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled with nvcc for sm_90a into an object file, all of
them at once in parallel, and the objects are linked into one shared
library with a plain C interface, which is loaded with ctypes. The library
lands in `build/kernels/` at the repository root, named by a hash of the
sources and flags, so it is rebuilt only when a source changes; ptxas's
per-kernel report (registers, spills) is kept beside it. There is no
fallback: a missing nvcc or a failed build raises with the compiler's
output.
"""
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
HEAD_DIMS = (16, 32, 64)
# the attention kernels by the names their input checks raise with, and
# the head dims each has an instance for: K1's forward also takes 88 (V4's
# HunyuanDiT, csrc/flash_fwd.cu::flash_fwd_d88_sm90), 72 (the V1-V3
# Transformer3D: flash_fwd_short_sm90 for heads of at most 64 q and kv
# rows, else flash_fwd_d72_sm90's persistent walk) and 144
# (V1's and V2's motion modules: flash_fwd_short_sm90 for heads of at most
# 64 q and kv rows, else the mma.sync body)
K1 = "K1 (ea_flash_fwd_bf16)"
K2 = "K2 (ea_swa_fwd_bf16)"
K3_K4 = "K3 and K4 (ea_flash_bwd_dq_bf16, ea_flash_bwd_dkv_bf16)"
K5 = "K5 (ea_swa_fused_fwd_bf16)"
K6_K7 = "K6 and K7 (ea_swa_bwd_dq_bf16, ea_swa_bwd_dkv_bf16)"
KERNEL_HEAD_DIMS = {K1: HEAD_DIMS + (72, 88, 144), K2: HEAD_DIMS, K3_K4: HEAD_DIMS,
                    K5: HEAD_DIMS, K6_K7: HEAD_DIMS}

# csrc/hopper.cuh::kTensorMapError: an entry point returns it plus the
# CUresult when cuTensorMapEncodeTiled refuses a tensor map
TENSOR_MAP_ERROR = 10000

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, lse, bh, sq, skv, kv_valid, head_dim, stream
    "ea_flash_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # head_dim, sq, skv -> 1 if ea_flash_fwd_bf16 runs a TMA + wgmma kernel
    "ea_flash_fwd_uses_sm90": (_I, _I, _I),
    # head_dim, sq, skv -> 1 if that kernel is the short-head one
    # (flash_fwd_short_sm90)
    "ea_flash_fwd_uses_short": (_I, _I, _I),
    # q, k, v, o, lse, bh, s, window, head_dim, stream
    "ea_swa_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # head_dim -> 1 if ea_swa_fwd_bf16 runs the TMA + wgmma kernel
    "ea_swa_fwd_uses_sm90": (_I,),
    # q, k, v, gk, gv, o, bh, s, sg, window, head_dim, stream
    "ea_swa_fused_fwd_bf16": (_P,) * 6 + (_I,) * 5 + (_P,),
    # head_dim -> 1 if ea_swa_fused_fwd_bf16 runs the TMA + wgmma kernel
    "ea_swa_fused_fwd_uses_sm90": (_I,),
    # q, k, v, do, lse, di, dq, bh, sq, skv, kv_valid, head_dim, stream
    "ea_flash_bwd_dq_bf16": (_P,) * 7 + (_I,) * 5 + (_P,),
    # q, k, v, do, lse, di, dk, dv, bh, sq, skv, kv_valid, head_dim, stream
    "ea_flash_bwd_dkv_bf16": (_P,) * 8 + (_I,) * 5 + (_P,),
    # head_dim -> 1 if ea_flash_bwd_dq_bf16 and ea_flash_bwd_dkv_bf16 run
    # their TMA + wgmma kernels
    "ea_flash_bwd_uses_sm90": (_I,),
    # q, k, v, do, lse, di, dq, bh, s, window, head_dim, stream
    "ea_swa_bwd_dq_bf16": (_P,) * 7 + (_I,) * 4 + (_P,),
    # head_dim -> 1 if ea_swa_bwd_dq_bf16 runs the TMA + wgmma kernel
    "ea_swa_bwd_dq_uses_sm90": (_I,),
    # q, k, v, do, lse, di, dk, dv, bh, s, window, head_dim, stream
    "ea_swa_bwd_dkv_bf16": (_P,) * 8 + (_I,) * 4 + (_P,),
    # head_dim -> 1 if ea_swa_bwd_dkv_bf16 runs the TMA + wgmma kernel
    "ea_swa_bwd_dkv_uses_sm90": (_I,),
    # Q1: x, xq, ax, m, k, stream
    "ea_quantize_rows_bf16": (_P, _P, _P, _I, _I, _P),
    # Q2: acc, ax, w_scale, bias (or NULL), y, m, n, stream
    "ea_dequantize_rows_bf16": (_P,) * 5 + (_I, _I, _P),
    # Q3: packed, scale, w, s8 (or NULL), n, k, groups, to_int8, stream
    "ea_unpack_int4": (_P,) * 4 + (_I,) * 4 + (_P,),
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


def _ptxas_log(lib: Path) -> Path:
    return lib.with_name(lib.stem + ".ptxas.txt")


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
        failed, logs = [], []
        for src, proc in zip(cu, procs):
            out, err = proc.communicate()
            logs.append(f"== {src.name}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        _ptxas_log(lib).write_text("\n".join(logs))
        so = os.path.join(tmp, lib.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(so, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def ptxas_report(kernel: str) -> dict:
    """What ptxas reported for the first entry function whose mangled name
    contains `kernel`: registers, stack and spill bytes, and every warning
    line of the build."""
    lines = _ptxas_log(build_library()).read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", nxt)
                if m:
                    out.update(stack_bytes=int(m[1]),
                               spill_store_bytes=int(m[2]),
                               spill_load_bytes=int(m[3]))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    out["registers"] = int(m[1])
                    break
            break
    out["warnings"] = [x.strip() for x in lines if "warning" in x.lower()]
    return out


def _sass_function(kernel: str) -> str:
    """cuobjdump -sass (next to nvcc) of the built library's function whose
    name contains `kernel`."""
    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build_library())],
                          capture_output=True, text=True, check=True).stdout
    for section in sass.split("Function : ")[1:]:
        name, body = section.split("\n", 1)
        if kernel in name:
            return body
    raise RuntimeError(f"no function matching {kernel!r} in the library's SASS")


def sass_counts(kernel: str, opcodes) -> dict:
    """How many SASS instructions of each opcode (e.g. HGMMA, UTMALDG) the
    function whose name contains `kernel` holds."""
    body = _sass_function(kernel)
    return {op: len(re.findall(rf"\b{op}\b", body)) for op in opcodes}


def sass_sites(kernel: str, opcodes) -> list:
    """The instructions of those opcodes in that function, in address order,
    as "address: instruction" strings (where a spill sits against the
    warp roles' setmaxnreg and wgmma)."""
    sites = []
    for line in _sass_function(kernel).splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and any(re.search(rf"\b{op}\b", m[2]) for op in opcodes):
            sites.append(f"{m[1]}: {m[2]}")
    return sites


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, argtypes set."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_kernel_inputs(*tensors: torch.Tensor, kernel: str) -> None:
    """The hand kernels take contiguous, 16-byte aligned bf16 CUDA tensors
    [bh, S, d], all on one device, with d in `kernel`'s set of
    KERNEL_HEAD_DIMS; raise otherwise, naming the kernel."""
    dims = KERNEL_HEAD_DIMS[kernel]
    dev = tensors[0].device
    for x in tensors:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"kernel input on {x.device}, expected {dev} (CUDA)")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"kernel input dtype {x.dtype}, expected bfloat16")
        if x.dim() != 3 or x.shape[-1] not in dims:
            raise ValueError(f"{kernel} input shape "
                             f"{tuple(x.shape)}: expected [bh, S, d] with d "
                             f"in {dims}")
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
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {err - TENSOR_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
