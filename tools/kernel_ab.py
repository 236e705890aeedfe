"""Time the attention kernels of two builds in alternating turns, and
compare the two builds' SASS of every TMA + wgmma kernel.

    python3 tools/kernel_ab.py A_DIR B_DIR [--turns 12] [--iters 10]
                               [--only KEY]

A_DIR and B_DIR are checkouts of this repository (for example `git
archive`s of a parent commit and of a change, unpacked into a directory
that .gitignore lists). Each is built by its own ops/_build.py in a
subprocess; both libraries are then loaded into this process, and each
kernel's C entry point is timed by CUDA events on the same inputs in the
turns A B B A A B B A ..., `iters` launches a turn (5x for the V1-V3
passes short of Global_Self): K1, K3 and K4 at the
dense flagship [96, 13360, 64]; K2, K5, K6 and K7 at the banded one [96,
13104, 64], window 1008, K5 with the 1,027 global rows; K1 at V4's head
dim 88 over q [32, 36864, 88] with kv 36,864 (self attention), 333 (the
text cross pass) and 16 (the CLIP pass); K1 at the V1-V3 shapes of
chip_smoke.py's LEGACY_K1_CASES (d 72: V3's Global_Self [32, 36864],
the spatial pass [1152, 1024], the text pass [32, 36864] over 120 keys,
the temporal pass [32768, 36]; d 144: V2's temporal pass [16384, 36] and
V1's grid [4096, 64]). K5 is timed in the
same turns beside its yardstick, B's unfused pair (K2 + the K1 cross pass
over the global rows). The inputs are random bf16 q, k, v, do (q
pre-scaled as the wrappers do) with the lse of B's own forward kernel and
di = rowsum(o * do). Prints the card's name and power limit; one JSON line
per TMA + wgmma kernel (K1 at d 64, 88 and 72 and its short-head
kernel at d 144 and 72, K2, K5; K3, K4, K6, K7)
with each build's ptxas registers and spills, its SASS opcode counts and
whether the two builds' SASS is the same instruction for instruction (a
kernel that a build lacks is null there); then one JSON line per kernel:
every turn's ms, and each side's median and mean (--only: only the
kernels whose key, e.g. "K1@72", contains KEY). Needs one CUDA device and
nvcc.
"""
import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from easyanimate_tpu_torch.ops._build import _SIGNATURES  # noqa: E402

BH, S_DENSE, S_VID, WINDOW, S_GLOBAL, D = 96, 13360, 13104, 1008, 1027, 64
# V4: the CFG batch's 2 x 16 heads of 88 over 36,864 tokens; kv lengths of
# its self attention, text cross pass (77 + 256) and CLIP pass
BH88, S88, D88 = 32, 36864, 88
KV88 = {"self": S88, "text": 333, "clip": 16}
# K1's V1-V3 shapes, each over the CFG batch (chip_smoke.py's
# LEGACY_K1_CASES): (name, d, b*h, sq, skv)
LEGACY = (("K1@72 Global_Self", 72, 32, 36864, 36864),
          ("K1@72 spatial", 72, 1152, 1024, 1024),
          ("K1@72 text", 72, 32, 36864, 120),
          ("K1@72 temporal", 72, 32768, 36, 36),
          ("K1@144 V2 temporal", 144, 16384, 36, 36),
          ("K1@144 V1 grid", 144, 4096, 64, 64))
LOG2E = 1.4426950408889634
# the TMA + wgmma kernels: K1 (d 64, 88, 72; the short-head kernel at d
# 144 and 72), K2, K5; K3, K4, K6, K7
SM90_KERNELS = ("flash_fwd_sm90", "flash_fwd_d88_sm90", "flash_fwd_d72_sm90",
                "flash_fwd_short_sm90ILi144E", "flash_fwd_short_sm90ILi72E",
                "swa_fwd_sm90", "swa_fused_fwd_sm90", "flash_bwd_dq_sm90",
                "flash_bwd_dkv_sm90", "swa_bwd_dq_sm90", "swa_bwd_dkv_sm90")
# run in each tree: build its library, then print the library's path and,
# for each kernel it holds, ptxas's report and its SASS instructions
_BUILD_AND_REPORT = '''
import json, re, sys
from easyanimate_tpu_torch.ops import _build
print(_build.build_library())
out = {}
for kernel in sys.argv[1:]:
    try:
        body = _build._sass_function(kernel)
    except RuntimeError:
        continue
    out[kernel] = {"ptxas": _build.ptxas_report(kernel), "sass": re.findall(
        r"/\\*[0-9a-f]{4,}\\*/\\s+(.*?)\\s*;", body)}
print(json.dumps(out))
'''


def build(tree: Path):
    """Build `tree`'s kernel library with its own _build.py; load it.
    Returns the library and, for each of SM90_KERNELS that it holds,
    ptxas's report and its SASS instructions."""
    lines = subprocess.run(
        [sys.executable, "-c", _BUILD_AND_REPORT, *SM90_KERNELS], cwd=tree,
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    lib = ctypes.CDLL(lines[-2])
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib, json.loads(lines[-1])


def opcodes(instructions):
    """How many instructions of each opcode (predicate dropped, modifiers
    kept)."""
    counts = {}
    for ins in instructions:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items()))


def compare_builds(reports):
    """One JSON line per kernel: each build's registers, spills and
    opcode counts, and whether the two SASS listings are equal."""
    for kernel in SM90_KERNELS:
        sides = {side: rep.get(kernel) for side, rep in reports.items()}
        row = {"kernel": kernel}
        for side, r in sides.items():
            row[side] = None if r is None else {
                "registers": r["ptxas"].get("registers"),
                "spill_bytes": r["ptxas"].get("spill_store_bytes", 0)
                + r["ptxas"].get("spill_load_bytes", 0),
                "instructions": len(r["sass"]), "opcodes": opcodes(r["sass"])}
        if None not in sides.values():
            row["same_opcode_counts"] = row["a"]["opcodes"] == row["b"]["opcodes"]
            row["same_sass"] = sides["a"]["sass"] == sides["b"]["sass"]
        print(json.dumps(row), flush=True)


def call(lib, name, *args):
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: error {err}")


def inputs(lib, s, window, gen):
    """q, k, v, do, lse, di for one shape, lse from `lib`'s forward."""
    dev = torch.device("cuda")
    q, k, v, do = (torch.randn(BH, s, D, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    q = (q.float() * D ** -0.5 * LOG2E).to(torch.bfloat16)
    o = torch.empty_like(q)
    lse = torch.empty(BH, s, 1, dtype=torch.float32, device=dev)
    ptrs = [x.data_ptr() for x in (q, k, v, o, lse)]
    if window is None:
        call(lib, "ea_flash_fwd_bf16", *ptrs, BH, s, s, s, D)
    else:
        call(lib, "ea_swa_fwd_bf16", *ptrs, BH, s, window, D)
    di = (o.float() * do.float()).sum(-1)
    return q, k, v, do, lse, di


def turn_ms(fn, iters):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_d88_calls(libs, gen):
    """For each of V4's three kv lengths, each library's K1 call at d 88 on
    the same q [32, 36864, 88] and k, v, into fresh outputs."""
    dev = torch.device("cuda")
    q = (torch.randn(BH88, S88, D88, generator=gen, device=dev)
         * D88 ** -0.5 * LOG2E).to(torch.bfloat16)
    o = torch.empty_like(q)
    lse = torch.empty(BH88, S88, 1, dtype=torch.float32, device=dev)
    out = {}
    for name, kv in KV88.items():
        k, v = (torch.randn(BH88, kv, D88, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        ptrs = [x.data_ptr() for x in (q, k, v, o, lse)]
        out[f"K1@88 {name}"] = (
            {side: (lambda lib=lib, ptrs=ptrs, kv=kv: call(
                lib, "ea_flash_fwd_bf16", *ptrs, BH88, S88, kv, kv, D88))
             for side, lib in libs.items()}, (k, v))
    return out, (q, o, lse)


def legacy_calls(libs, gen):
    """For each V1-V3 shape, each library's K1 call on the same random q
    (pre-scaled), k and v, into fresh outputs."""
    dev = torch.device("cuda")
    out = {}
    for name, d, bh, sq, skv in LEGACY:
        q = (torch.randn(bh, sq, d, generator=gen, device=dev)
             * d ** -0.5 * LOG2E).to(torch.bfloat16)
        k, v = (torch.randn(bh, skv, d, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        o = torch.empty_like(q)
        lse = torch.empty(bh, sq, 1, dtype=torch.float32, device=dev)
        ptrs = [x.data_ptr() for x in (q, k, v, o, lse)]
        out[name] = (
            {side: (lambda lib=lib, ptrs=ptrs, bh=bh, sq=sq, skv=skv, d=d:
                    call(lib, "ea_flash_fwd_bf16", *ptrs, bh, sq, skv, skv, d))
             for side, lib in libs.items()}, (q, k, v, o, lse))
    return out


def entry_calls(lib, key, ins, glob):
    """The C entry point call(s) of kernel `key` on `ins` (q, k, v, do,
    lse, di of its shape; glob: the global gk, gv), into fresh outputs."""
    q, k, v, do, lse, di = ins
    bh, s, _ = q.shape
    o, o2, lse2 = torch.empty_like(q), torch.empty_like(q), torch.empty_like(lse)
    bwd = [x.data_ptr() for x in (q, k, v, do, lse, di)]
    if key == "K1":
        return lambda: call(lib, "ea_flash_fwd_bf16", q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), o.data_ptr(), lse2.data_ptr(), bh, s,
                            s, s, D)
    if key == "K2":
        return lambda: call(lib, "ea_swa_fwd_bf16", q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), o.data_ptr(), lse2.data_ptr(), bh, s,
                            WINDOW, D)
    if key == "K5":
        return lambda: call(lib, "ea_swa_fused_fwd_bf16", q.data_ptr(),
                            k.data_ptr(), v.data_ptr(), *glob, o.data_ptr(),
                            bh, s, S_GLOBAL, WINDOW, D)
    if key == "K5 pair":
        k2 = entry_calls(lib, "K2", ins, glob)
        return lambda: (k2(), call(
            lib, "ea_flash_fwd_bf16", q.data_ptr(), *glob, o2.data_ptr(),
            lse2.data_ptr(), bh, s, S_GLOBAL, S_GLOBAL, D))
    if key in ("K3", "K6"):
        name = "ea_flash_bwd_dq_bf16" if key == "K3" else "ea_swa_bwd_dq_bf16"
        outs = [o.data_ptr()]
    else:
        name = "ea_flash_bwd_dkv_bf16" if key == "K4" else "ea_swa_bwd_dkv_bf16"
        outs = [o.data_ptr(), o2.data_ptr()]
    sizes = (bh, s, s, s, D) if key in ("K3", "K4") else (bh, s, WINDOW, D)
    return lambda: call(lib, name, *bwd, *outs, *sizes)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--turns", type=int, default=12)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", default="",
                    help="time only the kernels whose key contains this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    built = {"a": build(args.a), "b": build(args.b)}
    libs = {side: lib for side, (lib, _) in built.items()}
    compare_builds({side: rep for side, (_, rep) in built.items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    dense = inputs(libs["b"], S_DENSE, None, gen)
    band = inputs(libs["b"], S_VID, WINDOW, gen)
    gk, gv = (torch.randn(BH, S_GLOBAL, D, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    glob = (gk.data_ptr(), gv.data_ptr())
    d88, _keep = k1_d88_calls(libs, gen)
    d88.update(legacy_calls(libs, gen))
    for key in ("K1", "K2", "K5", "K3", "K4", "K6", "K7", *d88):
        if args.only not in key:
            continue
        if key in d88:
            fns = d88[key][0]
        else:
            ins = dense if key in ("K1", "K3", "K4") else band
            fns = {side: entry_calls(lib, key, ins, glob)
                   for side, lib in libs.items()}
        if key == "K5":  # its yardstick, in the same turns
            fns["b pair"] = entry_calls(libs["b"], "K5 pair", ins, glob)
        for fn in fns.values():  # warm-up
            fn()
        torch.cuda.synchronize()
        ms = {side: [] for side in fns}
        # the V1-V3 passes short of Global_Self take 0.1-1 ms: 5x the
        # launches a turn
        iters = args.iters * (5 if key in {c[0] for c in LEGACY[1:]} else 1)
        for t in range(args.turns):
            for side in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
                ms[side].append(turn_ms(fns[side], iters))
        print(json.dumps({"kernel": key, "iters": iters, "ms": ms,
                          "median": {x: statistics.median(v) for x, v in ms.items()},
                          "mean": {x: statistics.fmean(v) for x, v in ms.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
