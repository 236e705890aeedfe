"""Time K1 at head dim 72 on its two routes over short and middle q
lengths, in the same turns: flash_fwd_d72_sm90 (TMA + wgmma, 192-row q
blocks in a persistent walk, csrc/fwd_split_sm90.cuh) and, at 64 q and kv
rows or fewer, flash_fwd_short_sm90 (one head a 64-row wgmma tile, heads
walked by one block an SM, csrc/fwd_short_sm90.cuh), to place
csrc/flash_fwd.cu's kShortRows (the q and kv length at or below which d
72 takes flash_fwd_short_sm90 rather than the walk).

    python3 tools/k1_d72_crossover.py [--turns 6] [--iters 20]

Copies this checkout's package twice into build/k1_crossover/ (which
.gitignore lists), with kShortRows set so that every d 72 call of a
length takes one route ("sm90": 0; "short": 64), builds them at once with
their own ops/_build.py, and times each library's ea_flash_fwd_bf16 by
CUDA events on the same random bf16 inputs (q pre-scaled as the wrapper
does, kv = q length) in the turns A B B A ..., `iters` launches a turn, at q lengths 36 (V3's temporal pass over 36
latent frames, b*h 32,768 at 512 x 512), 64, 96, 128, 192 and 256, b*h
set so that each shape holds the same 1,179,648 q rows ("short" at 36 and
64 only). Each route's output is held against the plain version (max |o -
plain| over max |plain|). Prints the card's name and power limit, one
JSON line per length (each route's ms per turn, median, error and the
fastest route), and a last one with the shortest length from which the
sm90 kernel's median is the lowest. Needs one CUDA device and nvcc.
"""
import argparse
import concurrent.futures
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from easyanimate_tpu_torch.ops._build import _SIGNATURES  # noqa: E402
from easyanimate_tpu_torch.ops.flash_attention import (  # noqa: E402
    LOG2E, flash_attention_plain)

D = 72
ROWS = 32768 * 36  # V3's temporal pass: b*h 2 x 1,024 x 16, 36 frames
LENGTHS = (36, 64, 96, 128, 192, 256)
SHORT_MAX = 64  # the short-head kernel's limit on q and kv rows
# kShortRows of each route's build
ROUTES = {"sm90": 0, "short": SHORT_MAX}


def build(route: str, short_rows: int) -> ctypes.CDLL:
    """A copy of the package with kShortRows = short_rows, built by its own
    _build.py in a subprocess, loaded with the entry points' types."""
    tree = ROOT / "build" / "k1_crossover" / route
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "easyanimate_tpu_torch",
                    tree / "easyanimate_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = tree / "easyanimate_tpu_torch" / "csrc" / "flash_fwd.cu"
    text = src.read_text()
    text, n = re.subn(r"constexpr int kShortRows = \d+;",
                      f"constexpr int kShortRows = {short_rows};", text)
    if n != 1:
        raise RuntimeError("kShortRows not found in csrc/flash_fwd.cu")
    src.write_text(text)
    out = subprocess.run(
        [sys.executable, "-c", "from easyanimate_tpu_torch.ops import _build;"
         " print(_build.build_library())"], cwd=tree, check=True,
        capture_output=True, text=True).stdout.strip().splitlines()[-1]
    lib = ctypes.CDLL(out)
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def lengths(route):
    """The q lengths a route is timed at."""
    return [s for s in LENGTHS if route != "short" or s <= SHORT_MAX]


def turn_ms(fn, iters):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_d72_crossover: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(ROUTES)) as pool:
        futures = {r: pool.submit(build, r, n) for r, n in ROUTES.items()}
        libs = {r: f.result() for r, f in futures.items()}
    for route, lib in libs.items():  # each build takes its one route
        for s in lengths(route):
            got = (lib.ea_flash_fwd_uses_sm90(D, s, s),
                   lib.ea_flash_fwd_uses_short(D, s, s))
            if got != (1, route == "short"):
                raise RuntimeError(f"{route} build does not take its route")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    cross = None
    for s in LENGTHS:
        bh = ROWS // s
        q = (torch.randn(bh, s, D, generator=gen, device="cuda")
             * D ** -0.5 * LOG2E).to(torch.bfloat16)
        k, v = (torch.randn(bh, s, D, generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        ref = flash_attention_plain(q, k, v)[0].float()
        fns, row = {}, {"shape": [bh, s, D], "err": {}}
        for route, lib in libs.items():
            if s not in lengths(route):
                continue
            o = torch.empty_like(q)
            lse = torch.empty(bh, s, 1, dtype=torch.float32, device="cuda")

            def fn(lib=lib, o=o, lse=lse):
                err = lib.ea_flash_fwd_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), bh, s, s, s, D, stream)
                if err:
                    raise RuntimeError(f"ea_flash_fwd_bf16: error {err}")
            fn()
            torch.cuda.synchronize()
            row["err"][route] = ((o.float() - ref).abs().max()
                                 / ref.abs().max()).item()
            fns[route] = fn
        ms = {route: [] for route in fns}
        for t in range(args.turns):
            for route in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
                ms[route].append(turn_ms(fns[route], args.iters))
        row.update(ms=ms, median={r: statistics.median(x)
                                  for r, x in ms.items()})
        row["fastest"] = min(row["median"], key=row["median"].get)
        if cross is None and row["fastest"] == "sm90":
            cross = s
        print(json.dumps(row), flush=True)
        del q, k, v, ref, fns
        torch.cuda.empty_cache()
    print(json.dumps({"iters": args.iters, "turns": args.turns,
                      "sm90_fastest_from": cross}), flush=True)


if __name__ == "__main__":
    main()
