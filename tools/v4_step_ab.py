"""Time V4's T2V and I2V denoise steps of two builds in alternating turns.

    python3 tools/v4_step_ab.py A_DIR B_DIR [--turns 4] [--steps 2]

A_DIR and B_DIR are checkouts of this repository (for example `git
archive`s of a parent commit and of a change, unpacked into a directory
that .gitignore lists). Each turn runs one tree's own `chip_smoke.py`
V4 requests in a fresh process in that tree (its kernels built by its
own ops/_build.py): the HunyuanDiT at full width and depth with random
bf16 weights and the slice_mag MagViT, at 512x512x144f, DDIM, CFG 6.0, a
T2V request (decoded) and an I2V one on the -InP variant with CLIP
states, exactly as `chip_smoke.py`'s `v4_t2v` and `v4_i2v` phases. The
turns go A B B A ...; prints the card's name and power limit, one JSON
line per turn (each request's steps, encode or decode seconds), then each
side's median over its warm steps: a process's first step (its T2V
request's first) also builds or loads the kernels and initialises the
libraries, so it is left out. Needs one CUDA device and nvcc.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# run in each tree: chip_smoke's own V4 requests, its JSON lines on stdout
_REQUESTS = '''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
seed, steps = int(sys.argv[1]), int(sys.argv[2])
model, vae = cs.v4_models(seed)
pipe = cs.EasyAnimatePipeline(model, vae, scheduler=cs.DDIMConfig())
cs.v4_request("v4_t2v", pipe, seed + 1, steps)
pipe = cs.EasyAnimateInpaintPipeline(cs.v4_inpaint_variant(model, seed + 2),
                                     vae, scheduler=cs.DDIMConfig())
gen = torch.Generator(device=cs.DEVICE).manual_seed(seed + 3)
image = torch.randint(0, 256, (cs.V4_H, cs.V4_W, 3), generator=gen,
                      device=cs.DEVICE, dtype=torch.uint8).cpu().numpy()
video, mask = cs.get_image_to_video_latent(image, None, cs.V4_FRAMES,
                                           (cs.V4_H, cs.V4_W))
cs.v4_request("v4_i2v", pipe, seed + 4, steps, video=video, mask_video=mask,
              clip_encoder_hidden_states=torch.randn(
                  1, cs.V4_CLIP_N, cs.V4_CLIP_DIM, generator=gen,
                  device=cs.DEVICE),
              clip_apply_ratio=cs.V4_CLIP_RATIO)
'''
KEYS = ("denoise_s_per_step", "step_s", "vae_decode_s", "vae_encode_s",
        "max_memory_allocated_gib", "ok")


def turn(tree: Path, seed: int, steps: int) -> dict:
    """One tree's two requests in a fresh process: {phase: its numbers}."""
    out = subprocess.run([sys.executable, "-c", _REQUESTS, str(seed),
                          str(steps)], cwd=tree, capture_output=True,
                         text=True)
    if out.returncode:
        raise RuntimeError(f"{tree}: exit {out.returncode}\n{out.stderr[-4000:]}")
    rows = {}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            if r.get("phase") in ("v4_t2v", "v4_i2v"):
                if not r["ok"]:
                    raise AssertionError(f"{tree}: {r}")
                rows[r["phase"]] = {k: r[k] for k in KEYS if k in r}
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=94)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    warm = {side: {"v4_t2v": [], "v4_i2v": []} for side in "ab"}
    for t in range(args.turns):
        for side in ("ab" if t % 2 == 0 else "ba"):
            tree = args.a if side == "a" else args.b
            rows = turn(tree, args.seed, args.steps)
            for phase, r in rows.items():
                warm[side][phase] += r["step_s"][phase == "v4_t2v":]
            print(json.dumps({"turn": t, "side": side, "tree": str(tree),
                              **rows}), flush=True)
    print(json.dumps({"median_warm_s_per_step": {
        side: {phase: statistics.median(v) for phase, v in phases.items()}
        for side, phases in warm.items()}, "warm_steps": warm}), flush=True)


if __name__ == "__main__":
    main()
