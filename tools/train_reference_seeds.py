"""The error of chip_smoke.py's tiny LCM, reward and VAE-GAN training steps
on the card against the CPU in float32, over several seeds: beside the
bf16 floor, beside the same bf16 model on the card with the attention
kernels swapped for their plain versions, and with one attention kernel
broken on purpose, so that the bounds can be set between the healthy
noise and a wrong kernel.

    python3 tools/train_reference_seeds.py [--seeds 17 18 19 ...]

A seed draws the LoRA and EMA factors, the LCM draws, the reward noise and
the VAE's clip and sample draw; the tiny models' weights stay those of
chip_smoke.py, whose `train_reference` phase runs seed 17. The broken
kernels: K1 hands each query row its neighbour's output, K3 drops dq, K4
drops dk and dv. Prints the card's name and power limit (chip_smoke.py's
device line), one JSON line per seed: for lcm and reward the error of
the card, of the bf16 floor (the CPU's plain versions in
bf16), of the plain attention on the card and of each broken kernel; for
vae and disc (float32) the card's; each beside chip_smoke.py's bounds and
whether the card holds them. Then one JSON line with, per kind and run,
the largest and the smallest error over the seeds. Each error is
chip_smoke.py's train_step_errors: the loss's, the gradients' relative L2
and the largest gradient error over the largest |gradient|. Needs one
CUDA device and nvcc.
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from easyanimate_tpu_torch.ops import _build  # noqa: E402
from easyanimate_tpu_torch.ops import flash_attention as fa  # noqa: E402
from easyanimate_tpu_torch.ops import swa  # noqa: E402

REAL = {(mod, name): getattr(mod, name) for mod in (fa, swa)
        for name in ("flash_attention_fwd", "flash_attention_bwd")}
REAL.update({(swa, name): getattr(swa, name)
             for name in ("sliding_window_fwd", "sliding_window_bwd")})


def _fwd_rows_rolled(*args):
    o, lse = REAL[fa, "flash_attention_fwd"](*args)
    return o.roll(1, dims=1).contiguous(), lse


def _bwd_without_dq(*args):
    dq, dk, dv = REAL[fa, "flash_attention_bwd"](*args)
    return torch.zeros_like(dq), dk, dv


def _bwd_without_dkv(*args):
    dq, dk, dv = REAL[fa, "flash_attention_bwd"](*args)
    return dq, torch.zeros_like(dk), torch.zeros_like(dv)


RUNS = {
    "plain": {"flash_attention_fwd": fa.flash_attention_plain,
              "flash_attention_bwd": fa.flash_attention_bwd_plain,
              "sliding_window_fwd": swa.sliding_window_plain,
              "sliding_window_bwd": swa.sliding_window_bwd_plain},
    "broken_K1": {"flash_attention_fwd": _fwd_rows_rolled},
    "broken_K3": {"flash_attention_bwd": _bwd_without_dq},
    "broken_K4": {"flash_attention_bwd": _bwd_without_dkv},
}


@contextlib.contextmanager
def swapped(funcs):
    """Within the block, the named attention entry points of ops/
    flash_attention.py and ops/swa.py are `funcs`' (swa.py imports K1's
    wrappers by name). The real wrappers count their launches on the
    function their module's name holds, so each stand-in carries counts."""
    for f in funcs.values():
        f.launches = f.launches_sm90 = 0
        f.launches_by_dim = {}
    for (mod, name), real in REAL.items():
        setattr(mod, name, funcs.get(name, real))
    try:
        yield
    finally:
        for (mod, name), real in REAL.items():
            setattr(mod, name, real)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=list(range(17, 25)))
    args = ap.parse_args()
    cs.phase_device()
    _build.build_library()
    _build.load_library()
    spread = {}
    for seed in args.seeds:
        line = {"seed": seed}
        for kind, row in cs.train_reference_errors(seed).items():
            line[kind] = {"card": row["err"], "bounds": row["bounds"],
                          "ok": row["ok"]}
            if "floor" in row:
                line[kind]["floor"] = row["floor"]
        f32 = cs._train_reference_slice((("cpu", "float32"),), seed)[0]
        for run, funcs in RUNS.items():
            with swapped(funcs):
                got = cs._train_reference_slice((("cuda", "bfloat16"),),
                                                seed)[0]
            for kind in ("lcm", "reward"):
                line[kind][run] = cs.train_step_errors(got, f32, kind)
        for kind, runs in line.items():
            if kind == "seed":
                continue
            for run, err in runs.items():
                if run in ("bounds", "ok"):
                    continue
                s = spread.setdefault(kind, {}).setdefault(
                    run, {"max": [0.0] * 3, "min": [float("inf")] * 3})
                for i in range(3):
                    s["max"][i] = max(s["max"][i], err[i])
                    s["min"][i] = min(s["min"][i], err[i])
        print(json.dumps(line), flush=True)
    print(json.dumps({"seeds": args.seeds, "spread": spread}), flush=True)


if __name__ == "__main__":
    main()
