"""The error of chip_smoke.py's tiny V5, V4 or V1-V3 request (its
`reference` phase) on the card against the CPU in float32: with the
kernels as built, with the attention kernels swapped for their plain
versions, with K1 broken on purpose (each query row handed its
neighbour's output; for V1-V3 at head dim 72 alone and at 144 alone),
and the bf16 floor (the plain versions in bf16 on the CPU), so that the
bounds can be seen to sit between the healthy noise and a wrong kernel.

    python3 tools/reference_rehearsal.py [--kind v5|v4|legacy]

Prints the card's name and power limit (chip_smoke.py's device line),
then one JSON line: per run the largest |latents - CPU float32| over the
largest |CPU float32 latents| and over the floor's error, beside
chip_smoke.py's bounds for the kind (REF_V5_*, REF_V4_*, REF_LEGACY_*)
and whether the run holds both. Needs one CUDA device and nvcc.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
from easyanimate_tpu_torch.ops import _build  # noqa: E402
from easyanimate_tpu_torch.ops import flash_attention as fa  # noqa: E402
from train_reference_seeds import REAL, RUNS, swapped  # noqa: E402

BOUNDS = {"v5": (cs.REF_V5_REL_BOUND, cs.REF_V5_FLOOR_MULT),
          "v4": (cs.REF_V4_REL_BOUND, cs.REF_V4_FLOOR_MULT),
          "legacy": (cs.REF_LEGACY_REL_BOUND, cs.REF_LEGACY_FLOOR_MULT)}


def broken_at(head_dim):
    """K1 with each query row handed its neighbour's output at `head_dim`
    only, right at every other head dim."""
    def fwd(*args):
        o, lse = REAL[fa, "flash_attention_fwd"](*args)
        if args[0].shape[-1] == head_dim:
            o = o.roll(1, dims=1).contiguous()
        return o, lse
    return {"flash_attention_fwd": fwd}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=sorted(BOUNDS), default="v5")
    kind = ap.parse_args().kind
    cs.phase_device()
    _build.build_library()
    _build.load_library()
    outs, _ = cs.reference_runs(kind, [("cpu", "cpu", "float32"),
                                       ("cpu_bf16", "cpu", "bfloat16"),
                                       ("card", "cuda", "bfloat16")])
    runs = {"plain": RUNS["plain"]}
    if kind == "legacy":  # the tiny model's K1 runs at d 72 and 144
        runs.update({f"broken_K1@{d}": broken_at(d) for d in (72, 144)})
    else:
        runs["broken_K1"] = RUNS["broken_K1"]
    for run, funcs in runs.items():
        with swapped(funcs):
            outs.update(cs.reference_runs(
                kind, [(f"card_{run}", "cuda", "bfloat16")])[0])
    ref = outs.pop("cpu")
    scale = ref.abs().max().item()
    floor = (outs["cpu_bf16"] - ref).abs().max().item()
    rel, mult = BOUNDS[kind]
    line = {"kind": kind, "latents_abs_max": scale, "bound_rel": rel,
            "bound_over_floor": mult}
    for name, out in outs.items():
        err = (out - ref).abs().max().item()
        line[name] = {"rel_err": err / scale, "over_floor": err / floor,
                      "ok": err / scale <= rel and err <= mult * floor}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
