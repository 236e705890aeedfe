"""The error of chip_smoke.py's tiny V5 request (its `reference` phase) on
the card against the CPU in float32: with the kernels as built, with the
attention kernels swapped for their plain versions, with K1 broken on
purpose (each query row handed its neighbour's output), and the bf16
floor (the plain versions in bf16 on the CPU), so that the bounds can be
seen to sit between the healthy noise and a wrong kernel.

    python3 tools/v5_reference_rehearsal.py

Prints the card's name and power limit (chip_smoke.py's device line),
then one JSON line: per run the largest |latents - CPU float32| over the
largest |CPU float32 latents| and over the floor's error, beside
chip_smoke.py's REF_V5_REL_BOUND and REF_V5_FLOOR_MULT and whether the
run holds both. Needs one CUDA device and nvcc.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
from easyanimate_tpu_torch.ops import _build  # noqa: E402
from train_reference_seeds import RUNS, swapped  # noqa: E402


def main():
    cs.phase_device()
    _build.build_library()
    _build.load_library()
    outs, _ = cs.reference_runs("v5", [("cpu", "cpu", "float32"),
                                       ("cpu_bf16", "cpu", "bfloat16"),
                                       ("card", "cuda", "bfloat16")])
    for run in ("plain", "broken_K1"):
        with swapped(RUNS[run]):
            outs.update(cs.reference_runs(
                "v5", [(f"card_{run}", "cuda", "bfloat16")])[0])
    ref = outs.pop("cpu")
    scale = ref.abs().max().item()
    floor = (outs["cpu_bf16"] - ref).abs().max().item()
    line = {"latents_abs_max": scale, "bound_rel": cs.REF_V5_REL_BOUND,
            "bound_over_floor": cs.REF_V5_FLOOR_MULT}
    for name, out in outs.items():
        err = (out - ref).abs().max().item()
        line[name] = {"rel_err": err / scale, "over_floor": err / floor,
                      "ok": (err / scale <= cs.REF_V5_REL_BOUND
                             and err <= cs.REF_V5_FLOOR_MULT * floor)}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
