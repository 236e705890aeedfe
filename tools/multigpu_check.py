"""The multi-GPU path across cards, held against the same work on one rank:
sequence-parallel attention (ring and all-gather) and the Ulysses SWA
pass over sp ranks, and the SFT step over dp x sp ranks (ZeRO-2, then
FSDP2).

    python3 tools/multigpu_check.py [--ranks 4] [--cpu --tiny]

Spawns one process per rank that joins a group through a file store in a
temporary directory (NCCL on cuda:<rank>, or gloo with --cpu) after the
parent built the kernels. Every rank draws the whole inputs from one seed,
runs its shard and, for the reference, the whole work itself:
  attention  V5.1-12B's joint attention (batch 2, 48 heads x 64, the 256
             text rows on every rank, 13,104 video tokens cut into sp
             slices): o and the gradients of sum(o * g) in both modes
             against one K1 / K3 + K4 call over all tokens, each within
             2e-2 of its max |value| (chip_smoke.py's O_REL_BOUND and
             BWD_BOUND; the text rows' gradients summed over the ranks);
             ms of the sp call (forward + backward) and of the one call,
             each after a warm-up call.
  ulysses    swa_attention_streams at the 12B's SWA shapes under the
             scope (all-to-all to head slices, K2 + the K1 cross pass)
             against the 48-head call, within 2e-2; ms of both after a
             warm-up.
  train      the sft phase's model (the 12B's widths, 4 layers, 1-3 SWA,
             float32 masters, AdamW) on a global batch of 2 latents at
             384x672x49f with fixed draws: one step at dp x sp = (ranks/2)
             x 2 with ZeRO-2 and one with FSDP2, against a one-rank step on
             the whole batch: loss and grad norm within 1e-2 relative,
             at least 0.999 of the masters' elements updated with the
             one-rank step's sign (a first update is about lr sign(g)),
             the watched masters moved, and after a second step on the
             same batch the model holding its masters (gathered); the
             masters' distance from the one-rank step is held only to
             the sanity ceiling of Adam's envelope (2 lr, + 1% for
             float32 rounding); s of the second step (host clock after a
             synchronize) and peak memory of each.
Rank 0 prints the card's name and power limit (nvidia-smi) and one JSON
line per check; the exit code is non-zero if any check fails. --tiny cuts
the shapes for a rehearsal on the CPU.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from easyanimate_tpu_torch.models.convert import init_random_  # noqa: E402
from easyanimate_tpu_torch.models.mmdit import (  # noqa: E402
    PRESETS, EasyAnimateTransformer3D)
from easyanimate_tpu_torch.ops import _build  # noqa: E402
from easyanimate_tpu_torch.ops.attention import attention  # noqa: E402
from easyanimate_tpu_torch.ops.swa import swa_attention_streams  # noqa: E402
from easyanimate_tpu_torch.parallel import (  # noqa: E402
    MeshConfig, ZeroShards, create_mesh, dp_slice, fsdp_shard,
    init_distributed, make_sp_attention, sequence_parallel, sp_constraint)
from easyanimate_tpu_torch.pipeline.t2v import build_rope  # noqa: E402
from easyanimate_tpu_torch.training import trainer  # noqa: E402

BOUND = 2e-2        # outputs and gradients, over max |value|
TRAIN_BOUND = 1e-2  # loss and grad norm, relative
SIGN_BOUND = 0.999  # least share of master updates with the one-rank sign

FULL = dict(heads=48, d=64, text=256, grid=(13, 24, 42), latents=(13, 48, 84),
            layers=4)
TINY = dict(heads=8, d=16, text=8, grid=(2, 4, 6), latents=(2, 8, 12),
            layers=2)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _timed(fn, dev, warm=True):
    """(fn(), ms of that call); with warm, fn runs once before, untimed."""
    if warm:
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_attention(mesh, dev, dtype, shape):
    """Both sp modes over the text + this rank's video slice against one
    call over everything."""
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, d, st = 2, shape["heads"], shape["d"], shape["text"]
    sv = shape["grid"][0] * shape["grid"][1] * shape["grid"][2]
    rand = lambda: torch.randn(b, h, st + sv, d, generator=gen, device=dev
                               ).to(dtype)
    q, k, v, g = rand(), rand(), rand(), rand()
    leaves = lambda: [x.clone().requires_grad_(True) for x in (q, k, v)]
    want, ms_one = _timed(lambda: _fwd_bwd(attention, leaves(), g), dev)
    sp, r = mesh.shape["sp"], mesh.rank("sp")
    n = sv // sp
    local = lambda x: torch.cat([x[:, :, :st], x[:, :, st + r * n:
                                                 st + (r + 1) * n]], dim=2)
    g_local = local(g).clone()
    g_local[:, :, :st] /= sp  # the text term once over the ranks
    out = {}
    for mode in ("allgather", "ring"):
        fn = make_sp_attention(mesh, mode)
        ins = lambda: [local(x).clone().requires_grad_(True)
                       for x in (q, k, v)]
        got, ms = _timed(lambda: _fwd_bwd(lambda *a: fn(*a, st), ins(),
                                          g_local), dev)
        errs = {"o": _rel(got[0], local(want[0]))}
        for name, gl, gw in zip("qkv", got[1:], want[1:]):
            text = gl[:, :, :st].contiguous()
            dist.all_reduce(text, group=mesh.group("sp"))
            errs[f"d{name}"] = max(_rel(text, gw[:, :, :st]),
                                   _rel(gl[:, :, st:], local(gw)[:, :, st:]))
        out[mode] = {"ms": ms, **errs, "ok": max(errs.values()) <= BOUND}
    return {"check": "attention", "sp": sp, "shape": [b, h, st + sv, d],
            "one_call_ms": ms_one, **out,
            "ok": all(m["ok"] for m in out.values())}


def _fwd_bwd(fn, leaves, g):
    o = fn(*leaves)
    (o.float() * g.float()).sum().backward()
    return [o.detach()] + [x.grad for x in leaves]


def check_ulysses(mesh, dev, dtype, shape):
    """swa_attention_streams under the scope against the all-heads call."""
    gen = torch.Generator(device=dev).manual_seed(2)
    b, h, d, st = 2, shape["heads"], shape["d"], shape["text"]
    f, gh, gw = shape["grid"]
    grid = dict(num_frames=f, height=gh, width=gw)
    rand = lambda n: torch.randn(b, h, n, d, generator=gen, device=dev
                                 ).to(dtype)
    txt = [rand(st) for _ in range(3)]
    vid = [rand(f * gh * gw) for _ in range(3)]
    (o_t, o_v), ms_one = _timed(lambda: swa_attention_streams(
        *txt, *vid, **grid), dev)
    tokens = (None, None, "sp", None)
    with sequence_parallel(mesh):
        scope_vid = [sp_constraint(x, tokens) for x in vid]
        (ot_l, ov_l), ms = _timed(lambda: swa_attention_streams(
            *txt, *scope_vid, **grid), dev)
        err = max(_rel(ot_l, o_t), _rel(ov_l, sp_constraint(o_v, tokens)))
    return {"check": "ulysses", "sp": mesh.shape["sp"], "heads": h,
            "grid": [f, gh, gw], "text": st, "ms": ms, "one_call_ms": ms_one,
            "max_rel_err": err, "ok": err <= BOUND}


def check_train(mesh, dev, shape, seed=6):
    """One SFT step over the mesh (ZeRO-2, then FSDP2) against one rank's
    step on the whole batch."""
    cfg = dataclasses.replace(
        PRESETS["v5.1-12b"], num_layers=shape["layers"],
        swa_layers=tuple(range(1, shape["layers"])))
    if shape is TINY:
        cfg = dataclasses.replace(cfg, num_attention_heads=shape["heads"],
                                  attention_head_dim=shape["d"],
                                  text_embed_dim=32, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed)
    f, hh, ww = shape["latents"]
    lat = torch.randn(2, 16, f, hh, ww, generator=gen, device=dev)
    text = 0.02 * torch.randn(2, shape["text"], cfg.text_embed_dim,
                              generator=gen, device=dev)
    draws = trainer.FlowDraws(
        torch.rand(2, generator=gen, device=dev) * 0.9 + 0.05,
        torch.rand(2, generator=gen, device=dev) * 999.0,
        torch.randn(lat.shape, generator=gen, device=dev))
    rope = build_rope(cfg, hh * 8, ww * 8, f, device=dev)
    tcfg = trainer.TrainConfig()

    def fresh():
        model = EasyAnimateTransformer3D(cfg, device="meta")
        return init_random_(model.to_empty(device=dev),
                            torch.Generator(device=dev).manual_seed(seed))

    def run(model, batch, step_draws, step_mesh):
        """One step (checked), then a second on the same batch (timed);
        the masters after the first and after the second."""
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        state = trainer.create_train_state(model, tcfg, step_mesh)
        step = trainer.make_train_step(model, tcfg, step_mesh)
        state, metrics = step(state, batch, draws=step_draws)
        first = {n: t.clone() for n, t in state.params.items()}
        (state, _), ms = _timed(lambda: step(state, batch, draws=step_draws),
                                dev, warm=False)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if dev.type == "cuda" else None)
        return first, state.params, metrics, ms / 1e3, peak

    model = fresh()
    init = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    want, _, ref_m, ref_s, ref_peak = run(
        model, {"latents": lat, "text": text, "rope": rope}, draws, None)
    del model
    out = {"check": "train", "mesh": mesh.shape, "one_rank_s": ref_s,
           "one_rank_peak_gib": ref_peak, "one_rank_loss": float(ref_m["loss"])}
    rows = lambda x: dp_slice(mesh, x)
    batch = {"latents": rows(lat), "text": rows(text), "rope": rope}
    local = trainer.FlowDraws(*(rows(x) for x in draws))
    # sanity ceiling: Adam's first update is at most lr a element; 1% for
    # float32 rounding
    envelope = 2 * tcfg.learning_rate * 1.01
    watch = ("transformer_blocks.0.attn1.to_q.weight",
             f"transformer_blocks.{cfg.num_layers - 1}.ff.net.2.weight",
             "proj_out.weight")
    ok = True
    for name in ("zero2", "fsdp"):
        model = fresh()
        if name == "fsdp":
            fsdp_shard(model, mesh)
        params, last, metrics, s, peak = run(model, batch, local, mesh)
        shards = ZeroShards(dict(model.named_parameters()), mesh)
        errs = {"loss_rel_err": abs(float(metrics["loss"]) / float(ref_m["loss"])
                                    - 1),
                "grad_norm_rel_err": abs(float(metrics["grad_norm"])
                                         / float(ref_m["grad_norm"]) - 1)}
        err = agree = total = 0
        moved = {}
        for n, chunk in params.items():
            whole = shards.full(n, chunk)
            err = max(err, (whole - want[n]).abs().max().item())
            agree += ((whole - init[n]).sign() == (want[n] - init[n]).sign()
                      ).sum().item()
            total += whole.numel()
            if n in watch:
                moved[n] = (whole - init[n]).abs().max().item()
        synced = True
        for n, p in model.named_parameters():  # after the second step
            held = p.full_tensor() if shards.fsdp else p
            synced &= torch.equal(held, shards.full(n, last[n]).to(p.dtype))
        res = {**errs, "master_max_abs_err": err, "master_bound": envelope,
               "update_sign_agreement": agree / total,
               "master_max_abs_change": moved, "model_matches_masters": synced,
               "s_per_step": s, "peak_gib": peak,
               "ok": (max(errs.values()) <= TRAIN_BOUND
                      and agree / total >= SIGN_BOUND and err <= envelope
                      and len(moved) == len(watch)
                      and all(v > 0 for v in moved.values()) and synced)}
        out[name] = res
        ok = ok and res["ok"]
        del model, params
    out["ok"] = ok
    return out


def rank_main(rank, world, root, cpu, tiny):
    dev = init_distributed(f"file://{root}/store", world, rank,
                           device="cpu" if cpu else None)
    try:
        shape = TINY if tiny else FULL
        dtype = torch.float32 if cpu else torch.bfloat16
        sp_mesh = create_mesh(MeshConfig(dp=1, sp=world))
        results = [check_attention(sp_mesh, dev, dtype, shape),
                   check_ulysses(sp_mesh, dev, dtype, shape),
                   check_train(create_mesh(MeshConfig(dp=world // 2, sp=2)),
                               dev, shape)]
        oks = torch.tensor([float(all(r["ok"] for r in results))], device=dev)
        dist.all_reduce(oks, op=dist.ReduceOp.MIN)
        if rank == 0:
            for r in results:
                print(json.dumps(r), flush=True)
        if not oks.item():
            raise SystemExit(f"rank {rank}: a multi-GPU check failed")
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU (the kernels' plain versions)")
    ap.add_argument("--tiny", action="store_true", help="small shapes")
    args = ap.parse_args()
    if args.ranks % 2 or args.ranks < 2:
        raise SystemExit("--ranks must be even (the train check is dp x 2)")
    if not args.cpu:
        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"needs {args.ranks} CUDA devices, found "
                             f"{torch.cuda.device_count()}")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(), flush=True)
        _build.build_library()  # once, before the ranks load it
    with tempfile.TemporaryDirectory() as root:
        mp.start_processes(rank_main, args=(args.ranks, root, args.cpu,
                                            args.tiny),
                           nprocs=args.ranks, start_method="spawn")
    print(json.dumps({"ok": True, "ranks": args.ranks,
                      "device": "cpu" if args.cpu
                      else torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
