"""Rank bodies of the port's multi-rank CPU tests (test_torch_parallel.py,
test_torch_parallel_train.py) and the launcher that spawns them.

Each test starts `world` processes (forks of a fork server that imported
torch and the port once) that join a gloo group through a FileStore under
the test's tmp_path (no port to collide on), with a 60 s
collective timeout and a join deadline, so a hang fails the test instead
of eating the suite's time. A body reads the inputs the test wrote
(`inputs.pt`: numpy arrays drawn from a seed), runs the port on its shard
and returns what the test compares, saved as `out<rank>.pt`. This module
imports no JAX: the test process holds the JAX side.
"""
import os
import sys
import time
import warnings

import numpy as np
import torch
import torch.multiprocessing as mp

# a body's collectives raise after this; the launcher gives up after JOIN_S
COLLECTIVE_S = 60
JOIN_S = 240
# what the fork server imports before it forks the ranks (no JAX)
_PRELOAD = ["torch", "torch.distributed", "torch.distributed.tensor",
            "torch.distributed.fsdp", "numpy", "tests.torch_parallel_workers",
            "easyanimate_tpu_torch.parallel", "easyanimate_tpu_torch.train",
            "easyanimate_tpu_torch.pipeline.t2v"]


class Ranks:
    """`world` spawned ranks running body(rank, world, tmp_path, **kw);
    the test does its JAX side while they run, then joins them."""

    def __init__(self, body, world: int, tmp_path, **kw):
        self.name, self.world, self.tmp = body.__name__, world, str(tmp_path)
        # a fork server that imported torch and the port once serves every
        # test of this process: a rank starts in a fork, not a fresh import
        mp.get_context("forkserver").set_forkserver_preload(_PRELOAD)
        self.ctx = mp.start_processes(_entry, args=(world, self.tmp,
                                                    self.name, kw),
                                      nprocs=world, join=False,
                                      start_method="forkserver")
        self.deadline = time.monotonic() + JOIN_S

    def join(self):
        """The ranks' results. A rank's exception fails the caller with
        its traceback; ranks still running at the deadline are killed."""
        while not self.ctx.join(timeout=1):
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise AssertionError(f"{self.name}: ranks still running "
                                     f"after {JOIN_S} s")
        return [torch.load(os.path.join(self.tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def run_ranks(body, world: int, tmp_path, **kw):
    """Ranks(...).join(): spawn, wait, the list of their results."""
    return Ranks(body, world, tmp_path, **kw).join()


def _entry(rank, world, tmp, name, kw):
    warnings.filterwarnings("ignore")
    # the metric logger's TensorBoard writer would import TensorFlow (~7 s)
    sys.modules.setdefault("tensorflow", None)
    torch.set_num_threads(1)
    from easyanimate_tpu_torch.parallel import init_distributed

    if name != "train_driver":  # the driver joins the group itself
        init_distributed(f"file://{tmp}/store", world, rank, device="cpu",
                         timeout_s=COLLECTIVE_S)
    try:
        out = globals()[name](rank, world, tmp, **kw)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _inputs(tmp):
    return torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- attention -----------------------------------------------------------------


def sp_attention(rank, world, tmp):
    """Both modes over token slices of q, k, v [B, H, S, D]: the local o
    and the gradients of sum(o * g) for the rank's slices."""
    from easyanimate_tpu_torch.parallel import (MeshConfig, create_mesh,
                                                make_sp_attention)

    ins = _inputs(tmp)
    mesh = create_mesh(MeshConfig(dp=1, sp=world))
    n = ins["q"].shape[2] // world
    cut = lambda a: _t(a)[:, :, rank * n:(rank + 1) * n]
    out = {}
    for mode in ("allgather", "ring"):
        q, k, v = (cut(ins[x]).clone().requires_grad_(True) for x in "qkv")
        o = make_sp_attention(mesh, mode, shape=ins["q"].shape)(q, k, v)
        (o * cut(ins["g"])).sum().backward()
        out[mode] = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
    return out


def ulysses_streams(rank, world, tmp):
    """swa_attention_streams under sequence_parallel over the rank's video
    slice, for each head count in the inputs: outputs and the gradients of
    this rank's share of sum(o_t * g_t) + sum(o_v * g_v) (its video rows,
    1/sp of the text term every rank computes), whose sum over the ranks
    is the whole loss's gradient."""
    from easyanimate_tpu_torch.ops.attention import attention
    from easyanimate_tpu_torch.ops.swa import swa_attention_streams
    from easyanimate_tpu_torch.parallel import (MeshConfig, create_mesh,
                                                sequence_parallel)
    from easyanimate_tpu_torch.parallel.context import head_parallel_call

    mesh = create_mesh(MeshConfig(dp=1, sp=world))
    out = {}
    for heads, ins in _inputs(tmp).items():
        n = ins["q_vid"].shape[2] // world
        txt = [_t(ins[f"{x}_txt"]).requires_grad_(True) for x in "qkv"]
        vid = [_t(ins[f"{x}_vid"])[:, :, rank * n:(rank + 1) * n].clone()
               .requires_grad_(True) for x in "qkv"]
        with sequence_parallel(mesh):
            o_t, o_v = swa_attention_streams(*txt, *vid, **ins["grid"])
        g_v = _t(ins["g_vid"])[:, :, rank * n:(rank + 1) * n]
        ((o_t * _t(ins["g_txt"])).sum() / world
         + (o_v * g_v).sum()).backward()
        # head_parallel_call over the video slices: the head-sliced call
        # (or, when sp does not divide the heads, the gathered one)
        full = [_t(ins[f"{x}_vid"]) for x in "qkv"]
        hp = head_parallel_call(attention, mesh, full[0].shape)(
            *(t.detach() for t in vid))
        hp_err = (hp - attention(*full)[:, :, rank * n:(rank + 1) * n]
                  ).abs().max().item()
        out[heads] = {"o_t": o_t.detach().numpy(), "o_v": o_v.detach().numpy(),
                      "d_txt": [t.grad.numpy() for t in txt],
                      "d_vid": [t.grad.numpy() for t in vid],
                      "head_parallel_err": hp_err}
    return out


# -- the T2V pipeline ----------------------------------------------------------


def sp_pipeline(rank, world, tmp, mmdit_cfg, vae_cfg):
    """The tiny T2V pipeline under sequence_parallel: ring mode on the
    inputs' request; TeaCache (skipping every middle step) under the
    all-gather mode, and the same TeaCache request without a scope on this
    rank; TeaCache's gate on token slices under the scope and on the whole
    tensors without it."""
    from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
    from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit
    from easyanimate_tpu_torch.parallel import (MeshConfig, create_mesh,
                                                sequence_parallel)
    from easyanimate_tpu_torch.pipeline.t2v import (TEACACHE_COEFFICIENTS,
                                                    EasyAnimatePipeline,
                                                    teacache_gate)

    ins = _inputs(tmp)
    model = EasyAnimateTransformer3D(mmdit_cfg, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in ins["weights"].items()})
    pipe = EasyAnimatePipeline(model, AutoencoderKLMagvit(vae_cfg,
                                                          device="meta"),
                               "cpu")
    mesh = create_mesh(MeshConfig(dp=1, sp=world))
    kw = dict(ins["kw"], latents=_t(ins["lat0"]), output_type="latent")
    pos = _t(ins["pos"])
    neg = torch.zeros_like(pos)
    with sequence_parallel(mesh, "ring"):
        ring = pipe(pos, neg, **kw)
    with sequence_parallel(mesh, "allgather"):
        tea = pipe(pos, neg, teacache_threshold=1e9, **kw)
        tea_skips = pipe.last_teacache_skips
    tea_one = pipe(pos, neg, teacache_threshold=1e9, **kw)
    mod, prev = (_t(ins[k]) for k in ("mod", "prev"))
    n = mod.shape[1] // world
    gate = lambda m, p: teacache_gate(m, p, torch.zeros(()), 1, 4, 0.1,
                                      TEACACHE_COEFFICIENTS)[1]
    with sequence_parallel(mesh):
        rel = gate(mod[:, rank * n:(rank + 1) * n],
                   prev[:, rank * n:(rank + 1) * n])
    return {"ring": ring.numpy(), "tea": tea.numpy(),
            "tea_one": tea_one.numpy(), "skips": tea_skips,
            "skips_one": pipe.last_teacache_skips, "rel": float(rel),
            "rel_one": float(gate(mod, prev))}


# -- training ------------------------------------------------------------------


def train_step(rank, world, tmp, mmdit_cfg, train_cfg, mesh_cfg, fsdp):
    """One make_train_step on this rank's dp rows of the inputs' global
    batch and draws; the first data rank returns the whole updated
    masters, EMA and model parameters, the loss and the grad norm."""
    from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
    from easyanimate_tpu_torch.parallel import (ZeroShards, create_mesh,
                                                dp_slice, fsdp_shard)
    from easyanimate_tpu_torch.training import trainer

    ins = _inputs(tmp)
    mesh = create_mesh(mesh_cfg)
    model = EasyAnimateTransformer3D(mmdit_cfg, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in ins["weights"].items()})
    if fsdp:
        fsdp_shard(model, mesh)
    state = trainer.create_train_state(model, train_cfg, mesh)
    step = trainer.make_train_step(model, train_cfg, mesh)
    rows = lambda a: dp_slice(mesh, _t(a))
    batch = {"latents": rows(ins["latents"]), "text": rows(ins["text"]),
             "rope": tuple(_t(r) for r in ins["rope"])}
    draws = trainer.FlowDraws(*(rows(ins[k])
                                for k in ("sigmas", "timesteps", "noise")))
    state, metrics = step(state, batch, draws=draws)
    named = dict(model.named_parameters())
    shards = ZeroShards(named, mesh)
    whole = shards.gather_state(state)
    params = {n: shards.full(n, p.to_local() if shards.fsdp else p).detach()
              for n, p in named.items()}
    if mesh.rank("data"):
        return {}
    np_ = lambda tree: {n: t.numpy() for n, t in tree.items()}
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "masters": np_(whole.params), "ema": np_(whole.ema_params),
            "model": np_(params), "fsdp": shards.fsdp}


def train_driver(rank, world, tmp, argv):
    """train.main(argv + --distributed ...) on this rank for one step, then
    again with --resume_from_checkpoint for a second (a sharded restore of
    the first run's checkpoint, held bit for bit against that run's final
    state). The first rank returns the losses, whether the restore was
    exact, and the whole final state's tensors."""
    from easyanimate_tpu_torch import train
    from easyanimate_tpu_torch.parallel import ZeroShards
    from easyanimate_tpu_torch.training.checkpoints import flatten_state

    seen = {}
    make = train.make_train_step

    def recording_step(model, cfg, mesh=None):
        seen["shards"] = ZeroShards(dict(model.named_parameters()), mesh)
        return make(model, cfg, mesh)

    def whole(state):
        tensors = []
        flatten_state(seen["shards"].gather_state(state), tensors)
        return tensors

    class Recording(train.CheckpointManager):
        def restore_latest(self, template=None, device=None):
            out = super().restore_latest(template, device)
            seen["restored"] = whole(out[0])
            return out

    train.make_train_step, train.CheckpointManager = recording_step, Recording

    def run(extra, store):
        return train.main(argv + extra + [
            "--distributed", "--coordinator_address", f"file://{tmp}/{store}",
            "--num_processes", str(world), "--process_id", str(rank)],
            device="cpu")

    first = run(["--max_train_steps", "1"], "store1")
    saved = whole(first.state)
    torch.distributed.destroy_process_group()
    second = run(["--max_train_steps", "2", "--resume_from_checkpoint"],
                 "store2")
    final = whole(second.state)
    if rank:
        return {}
    return {"losses": first.losses + second.losses,
            "fsdp": seen["shards"].fsdp, "resumed_from": second.step0,
            "restored_equal": len(saved) == len(seen["restored"]) and all(
                torch.equal(a, b) for a, b in zip(saved, seen["restored"])),
            "tensors": [t.numpy() for t in final]}
