"""SFT / LoRA training driver, on one GPU or many.

    python -m easyanimate_tpu_torch.train --train_data_meta train.json \\
        --output_dir runs/x [--model_path model_dir] \\
        [--text_encoder_path qwen_dir] [--lora_rank 128] \\
        [--loss_type flow|ddpm|sigma] [--optimizer adamw|came|adamw8bit] \\
        [--trainable_modules attn1 ff --trainable_modules_low_learning_rate \\
         txt_ff] [--gradient_accumulation_steps 4 --lr_scheduler cosine] \\
        [--enable_inpaint] [--train_mode sft|control|control_camera_ref] \\
        [--resume_from_checkpoint] [--tiny_demo]
    torchrun --nproc_per_node 8 -m easyanimate_tpu_torch.train ... \\
        --distributed --mesh dp=2,sp=4 [--fsdp]

Parity: examples/train.py of the JAX package (reference scripts/train.py,
train_lora.py, train_control.py), with every flag and default. The loop:
aspect-bucket batching from a json manifest (threaded loader) ->
token-length batch tiling / frame crop -> VAE encode (no grad) -> text
encode -> train step -> EMA -> safetensors checkpoints with the sampler
cursor -> metric logs (JSONL, TensorBoard when it imports). The VAE encode
of batch N+1 is queued right after step N, and the first read of a step's
metrics (the logger) is its sync point, so the host prepares the next
batch while the card runs the step. With --lora_rank the trained factors
are exported as a kohya file, <output_dir>/lora_diffusion_pytorch_model
.safetensors. --tiny_demo trains tiny random models at 32 px, 5 frames.

Runs on the card unless main(device=...) asks for another device.
--distributed joins one process per GPU (parallel/multihost.py; torchrun's
environment or --coordinator_address / --num_processes / --process_id) on
the --mesh: each dp rank draws its own batches from the bucket sampler,
the sp ranks of a sample split its video tokens, and the optimizer state
is ZeRO-2 sharded over them (--fsdp: the parameters too, FSDP2); the first
data rank writes the checkpoints, logs and media, the others log under
<output_dir>/rank<r>. Not ported (ROADMAP queue 1 item 10): tp > 1, and
under --distributed: --lora_rank, CAME and 8-bit Adam,
--report_model_info.
"""
import argparse
import dataclasses
import os
import time
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .data import (AspectRatioBatchSampler, DataLoader,
                   ImageVideoControlDataset, ImageVideoDataset,
                   ResumableRandomSampler, to_device)
from .device import resolve_device
from .models.vae import (MagvitVAEConfig, gaussian_mode, gaussian_sample,
                         vae_encode)
from .parallel import (ZeroShards, create_mesh, fsdp_shard, init_distributed,
                       parse_mesh)
from .parallel.mesh import NOT_PORTED
from .pipeline.inpaint import add_noise_to_reference_video, resize_mask_to_latent
from .pipeline.t2v import build_rope
from .training.checkpoints import CheckpointManager
from .training.lora import LoRAConfig, make_lora_train_step
from .training.losses import FlowMatchLossConfig
from .training.trainer import (TrainConfig, create_train_state, draw_inputs,
                               make_param_grad_norms, make_train_step)
from .utils.observability import MetricLogger, StepTimer

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m easyanimate_tpu_torch.train",
        description="SFT / LoRA training of the EasyAnimate MMDiT")
    ap.add_argument("--fsdp", action="store_true",
                    help="data-shard the params too (FSDP2 per block, "
                         "ZeRO-3 layout); needs --distributed")
    ap.add_argument("--train_data_meta", required=True)
    ap.add_argument("--train_data_dir", default=None)
    ap.add_argument("--output_dir", default="runs/train")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--text_encoder_path", default=None,
                    help="override <model_path>/text_encoder")
    ap.add_argument("--config_path",
                    default="config/easyanimate_video_v5.1_magvit_qwen.yaml")
    ap.add_argument("--loss_type", default="flow",
                    choices=["flow", "ddpm", "sigma"])
    ap.add_argument("--learning_rate", type=float, default=2e-5)
    ap.add_argument("--weight_decay", type=float, default=3e-2)
    ap.add_argument("--max_grad_norm", type=float, default=0.05)
    ap.add_argument("--adaptive_grad_clip", action="store_true",
                    help="reference train.py:2116-2137 decaying clip")
    ap.add_argument("--initial_grad_norm_ratio", type=float, default=5.0)
    ap.add_argument("--abnormal_norm_clip_start", type=int, default=1000)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "came", "adamw8bit"])
    ap.add_argument("--motion_sub_loss", action="store_true",
                    help="temporal-delta sub-loss (ref train.py:2078-2082)")
    ap.add_argument("--report_model_info", action="store_true",
                    help="dump per-param grad norms on abnormal-norm steps "
                         "(ref train.py:2128-2137)")
    ap.add_argument("--abnormal_norm", type=float, default=2.0)
    ap.add_argument("--sanity_check", action="store_true", default=True,
                    help="dump the first batch as media (ref :1653-1670)")
    ap.add_argument("--no-sanity_check", dest="sanity_check",
                    action="store_false")
    ap.add_argument("--motion_sub_loss_ratio", type=float, default=0.25)
    ap.add_argument("--lr_scheduler", default="constant",
                    choices=["constant", "linear", "cosine"])
    ap.add_argument("--lr_warmup_steps", type=int, default=0)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=1)
    ap.add_argument("--trainable_modules", nargs="+", default=None)
    ap.add_argument("--trainable_modules_low_learning_rate", nargs="+",
                    dest="trainable_modules_low_lr", default=[])
    ap.add_argument("--train_batch_size", type=int, default=1)
    ap.add_argument("--video_sample_n_frames", type=int, default=49)
    ap.add_argument("--sample_height", type=int, default=384)
    ap.add_argument("--sample_width", type=int, default=672)
    ap.add_argument("--max_train_steps", type=int, default=100)
    ap.add_argument("--checkpointing_steps", type=int, default=500)
    ap.add_argument("--checkpoints_total_limit", type=int, default=3)
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--uniform_sampling_bands", type=int, default=0)
    ap.add_argument("--lora_rank", type=int, default=0,
                    help=">0 trains a LoRA instead of full SFT")
    ap.add_argument("--enable_inpaint", action="store_true")
    ap.add_argument("--train_mode", default="sft",
                    choices=["sft", "control", "control_camera_ref"],
                    help="control: condition on control videos; "
                         "control_camera_ref: Plucker camera conditioning "
                         "(train_control.py:1374-1387 parity)")
    # token-length batch shaping (reference train.py:1677-1768)
    ap.add_argument("--training_with_video_token_length", action="store_true",
                    help="tile small-token batches 2x/4x")
    ap.add_argument("--token_sample_size", type=int, default=512)
    ap.add_argument("--random_frame_crop", action="store_true")
    ap.add_argument("--keep_all_node_same_token_length", action="store_true")
    ap.add_argument("--validation_steps", type=int, default=0,
                    help=">0: render a validation sample every N steps "
                         "(log_validation parity)")
    ap.add_argument("--mesh", default="dp=-1,sp=1,tp=1",
                    help="ranks per axis: dp (-1: the rest), sp (video "
                         "tokens of a sample), tp (1: not ported)")
    ap.add_argument("--distributed", action="store_true",
                    help="one process per GPU (torchrun, or the three "
                         "flags below); ZeRO-2 over the mesh")
    ap.add_argument("--coordinator_address", default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--dataloader_num_workers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--resume_from_checkpoint", action="store_true")
    ap.add_argument("--tiny_demo", action="store_true",
                    help="tiny random models + 32px frames (CI smoke)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    mesh = parse_mesh(args.mesh)
    if mesh.tp != 1:
        raise NotImplementedError(f"--mesh {args.mesh}: tensor parallelism "
                                  f"(tp > 1) {NOT_PORTED}")
    if not args.distributed and (args.fsdp or mesh.dp > 1 or mesh.sp > 1):
        raise ValueError(f"--mesh {args.mesh}{' --fsdp' * args.fsdp} needs "
                         "--distributed (one process per GPU, e.g. torchrun)")
    if args.distributed:
        unported = [flag for flag, on in (
            ("--lora_rank", args.lora_rank > 0),
            ("--report_model_info", args.report_model_info),
            (f"--optimizer {args.optimizer}", args.optimizer != "adamw"))
            if on]
        if unported:
            raise NotImplementedError(f"{unported[0]} under --distributed "
                                      f"{NOT_PORTED}")
    if args.tiny_demo:
        args.sample_height = args.sample_width = 32
        args.video_sample_n_frames = 5
    return args


def main(argv=None, device=None):
    """Parse `argv` (sys.argv[1:] by default), load or build the models on
    `device` (the card by default) and train; returns train()'s result."""
    args = parse_args(argv)
    mesh = None
    if args.distributed:
        device = init_distributed(args.coordinator_address,
                                  args.num_processes, args.process_id,
                                  device=device)
        mesh = create_mesh(parse_mesh(args.mesh))
        print(f"rank {torch.distributed.get_rank()}/"
              f"{torch.distributed.get_world_size()} on {device}, {mesh}")
        if not mesh.contains_rank():
            print("outside the mesh: nothing to do")
            return None
    device = resolve_device(device)
    if args.tiny_demo:
        transformer, vae = _tiny_models(
            args.enable_inpaint, args.train_mode != "sft",
            enable_camera=args.train_mode == "control_camera_ref",
            device=device, seed=args.seed)
        text_dim = transformer.cfg.text_embed_dim
        encode_text = lambda texts: {"text": torch.zeros(
            (len(texts), 8, text_dim), device=device)}
    elif args.model_path:
        from .loader import load_pipeline, load_text_encoders

        pipe = load_pipeline(args.model_path,
                             "inpaint" if args.enable_inpaint else "t2v",
                             device=device)
        transformer, vae = pipe.transformer, pipe.vae
        encode_text = load_text_encoders(
            args.model_path, text_encoder_path=args.text_encoder_path,
            device=device)
    else:
        raise SystemExit("pass --model_path or --tiny_demo")
    return train(args, transformer, vae, encode_text, device, mesh)


@dataclasses.dataclass
class TrainResult:
    """What a train() call leaves: the final state and sampler cursor,
    each step's loss, and host seconds (each step from the end of the
    previous one's metric read to the end of its own; each checkpoint save;
    the restore)."""
    state: Any
    sampler_state: dict
    step0: int
    losses: List[float]
    step_s: List[float]
    save_s: List[float]
    load_s: Optional[float]
    lora_path: Optional[str]


class InpaintDraws(NamedTuple):
    """The random inputs of _inpaint_latents."""
    sigma: torch.Tensor  # [B] N(0, 1): the noise augmentation's sigma
    noise: torch.Tensor  # pixels' shape, N(0, 1): its noise
    flag: torch.Tensor   # [B] U[0, 1): the T2V zeroing


def draw_inpaint_inputs(generator, pixels: torch.Tensor) -> InpaintDraws:
    b = pixels.shape[0]
    dev = pixels.device
    return InpaintDraws(
        sigma=torch.randn(b, generator=generator, device=dev),
        noise=torch.randn(pixels.shape, generator=generator, device=dev),
        flag=torch.rand(b, generator=generator, device=dev))


def train(args, transformer, vae, encode_text: Callable, device=None,
          mesh=None) -> TrainResult:
    """The training loop on built models: `transformer` (the MMDiT),
    `vae` (MagViT), `encode_text(prompts) -> {"text": (B, S, D)}`, all on
    `device` (the card by default). With a mesh (parallel/mesh.py; every
    rank calls train with the same weights) the loop runs data- and
    sequence-parallel, as the module docstring says."""
    device = resolve_device(device)
    lead = mesh is None or mesh.rank("data") == 0
    dp_rank = 0 if mesh is None else mesh.rank("dp")
    # the first data rank writes the run's files; the others log apart
    out_dir = (args.output_dir if lead else
               os.path.join(args.output_dir, f"rank{mesh.rank('data')}"))
    enable_camera = args.train_mode == "control_camera_ref"
    kw = dict(video_sample_n_frames=args.video_sample_n_frames,
              height=args.sample_height, width=args.sample_width,
              seed=args.seed)
    if args.train_mode in ("control", "control_camera_ref"):
        dataset = ImageVideoControlDataset(
            args.train_data_meta, args.train_data_dir, enable_inpaint=False,
            enable_camera=enable_camera, **kw)
    else:
        dataset = ImageVideoDataset(args.train_data_meta, args.train_data_dir,
                                    enable_inpaint=args.enable_inpaint, **kw)
    sampler = ResumableRandomSampler(len(dataset), seed=args.seed)
    # every rank iterates the same permutation; each dp rank takes its own
    # batches, the sp peers of a dp rank the same ones
    batch_sampler = AspectRatioBatchSampler(
        sampler=sampler, batch_size=args.train_batch_size,
        sample_info=dataset.sample_info(), shard_rank=dp_rank,
        shard_count=1 if mesh is None else mesh.shape["dp"])

    tcfg = TrainConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        adaptive_grad_clip=args.adaptive_grad_clip,
        initial_grad_norm_ratio=args.initial_grad_norm_ratio,
        abnormal_norm_clip_start=args.abnormal_norm_clip_start,
        optimizer=args.optimizer, lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        trainable_modules=args.trainable_modules,
        trainable_modules_low_lr=tuple(args.trainable_modules_low_lr),
        use_ema=args.use_ema, loss_type=args.loss_type,
        motion_sub_loss=args.motion_sub_loss,
        motion_sub_loss_ratio=args.motion_sub_loss_ratio,
        loss=FlowMatchLossConfig(uniform_bands=args.uniform_sampling_bands))
    lora = args.lora_rank > 0
    if lora and mesh is not None:
        raise NotImplementedError(f"--lora_rank under a mesh {NOT_PORTED}")
    if lora:
        # the LoRA step trains the flow loss whatever --loss_type says, as
        # JAX's make_lora_train_step does
        lcfg = LoRAConfig(rank=args.lora_rank)
        init_fn, step_fn = make_lora_train_step(transformer, tcfg, lcfg)
        state = init_fn(torch.Generator(device=device).manual_seed(args.seed))
        draw_cfg = dataclasses.replace(tcfg, loss_type="flow")
    else:
        if args.fsdp:
            fsdp_shard(transformer, mesh)
        state = create_train_state(transformer, tcfg, mesh)
        step_fn = make_train_step(transformer, tcfg, mesh)
        draw_cfg = tcfg
    # under a mesh the first data rank writes the checkpoints
    shards = (None if mesh is None else
              ZeroShards(dict(transformer.named_parameters()), mesh))

    ckpts = CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                              max_to_keep=args.checkpoints_total_limit,
                              shards=shards)
    load_s = None
    if args.resume_from_checkpoint:
        t0 = time.perf_counter()
        restored, sampler_state, step = ckpts.restore_latest(state)
        if restored is not None:
            del state
            state = restored
            sampler.load_state_dict(sampler_state)
            _adopt_state(state, transformer, lora, shards)
            load_s = time.perf_counter() - t0
            print(f"resumed from step {step}")
    # the loader starts its producer thread on iter(): built AFTER the
    # resume restores the sampler cursor, or the prefetched batches replay
    # epoch 0
    loader = iter(DataLoader(dataset, batch_sampler,
                             num_workers=args.dataloader_num_workers))
    logger = MetricLogger(out_dir)
    timer = StepTimer()
    # dp ranks draw apart; the sp peers of a sample draw alike
    gen = torch.Generator(device=device).manual_seed(args.seed + dp_rank)
    shape_rng = np.random.RandomState(args.seed)
    scale = vae.cfg.scaling_factor
    vdtype = vae.cfg.torch_dtype

    @torch.no_grad()
    def encode(px, sample: bool):
        moments = vae_encode(vae, px.to(vdtype))
        z = gaussian_sample(moments, gen) if sample else gaussian_mode(moments)
        return z.float() * scale

    def prepare_batch(loaded):
        """host batch -> device train batch (the encodes queued, not waited
        for)."""
        loaded = _shape_batch(args, loaded, vae.cfg, shape_rng)
        host = {k: np.asarray(loaded[k], np.float32)
                for k in ("pixel_values", "control_pixel_values", "mask",
                          "control_camera_values") if k in loaded}
        # the sampler gave this dp rank its own rows
        dev = to_device(host, device)
        pixels = dev["pixel_values"] * 2.0 - 1.0  # [-1, 1] for the VAE
        latents = encode(pixels, sample=True)
        embeds = encode_text(loaded["text"])
        batch = {"latents": latents, "text": embeds["text"]}
        if embeds.get("text_t5") is not None:
            batch["text_t5"] = embeds["text_t5"]
        if args.enable_inpaint:
            batch["inpaint_latents"] = _inpaint_latents(
                lambda x: encode(x, sample=False), dev["mask"], pixels,
                latents, scale, transformer.cfg,
                draw_inpaint_inputs(gen, pixels))
        if args.train_mode == "control":
            ctl = encode(dev["control_pixel_values"] * 2.0 - 1.0, sample=False)
            # per-sample 20% zero-dropout so the model learns the
            # unconditional branch (reference train_control.py:1787-1794)
            keep = (torch.rand((ctl.shape[0], 1, 1, 1, 1), generator=gen,
                               device=device) >= 0.2).to(ctl.dtype)
            batch["control_latents"] = (ctl * keep).to(latents.dtype)
        elif enable_camera:
            cam = dev.get("control_camera_values")
            if cam is None:
                # whole-manifest fallback (the dataset already emits zeros
                # per sample when an entry lacks its pose file, reference
                # train_control.py:1375-1385)
                pix = dev["pixel_values"]
                cam = pix.new_zeros((pix.shape[0], 6, *pix.shape[2:]))
            batch["control_latents"] = _camera_latents(
                cam, latents, transformer.cfg,
                torch.rand(latents.shape[0], generator=gen, device=device))
        batch["rope"] = build_rope(
            transformer.cfg, args.sample_height, args.sample_width,
            latents.shape[2], vae_scale=vae.cfg.spatial_compression,
            device=device)
        return loaded, batch

    step0 = int(state.step)
    losses, step_s, save_s = [], [], []
    try:
        if step0 < args.max_train_steps:
            # guarded so a resume of a finished run does not pull (and move
            # the sampler cursor past) a batch that is never trained
            shaped, pending = prepare_batch(next(loader))
            if args.sanity_check and lead:
                _sanity_dump(args, shaped)
        t_last = time.perf_counter()
        for step in range(step0, args.max_train_steps):
            batch = pending
            draws = draw_inputs(gen, batch["latents"], draw_cfg)
            # the PRE-update masters, for the abnormal step's own diagnosis
            prev = ({n: p.clone() for n, p in state.params.items()}
                    if args.report_model_info and not lora else None)
            state, metrics = step_fn(state, batch, draws=draws)
            # lookahead: pull + encode the NEXT batch while the card runs
            # this step; the logger's read below is the first sync point
            if step + 1 < args.max_train_steps:
                _, pending = prepare_batch(next(loader))
            metrics.update(timer.tick())
            logged = logger.log(step, metrics)
            now = time.perf_counter()
            step_s.append(now - t_last)
            t_last = now
            losses.append(logged["loss"])
            if args.report_model_info and logged["grad_norm"] > args.abnormal_norm:
                _report_param_grad_norms(logger, step, prev, batch, draws,
                                         transformer, tcfg, state)
            del prev
            if step % 10 == 0:
                print(f"step {step}: loss={logged['loss']:.4f} "
                      f"gnorm={logged['grad_norm']:.3f}")
            if (step + 1) % args.checkpointing_steps == 0:
                save_s.append(_timed_save(ckpts, step + 1, state, sampler))
            if args.validation_steps and (step + 1) % args.validation_steps == 0:
                _log_validation(args, transformer, vae, state, encode_text,
                                step + 1, device, out_dir)
            t_last = time.perf_counter()
    finally:
        loader.close()
        logger.close()
    save_s.append(_timed_save(ckpts, args.max_train_steps, state, sampler))
    lora_path = None
    if lora:
        # reference train_lora.py:1552/2154: the trained network as a kohya
        # safetensors file (predict scripts, webui and ComfyUI merge it)
        from .models.convert import save_lora_reference

        lora_path = os.path.join(args.output_dir,
                                 "lora_diffusion_pytorch_model.safetensors")
        save_lora_reference(lora_path, state.params, lcfg.alpha)
        print("exported reference-format LoRA to", lora_path)
    print("done; checkpoints in", ckpts.directory)
    return TrainResult(state, sampler.state_dict(), step0, losses, step_s,
                       save_s, load_s, lora_path)


def _timed_save(ckpts, step, state, sampler) -> float:
    t0 = time.perf_counter()
    ckpts.save(step, state, sampler.state_dict())
    return time.perf_counter() - t0


@torch.no_grad()
def _adopt_state(state, transformer, lora: bool, shards=None) -> None:
    """A restored state takes over: LoRA factors train again; SFT masters
    are copied into the model's parameters (the step keeps the two equal;
    under a mesh, the chunks gathered: ZeroShards.write_params)."""
    if lora:
        for fac in state.params.values():
            for t in fac.values():
                t.requires_grad_(True)
        return
    named = dict(transformer.named_parameters())
    if shards is not None:
        shards.write_params(named, state.params)
        return
    for n, p in named.items():
        p.copy_(state.params[n])


def _shape_batch(args, loaded, vae_cfg, rng):
    """Token-length batch shaping (reference train.py:1677-1768): tile
    small batches, randomly crop frames, equalize token lengths. Frame
    counts follow the VAE's chunk mode (mini_batch_encoder * k + 1 for
    cache_mag)."""
    pixels = loaded["pixel_values"]  # (B, C, T, H, W) float in [0,1]
    b, c, t, h, w = pixels.shape
    interval = getattr(vae_cfg, "mini_batch_encoder", 4)
    cache_mag = getattr(vae_cfg, "chunk_mode", "cache_mag") == "cache_mag"

    tile_keys = [k for k in ("pixel_values", "control_pixel_values",
                             "control_camera_values", "mask_pixel_values",
                             "mask") if k in loaded]

    if args.training_with_video_token_length:
        target = args.video_sample_n_frames * args.token_sample_size ** 2
        actual = t * h * w
        reps = 4 if target // 16 >= actual else (
            2 if target // 4 >= actual else 1)
        if reps > 1:
            for k in tile_keys:
                loaded[k] = np.tile(loaded[k],
                                    (reps,) + (1,) * (loaded[k].ndim - 1))
            loaded["text"] = list(loaded["text"]) * reps

    if args.random_frame_crop and t > 1:
        lo = interval + 1 if cache_mag else interval
        options = list(range(lo, args.video_sample_n_frames + interval,
                             interval))
        probs = ([0.1 / max(len(options) - 1, 1)] * (len(options) - 1)
                 + [0.9]) if len(options) > 1 else [1.0]
        n = int(rng.choice(options, p=np.array(probs) / np.sum(probs)))
        n = min(n, t)
        for k in tile_keys:
            if loaded[k].ndim >= 3 and loaded[k].shape[2] == t:
                loaded[k] = loaded[k][:, :, :n]

    if args.keep_all_node_same_token_length and t > 1:
        sizes = list(range(256, max(args.token_sample_size, 256) + 1, 128))
        if sizes[-1] != args.token_sample_size and args.token_sample_size > 256:
            sizes.append(args.token_sample_size)
        tok = int(rng.choice(sizes)) ** 2 * args.video_sample_n_frames
        tcur = loaded["pixel_values"].shape[2]
        n = min(tok / (h * w), args.video_sample_n_frames)
        n = (int(n) - 1) // interval * interval + 1 if cache_mag \
            else int(n) // interval * interval
        n = max(min(n, tcur), 1)
        for k in tile_keys:
            if loaded[k].ndim >= 3 and loaded[k].shape[2] == tcur:
                loaded[k] = loaded[k][:, :, :n]
    return loaded


def _camera_latents(cam: torch.Tensor, latents: torch.Tensor, cfg,
                    keep_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plucker camera video -> control latent channels: the 6-channel
    embedding resized to the latent grid (x 6), as pipeline/control.py and
    the reference's train_control.py camera path condition on it.

    Ref branch (train_control.py:1801-1815): the FIRST-FRAME latent goes
    into frame 0 of the ref channels, zeroed where keep_u (U[0, 1) [B]) is
    below 0.2; keep_u None keeps every one."""
    ctl = resize_mask_to_latent(cam.float(), latents.shape,
                                first_frame_special=True) * 6.0
    if cfg.add_ref_latent_in_control_model:
        first = latents[:, :, :1].float()
        if keep_u is not None:
            first = first * (keep_u >= 0.2).float().view(-1, 1, 1, 1, 1)
        ref = torch.zeros(latents.shape, device=latents.device)
        ref[:, :, :1] = first
        ctl = torch.cat([ctl, ref], dim=1)
    return ctl.to(latents.dtype)


def _inpaint_latents(encode_mode: Callable, masks: torch.Tensor,
                     pixels: torch.Tensor, latents: torch.Tensor,
                     scale: float, cfg,
                     draws: Optional[InpaintDraws] = None) -> torch.Tensor:
    """Mask + masked-video latents. The regenerate region is filled with
    -1 (reference train.py:1422, pipeline_..._inpaint.py:1346), noise-
    augmented with `draws` as the reference trainer does (train.py:1842),
    encoded (mode, scaled by encode_mode) beside the mask resized to the
    latent grid; with draws, fully-masked samples (pure T2V) have their
    inpaint latents zeroed where draws.flag < 0.9 (train.py:1770-1779,
    applied at :1850). draws None: neither augmentation nor zeroing."""
    keep = (masks < 0.5).to(pixels.dtype)
    masked = pixels * keep - (1.0 - keep)
    if draws is not None and getattr(cfg, "add_noise_in_inpaint_model", False):
        masked = add_noise_to_reference_video(
            masked, draws=(draws.sigma, draws.noise))
    masked_lat = encode_mode(masked)
    mask_lat = resize_mask_to_latent(1.0 - masks, latents.shape,
                                     first_frame_special=True) * scale
    inpaint = torch.cat([mask_lat, masked_lat.to(mask_lat.dtype)], dim=1)
    if draws is not None:
        fully = (masks >= 0.5).flatten(1).all(dim=1)
        zero = fully & (draws.flag < 0.9)
        inpaint = inpaint * torch.where(zero, 0.0, 1.0).view(-1, 1, 1, 1, 1)
    return inpaint.to(latents.dtype)


def _sanity_dump(args, loaded):
    """First-batch media dump (reference train.py:1653-1670): pixel values
    as GIFs plus inpaint masks, under output_dir/sanity_check/."""
    d = os.path.join(args.output_dir, "sanity_check")
    os.makedirs(d, exist_ok=True)
    try:
        from .utils.media import save_videos_grid

        pix = np.asarray(loaded["pixel_values"])  # (B, C, T, H, W) in [0, 1]
        for i in range(min(pix.shape[0], 4)):
            save_videos_grid(pix[i:i + 1], os.path.join(d, f"batch_{i}.gif"),
                             fps=8)
        if "mask" in loaded:
            m = np.asarray(loaded["mask"])
            for i in range(min(m.shape[0], 4)):
                save_videos_grid(np.repeat(m[i:i + 1], 3, axis=1),
                                 os.path.join(d, f"mask_{i}.gif"), fps=8)
        print(f"sanity check media written to {d}")
    except Exception as e:  # best-effort: never kill the run over a dump
        print(f"sanity check dump skipped: {type(e).__name__}: {e}")


def _report_param_grad_norms(logger, step, prev_params, batch, draws,
                             transformer, tcfg, state):
    """Abnormal-step per-parameter grad norms -> metric log (reference
    report_model_info, train.py:2128-2137), at the step's PRE-update
    parameters and its own draws; the model then takes the current
    masters back."""
    if prev_params is None:
        print(f"step {step}: abnormal grad norm (per-param report "
              "unavailable for LoRA states)")
        return
    named = dict(transformer.named_parameters())
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(prev_params[n])
    norms = make_param_grad_norms(transformer, tcfg)(batch, draws)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(state.params[n])
    top = sorted(((k, float(v)) for k, v in norms.items()),
                 key=lambda kv: -kv[1])[:20]
    logger.log(step, {f"grad_norm/{k}": v for k, v in top})
    print(f"step {step}: abnormal grad norm; top offenders: "
          + ", ".join(f"{k}={v:.3f}" for k, v in top[:3]))


def _log_validation(args, transformer, vae, state, encode_text, step, device,
                    out_dir):
    """Render a sample with the current weights (train.py:246-384 parity)
    into `out_dir`; LoRA states are skipped (the predict scripts merge
    them). Under a mesh every rank renders (FSDP's forward needs them all),
    unsharded."""
    if not isinstance(next(iter(state.params.values())), torch.Tensor):
        return
    from .pipeline import (EasyAnimateControlPipeline,
                           EasyAnimateInpaintPipeline, EasyAnimatePipeline)
    from .utils.media import save_videos_grid

    if args.train_mode in ("control", "control_camera_ref"):
        cls = EasyAnimateControlPipeline
    elif args.enable_inpaint:
        cls = EasyAnimateInpaintPipeline
    else:
        cls = EasyAnimatePipeline
    pipe = cls(transformer, vae, device)
    pos = encode_text(["validation sample"])["text"]
    video = pipe(pos, torch.zeros_like(pos), height=args.sample_height,
                 width=args.sample_width,
                 video_length=args.video_sample_n_frames,
                 num_inference_steps=4, guidance_scale=3.0,
                 generator=torch.Generator(device=device).manual_seed(step))
    out = os.path.join(out_dir, f"validation_{step}.gif")
    save_videos_grid(np.asarray(video), out, fps=8)
    print("validation sample ->", out)


# the tiny MagViT of the JAX drivers' --tiny_demo (examples/train.py,
# train_reward_lora.py, train_vae.py)
TINY_VAE = MagvitVAEConfig(
    latent_channels=4, block_out_channels=(8, 16),
    down_block_types=("SpatialTemporalDownBlock3D", "SpatialDownBlock3D"),
    up_block_types=("SpatialTemporalUpBlock3D", "SpatialUpBlock3D"),
    layers_per_block=1, norm_num_groups=4, mini_batch_encoder=2,
    mini_batch_decoder=1, scaling_factor=0.5)


def _tiny_models(enable_inpaint, enable_control=False, enable_camera=False,
                 device=None, seed: int = 0):
    """The tiny MMDiT preset and a tiny MagViT (examples/train.py:630-660),
    float32, random weights from `seed`."""
    from .models.convert import init_random_
    from .models.mmdit import PRESETS, EasyAnimateTransformer3D
    from .models.vae import AutoencoderKLMagvit

    device = resolve_device(device)
    ctl_ch = 6 if enable_camera else 4  # camera control = 6ch Plucker video
    in_ch = 4
    if enable_inpaint:
        in_ch = 9
    elif enable_control:
        in_ch = 4 + ctl_ch
    mmdit_cfg = dataclasses.replace(PRESETS["tiny"], in_channels=in_ch,
                                    out_channels=4)
    gen = torch.Generator(device=device).manual_seed(seed)
    transformer = init_random_(EasyAnimateTransformer3D(mmdit_cfg,
                                                        device=device), gen)
    vae = init_random_(AutoencoderKLMagvit(TINY_VAE, device=device), gen)
    return transformer, vae


if __name__ == "__main__":
    main()
