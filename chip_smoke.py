"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--seed S]

Phases, each printing one JSON line; any failure ends the run non-zero:
  device     card name, nvidia-smi name and power limit; TF32 off
  build      the CUDA kernels built from easyanimate_tpu_torch/csrc; ptxas's
             registers and spills and the SASS opcodes (HGMMA, UTMALDG) of
             the TMA + wgmma kernels (K1 at d 64, 88 and 72 and its
             short-head kernel at d 72 and 144, K2, K5, K3's and K6's dq
             and K4's and K7's dk/dv kernels), and of K1's mma.sync body at
             d 72 and 144
  kernels    K1 (dense flash forward), K2 (sliding-window forward) and K5
             (fused sliding-window + global forward) against their plain
             PyTorch versions at the flagship shapes (K1 also at the
             serve phase's one-CFG-half and 45-frame-window shapes and at
             the V5 12B's joint length, 77 + 256 + 13,104 = 13,437), with
             kernel / plain / library (yardstick only) times and each
             kernel's bound; then K1 at head dim 88 (K1@88, its TMA +
             wgmma kernel) at V4's three shapes: self attention [32,
             36,864, 88], the text cross pass (kv 333) and the CLIP pass
             (kv 16), and on 12 ragged heads; then K1 at head dims 72
             (K1@72: its persistent TMA + wgmma walk past 64 q rows, the
             short-head kernel below) and 144 (K1@144, the short-head
             kernel) at the V1-V3
             shapes: V3's Global_Self [32, 36,864, 72], the spatial [1,152,
             1,024, 72], text (kv 120) and temporal [32,768, 36, 72]
             passes, V2's temporal [16,384, 36, 144] and V1's grid [4,096,
             64, 144]; at b*h 73,728 (V3's temporal pass at 768 x 768, past
             gridDim.y's 65,535) and on 12 ragged heads
  kernels_bwd  K3+K4 (dense backward) and K6+K7 (sliding-window backward)
             against their plain versions at the training step's shapes,
             with SDPA's backward at the dense and cross shapes (yardsticks)
  quant_kernels  Q1 (activation quantize), Q2 (int32 dequantize) and Q3
             (int4 unpack / W4A8 regrid) of csrc/quant.cu against their
             plain versions at the 12B's shapes (26,208 tokens; widths
             3,072 and 12,288): Q1's and Q3's int8 outputs bit for bit,
             the bf16 outputs within 1 ulp; kernel / plain times and bounds;
             the whole quantized linear in each mode (int8, w4a8, int4) at
             the three block-linear widths held to JAX's cosine guards and
             timed beside F.linear in bf16 (a yardstick only)
  reference  a tiny T2V, a tiny I2V, a tiny V5 run (the tiny Bert and
             mT5 towers' two streams into a tiny dual-stream MMDiT, DDIM)
             and a tiny V4 run (the same streams into a 2 x 88-head,
             4-layer HunyuanDiT, DDIM, the slice_mag MagViT decoding
             untiled with smooth_output) and a tiny V1-V3 run (a 2 x
             72-head Transformer3D with motion modules of 1 x 144 and 2 x
             72 heads, DDIM, 128 x 128 x 5f) on the card (bf16, kernels)
             against the same weights on the CPU (float32, plain
             versions); V5, V4 and V1-V3 also against the CPU's bf16
             floor
  train_reference  a tiny LoRA step and a tiny SFT step, the same way;
             then a tiny LCM step, a tiny reward step (a tiny CLIP scorer)
             and a tiny MagViT ae_step and disc_step (float32 on both,
             each from the initial weights), each within its
             TRAIN_REFERENCE_BOUNDS (loss; gradients' relative L2 error)
  loader     a reference-layout V5.1 directory written by the port's own
             safetensors writer into a temporary directory (transformer
             at the 12B widths cut to 2 layers, layer 1 SWA, in 256 MB
             shards; the full MagViT; a FlowMatch scheduler), loaded with
             load_pipeline on the card: every tensor equal to the written
             one; a 2-step request on the loaded and on the in-memory
             modules (equal), then an fp8_weights load and its request,
             then an int8_linears and an int4_weights load, each with a
             2-step latent request (Q1-Q3 counted); directory bytes, write
             and load seconds, each quantized load's peak
  build_12b  V5.1-12B (random bf16 weights, full depth and width) + the
             full MagViT VAE, built on meta and filled on the card
  text       the full Qwen2-VL-7B text tower (27 of 28 layers, bf16,
             random weights) encodes a CFG pair of 256 right-padded token
             ids; text_encode_s, parameters, peak memory; then freed
  dense      two requests to that 12B at 384x672x49f, CFG 6.0, the second
             on the text phase's embeddings
  swa        one request with swa_layers = 1..47 on the same weights
  i2v        one image-to-video request to V5.1-12B-InP (the same weights,
             a random 33-channel proj): VAE encode of the start frame,
             denoise, decode
  control    (NEW_PHASE_STEPS steps) V5.1-12B-Control on the same
             tensors (a random 48-channel proj and ref_proj): a random
             control clip + reference image request (each VAE encode timed
             apart); the identity check (the
             12B's proj on the first 16 channels, zeros on the 32 control
             + reference channels, 2 latent-only steps against the T2V
             pipeline within CONTROL_IDENTITY_BOUND); Control-Camera on
             the swa_layers = 1..47 variant (38-channel proj, no reference
             image) on a 49-pose trajectory written here and read back
             through plucker_from_file (its host seconds)
  samplers   Flow, DDIM, Euler, Euler A, DPM++ (NEW_PHASE_STEPS steps)
             and PNDM (4 steps, 5 evaluations: every PLMS order) through
             make_scheduler on the dense 12B, latent output from the same
             noise: s/step each, K1 48 per transformer evaluation, finite
             latents, Euler against DDIM within EULER_DDIM_BOUND or twice
             the bf16 floor (DDIM against DDIM from the noise x (1 + 2^-8))
  quant      (NEW_PHASE_STEPS steps, latent output) a bf16 request on the
             dense 12B, then the same request as int8 (W8A8), w4a8 and int4
             (W4A16), each quantized from the resident bf16 weights and
             freed after: s/step, peak memory, the transformer's resident
             bytes, Q1-Q3 and K1 launches, the latents' cosine to bf16;
             then a rank-128 LoRA file merged into the int8 model and
             unmerged through the controller (back within one int8 step)
  serve      requests in the JAX server's JSON protocol through
             api.server.request_kwargs and EasyAnimateController.generate
             on that 12B, the full Qwen2-VL tower (random weights, a
             word-level stand-in tokenizer) encoding every prompt:
             TeaCache 0.1 with the 4:2:0 fetch (K1 = 48 x computed steps),
             TeaCache 1e9 (2 computed steps), cfg_skip_ratio 0.25,
             cfg_split against batched CFG (latents within
             CFG_SPLIT_BOUND), sampler_dropdown Euler and then a request
             without it (FlowMatch again: the batched request's latents),
             the overlapped chunk decode against the
             untiled one (within 1 in uint8; the untiled one's host fetch
             timed apart), and a 90-frame long video in two windows on
             the inpaint variant (each window's host copy timed where it
             starts and where it is waited for, against a synchronous
             fetch), a V2V request with Euler at strength 0.7 (the
             sigma-space init); the mp4 encode is left to the CPU tests (no
             imageio or cv2 here)
  swa_fused  swa_attention_streams at the 12B's per-layer shapes, forward
             and backward, with fuse_cross=True (K5) against False
  lora_dense 3 LoRA steps (rank 128) on the same 12B at 384x672x49f
  lora_swa   3 LoRA steps on its swa_layers = 1..47 variant
  v5_text    V5's prompt towers at their published widths, float32
             (random weights): the Bert (hidden 1024, 24 layers) on a CFG
             pair of 77 token ids and the mT5-XL encoder (d_model 2048, 24
             blocks) on 256; ms per tower for the pair, peak; then freed
  v5         the V5 12B (the V5 yaml's fields over the 12B's widths: the
             Bert and mT5 streams through their RMS-normed projections,
             after_norm; the 12B's tensors shared, V5's own ones random)
             on those embeddings, 384x672x49f, CFG 6.0, DDIM: K1 48 per
             CFG evaluation at the joint length 13,437; then after_norm's
             float32 LayerNorms timed alone at the request's shapes
  lora_v5    LORA_V5_STEPS LoRA steps (rank 128) on that V5 12B with a
             batch carrying text_t5: K1 96, K3 48, K4 48 a step
  train_driver  the training driver's loop (easyanimate_tpu_torch.train)
             on the dense 12B and the full MagViT: a manifest of 2 videos
             and 2 images (file reads patched: seeded frames at the size),
             prompts through the full Qwen2-VL tower (stand-in tokenizer),
             LoRA rank 128, batch 1; 2 steps with a checkpoint at step 2,
             then a resume that must restore the saved state and sampler
             cursor bit for bit, and step 3; the kohya export read back;
             VAE-encode, step, checkpoint save / load seconds, peak
  lcm        LCM-LoRA distillation (training/lcm.py) on the dense 12B:
             LoRA rank 64, 2 steps at 384x672x49f: s/step, peak, K1 240,
             K3 48, K4 48 a step, the base weights unchanged, the LoRA
             moved, the EMA equal to d * e + (1 - d) * p bit for bit
  reward     reward backprop (training/reward.py) on the dense 12B and
             the MagViT: rank 32, 4 FlowMatch steps (the driver's 50 cut
             to 4), 'tail' with 2 selected, one decoded latent frame, a
             CLIP-H/14 scorer at its published widths (random weights,
             stand-in token ids); one step with DRTune off, one on: s/step,
             peak, K1 288, K3 96, K4 96 a step, a non-zero LoRA gradient;
             then MPSReward (CLIP-H + the cross model) and AestheticReward
             (CLIP-L/14 + the head) alone on the decoded frames, forward
             and backward to the frames: ms, finite
  sft        SFT at the 12B widths, 4 layers (0 dense, 1-3 SWA), float32
             masters: 3 steps each of AdamW, CAME and 8-bit AdamW, then
             1 'ddpm' step; s/step, peak and optimizer-state bytes each
  parallel   the multi-GPU path at world size 1: init_distributed joins a
             1-rank NCCL group (a file store in a temporary directory),
             create_mesh builds the (1, 1, 1) mesh; the ring's hop code
             (parallel/context.py) over V5.1's joint attention [96,
             13,360, 64] cut into sp = 2 and 4 shards in one process (K1
             per hop and the float32 merge, K3 + K4 per hop from the
             global o and lse) against one K1 and one K3 + K4 call (o,
             lse, dq, dk, dv within the kernels' bounds; ms per hop and
             merge); the Ulysses pass's per-rank body on heads [12r,
             12r + 12) of the 12B's SWA layer against the 48-head call;
             the driver's loop (train.train, the driver's parser) on the
             sft phase's model, 2 steps each plain, --distributed
             (ZeRO-2) and --distributed --fsdp (FSDP2), held against the
             plain run's losses and masters; s/step and peak of each
  vae_train  the full V5.1 MagViT's GAN training (training/vae_trainer.py;
             float32, Discriminator3D, LPIPS on VGG16, random weights) on
             a random 256x256x17 clip, batch 1: 3 ae_step + disc_step
             pairs with disc_start 1: s per step, peak
  v4_t2v, v4_i2v  V4 (EasyAnimateV4) at full width and depth: the
             HunyuanDiT (40 layers, 16 x 88 heads, the V4 yaml's basic
             blocks and time_position_encoding; random bf16 weights) and
             the yaml's slice_mag MagViT with latent_channels 4, at
             512x512x144f (36,864 tokens), DDIM, CFG 6.0, NEW_PHASE_STEPS
             steps on random Bert [2, 77, 1024] and mT5 [2, 256, 2048]
             embeddings: a T2V request (decode tiled, so not smoothed)
             and an I2V one on the -InP variant (12 channels in, 8 out;
             the start frame and its mask VAE-encoded, random CLIP states
             [1, 256, 1024], the gate shut at step 0 and open at step 1):
             s/step, encode and decode s, peak; K1 80 (T2V) and 120
             (I2V) launches per CFG evaluation, all on its d 88 kernel
  v3_t2v, v2_t2v, v1_t2v, pixart  V1-V3 (EasyAnimateV1-V3) and PixArt at
             full width and depth: the Transformer3D (28 layers, 16 x 72
             heads, caption width 4,096; random bf16 weights) from each
             yaml's fields through utils/config.py (LEGACY_YAML: V3's
             global motion modules at 16 heads, V2's at 8, V1's
             VanillaGrid at 8 over 2 x 2 cells), DDIM, CFG 6.0,
             NEW_PHASE_STEPS steps on random T5 embeddings [2, 120, 4096]
             (the T5-XXL tower cut): V3 and V2 at 512x512x144f through
             their slice_mag MagViT (mini_batch 8 / 2 and 9 / 3,
             latent_channels 4; decoded tiled), V1 at 512x512x16f (the
             smoke's frame count) through its 2D VAE, PixArt
             (Transformer2D over V3's fields) one 512x512 image through
             V3's MagViT in the cache_mag protocol (slice_mag maps one
             frame to 0 latents, in JAX too): s/step, decode s, peak; K1
             per CFG evaluation by head dim (LEGACY_K1): V3 112 at d 72
             (42 of them, the temporal passes over 36 frames, on the
             short-head kernel flash_fwd_short_sm90, the rest on
             flash_fwd_d72_sm90's persistent walk), V2 and V1 56 at d 72
             and 56 at d 144 (all of the latter on the short-head
             kernel), PixArt 56 at d 72
Each main-path phase sets the kernels' launch counts to 0 just before it
and checks them just after, and that every launch of K1-K7 (at d 64, and
K1's at d 88 in V4's, at d 72 and 144 in V1-V3's) ran its TMA + wgmma
kernel, V1-V3's temporal and grid passes the short-head one; Q1-Q3
launch on the quantized paths only. Then the per-kernel JSON line (K1@88,
K1@72 and K1@144 their own rows) and, last, the device line.
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from easyanimate_tpu_torch.api.server import request_kwargs, video_rgb
from easyanimate_tpu_torch.data.camera import plucker_from_file
from easyanimate_tpu_torch.loader import load_pipeline
from easyanimate_tpu_torch.models.convert import (init_random_,
                                                  mmdit_config_json,
                                                  save_reference_checkpoint)
from easyanimate_tpu_torch.models.hunyuan import (HunyuanConfig,
                                                  HunyuanTransformer3D)
from easyanimate_tpu_torch.models.mmdit import PRESETS, EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.transformer3d_legacy import (
    MotionModuleConfig, Transformer2D, Transformer3D, Transformer3DConfig)
from easyanimate_tpu_torch.models.text import (TINY_BERT, TINY_T5, BertConfig,
                                               BertModel, BertTextEncoder,
                                               MT5EncoderModel, MT5TextEncoder,
                                               Qwen2Config, Qwen2TextEncoder,
                                               QwenVLTextEncoder, T5Config)
from easyanimate_tpu_torch.models.vae import (AutoencoderKLMagvit,
                                              MagvitVAEConfig, vae_decode,
                                              vae_encode)
from easyanimate_tpu_torch.ops import _build
from easyanimate_tpu_torch.ops import quant as tquant
from easyanimate_tpu_torch.ops.norms import fp32_layer_norm
from easyanimate_tpu_torch.ops.flash_attention import (
    LOG2E, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_plain, row_dot)
from easyanimate_tpu_torch.ops.swa import (
    sliding_window_bwd, sliding_window_bwd_plain, sliding_window_fwd,
    sliding_window_plain, swa_attention_streams, swa_local_global_fwd,
    swa_local_global_plain, swa_streams_heads)
from easyanimate_tpu_torch.parallel import (MeshConfig, create_mesh,
                                            init_distributed)
from easyanimate_tpu_torch.parallel.context import (ring_bwd_hop,
                                                    ring_fwd_hop, ring_merge)
from easyanimate_tpu_torch.pipeline import (EasyAnimateControlPipeline,
                                            EasyAnimateInpaintPipeline,
                                            EasyAnimatePipeline,
                                            PixArtMagvitPipeline,
                                            make_scheduler)
from easyanimate_tpu_torch.pipeline import control as control_module
from easyanimate_tpu_torch.pipeline.schedulers import DDIMConfig
from easyanimate_tpu_torch.pipeline.t2v import build_rope
from easyanimate_tpu_torch import train as train_module
from easyanimate_tpu_torch.data import dataset as dataset_module
from easyanimate_tpu_torch.models.convert import (load_lora_reference,
                                                  save_lora_reference)
from easyanimate_tpu_torch.reward import clip as tclip
from easyanimate_tpu_torch.reward.mps import MPSCrossModel, MPSReward
from easyanimate_tpu_torch.reward.reward_fn import (AestheticReward,
                                                    CLIPScoreReward,
                                                    convert_aesthetic_head)
from easyanimate_tpu_torch.training import lcm as tlcm
from easyanimate_tpu_torch.training import lora as tlora
from easyanimate_tpu_torch.training import optim as toptim
from easyanimate_tpu_torch.training import reward as treward
from easyanimate_tpu_torch.training import trainer as ttrainer
from easyanimate_tpu_torch.training import vae_trainer as tvt
from easyanimate_tpu_torch.training.vae_losses import (LPIPS, Discriminator3D,
                                                       VAELossConfig)
from easyanimate_tpu_torch.training.checkpoints import (CheckpointManager,
                                                        flatten_state)
from easyanimate_tpu_torch.ui import controller as controller_module
from easyanimate_tpu_torch.ui.controller import EasyAnimateController
from easyanimate_tpu_torch.utils import config as tconfig
from easyanimate_tpu_torch.utils.fp8 import fp8_byte_share
from easyanimate_tpu_torch.utils.media import (YUV420Video,
                                               get_image_to_video_latent,
                                               get_video_to_video_latent)
from easyanimate_tpu_torch.utils.transfer import HostCopy

H, W, FRAMES, TEXT_LEN = 384, 672, 49, 256
# V5's prompt towers at their published widths (HunyuanDiT's Bert, mT5-XL's
# encoder) and the Bert stream's length (BertTextEncoder's max_length); the
# mT5 stream takes TEXT_LEN
V5_BERT, V5_T5, BERT_LEN = BertConfig(), T5Config(), 77
LORA_V5_STEPS = 2
O_BOUND = 2e-2    # bf16 o (8-bit mantissa) and the kernel's bf16 p before p @ v
# the same, as max |kernel - plain| over max |plain|: at the flagship, q
# pre-scaled and 13,360 keys, |o| stays below ~0.1, so O_BOUND alone would
# pass an o that is 20% off everywhere; this one would not
O_REL_BOUND = 2e-2
LSE_BOUND = 1e-3  # float32 sums of the same float32 scores, another order
# backward, max |kernel - plain| over max |plain| per gradient: the kernels
# round p and ds to bf16 before the products and store bf16 (relative
# rounding 2^-9 each); over thousands of terms of mixed sign the sums keep
# that relative size, and the bound leaves a 5x margin
BWD_BOUND = 2e-2
# tiny pipeline, bf16 on the card vs float32 on the CPU, latents ~ N(0, 1):
# CFG 6 scales the bf16 rounding of both halves by up to 1 + 2 * 6 = 13
REF_BOUND = 0.25
# the tiny V5 request (DDIM, whose x0 steps take random-weight latents to
# ~15): max |card - CPU| over max |CPU latents|. The plain versions in
# bf16 on the CPU read 1.9% (0.291 of 15.1), the card 2.0% (NVIDIA H100
# 80GB HBM3, 700 W); tools/reference_rehearsal.py reads the card with
# K1 broken (each row handed its neighbour's output). The bound leaves a
# 2.5x margin over the card
REF_V5_REL_BOUND = 5e-2
# and the card's error within this multiple of the same run's bf16 floor
# (the plain versions in bf16 on the CPU): 2.0% over 1.9% read 1.05
REF_V5_FLOOR_MULT = 1.5
# the tiny V4 request (2 heads x 88, 4 layers, DDIM, the slice_mag MagViT),
# held as the V5 case is: relative to the latents' scale (DDIM takes them
# to ~29 here), and within a multiple of the same run's bf16 floor. Read
# on an NVIDIA H100 80GB HBM3 (700 W): the card 1.98%, the CPU's bf16 run
# 1.72% (1.15x). K1 at d 88 alone is held to its plain version in
# `kernels`
REF_V4_REL_BOUND = 5e-2
REF_V4_FLOOR_MULT = 1.5
# the tiny V1-V3 request (2 heads x 72, motion modules at 1 head of 144 and
# 2 of 72, DDIM), held as the V4 case is, with V4's bounds. On an NVIDIA
# H100 80GB HBM3 (700 W) tools/reference_rehearsal.py --kind legacy reads
# the card 2.09% (1.30x its 1.60% floor), the plain attention on the card
# 1.97% (1.23x), K1 broken at d 72 54% (34x) and at d 144 31% (19x)
REF_LEGACY_REL_BOUND = 5e-2
REF_LEGACY_FLOOR_MULT = 1.5
# tiny training step, bf16 on the card vs float32 on the CPU: loss relative
# 1e-2, gradients 5e-2 of the largest |gradient|. bf16 weights and
# activations alone (the plain versions in bf16 on the CPU) move the
# gradients by ~1e-2 of the largest; the kernels' bf16 p and ds add as much
TRAIN_LOSS_BOUND = 1e-2
TRAIN_GRAD_BOUND = 5e-2
# the tiny LCM, reward and VAE-GAN steps (train_reference_errors), card
# against CPU float32: (loss, gradients) bounds, the loss's error relative
# to the CPU's (the reward's over the score's scale exp(logit_scale): the
# error of the mean cosine, as the loss itself can sit near 0) and the
# gradients' relative L2 error over all leaves. Set from
# tools/train_reference_seeds.py over seeds 17-24 (NVIDIA H100 80GB HBM3,
# 700 W), gradients: LCM 0.064-0.101 on the card, the same with the plain
# attention on the card and in bf16 on the CPU (the huber gradient is about
# sign(diff), and elements of diff within bf16 rounding of 0 flip it); a
# K1 handing rows their neighbours' output 0.173-0.230, K4 without dk, dv
# 0.245-0.296 (K3 without dq, 0.114-0.149, is not told apart from the
# noise here: the reward step and kernels_bwd catch it). Reward 0.039-0.062;
# broken K1, K3, K4 at least 0.265, 0.178, 0.334. The VAE steps, float32
# on both sides: 3.4e-6-2.6e-4
TRAIN_REFERENCE_BOUNDS = {"lcm": (1e-2, 0.15), "reward": (1e-2, 0.1),
                          "vae": (1e-3, 1e-3), "disc": (1e-3, 1e-3)}
TRAIN_STEPS = 3
# swa_fused: fused vs unfused streams, max |difference| over max |unfused|,
# outputs and gradients: the unfused path rounds the local and the cross
# output to bf16 before their sum, the fused one rounds the float32 sum once
# (a few bf16 ulps, 2^-8 each), and the dq halves sum in another order
FUSED_BOUND = 2e-2
# the bound's peak rates, NVIDIA H100 SXM data sheet (dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# flagship shapes: dense joint attention, the 6-direction band over the
# video tokens (window = one frame), the 256 + 771 global rows
BH, S_DENSE, S_VID, WINDOW, S_GLOBAL, HEAD_DIM = 96, 13360, 13104, 1008, 1027, 64
K1_SM90 = "flash_fwd_sm90"  # K1's TMA + wgmma kernel (csrc/flash_fwd.cu)
K1_D88_SM90 = "flash_fwd_d88_sm90"  # K1's at head dim 88 (the same file)
K1_D72_SM90 = "flash_fwd_d72_sm90"  # K1's at head dim 72 (the walk)
# K1's short-head kernel at d 72 and 144 (heads of at most 64 q and kv
# rows; csrc/fwd_short_sm90.cuh)
K1_SHORT = {d: f"flash_fwd_short_sm90ILi{d}E" for d in (72, 144)}
# K1's mma.sync body at d 144 (csrc/attn_fwd.cuh): heads past 64 q or kv
# rows, which the short-head kernel leaves; no main path runs it
K1_MMA = {144: "attn_fwd_kernelILi144ELb0"}
K2_SM90 = "swa_fwd_sm90"  # K2's (csrc/swa_fwd.cu)
K5_SM90 = "swa_fused_fwd_sm90"  # K5's (csrc/swa_fused_fwd.cu)
K3_SM90 = "flash_bwd_dq_sm90"  # K3's (csrc/flash_bwd.cu)
K4_SM90 = "flash_bwd_dkv_sm90"  # K4's (csrc/flash_bwd.cu)
K6_SM90 = "swa_bwd_dq_sm90"  # K6's (csrc/swa_bwd.cu)
K7_SM90 = "swa_bwd_dkv_sm90"  # K7's (csrc/swa_bwd.cu)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def band_columns(n, window):
    """Visible (i, j) pairs of the band |i - j| <= window over n tokens."""
    i = torch.arange(n, dtype=torch.int64)
    return int(((i + window).clamp(max=n - 1) - (i - window).clamp(min=0)
                + 1).sum())


def bound(flops, nbytes):
    """(least ms on the card, what bounds it): operations over the bf16
    peak against bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_bounds():
    """Each kernel's bound at the shape its `ms` is timed at: each input
    read once, each output written once (bf16 tensors, float32 row stats);
    products of 2 * rows * cols * d operations, cols = the visible ones."""
    bh, d = BH, HEAD_DIM
    mat = lambda n: 2 * bh * n * d              # one bf16 [bh, n, d]
    stat = lambda n: 4 * bh * n                 # one float32 [bh, n, 1]
    dense = 2 * bh * S_DENSE * S_DENSE * d      # one dense product
    band = 2 * bh * band_columns(S_VID, WINDOW) * d
    glob = 2 * bh * S_VID * S_GLOBAL * d
    cross = 2 * bh * S_DENSE * S_GLOBAL * d     # one cross-pass product
    ins_cross = 2 * mat(S_DENSE) + 2 * mat(S_GLOBAL) + 2 * stat(S_DENSE)
    ins_dense, ins_band = 4 * mat(S_DENSE) + 2 * stat(S_DENSE), \
        4 * mat(S_VID) + 2 * stat(S_VID)       # q, k, v, do, lse, di
    return {
        "K1": bound(2 * dense, 4 * mat(S_DENSE) + stat(S_DENSE)),
        # the SWA cross pass: 13,360 queries over the 1,027 global rows
        "K1 cross": bound(2 * 2 * bh * S_DENSE * S_GLOBAL * d,
                          2 * mat(S_DENSE) + 2 * mat(S_GLOBAL) + stat(S_DENSE)),
        "K2": bound(2 * band, 4 * mat(S_VID) + stat(S_VID)),
        "K3": bound(3 * dense, ins_dense + mat(S_DENSE)),
        "K4": bound(4 * dense, ins_dense + 2 * mat(S_DENSE)),
        # the cross pass's backward: q, do, lse, di over 13,360 rows, k, v
        # (and dk, dv) over the 1,027 global rows
        "K3 cross": bound(3 * cross, ins_cross + mat(S_DENSE)),
        "K4 cross": bound(4 * cross, ins_cross + 2 * mat(S_GLOBAL)),
        "K5": bound(2 * band + 2 * glob,
                    4 * mat(S_VID) + 2 * mat(S_GLOBAL)),
        "K6": bound(3 * band, ins_band + mat(S_VID)),
        "K7": bound(4 * band, ins_band + 2 * mat(S_VID)),
    }


def band_mask(n, window, device):
    i = torch.arange(n, device=device)
    return (i[:, None] - i[None, :]).abs() <= window


def library_ms(fn, iters=3):
    """ms of a PyTorch call used as a yardstick (never by the port), or
    None and the library's reason when it refuses the call."""
    try:
        return cuda_ms(fn, iters), None
    except (RuntimeError, torch.OutOfMemoryError) as err:
        torch.cuda.empty_cache()
        return None, str(err).splitlines()[0][:200]


def sdpa_band(q4, k4, v4, mask):
    """SDPA with a boolean band mask on its memory-efficient backend (the
    math backend would materialise the [b, h, S, S] scores)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False})


def phase_build():
    """Build the kernels; report the TMA + wgmma kernels (K1-K7) as
    ptxas and cuobjdump see them, and fail unless each one's SASS issues wgmma
    (HGMMA) and TMA loads (UTMALDG)."""
    t0 = time.perf_counter()
    lib = _build.build_library()
    _build.load_library()
    seconds = time.perf_counter() - t0
    out, report = {}, {}
    short = [(f"K1 short@{d}", k) for d, k in K1_SHORT.items()]
    for key, kernel in (("K1", K1_SM90), ("K1@88", K1_D88_SM90),
                        ("K1@72", K1_D72_SM90), *short, ("K2", K2_SM90),
                        ("K3", K3_SM90), ("K4", K4_SM90),
                        ("K5", K5_SM90), ("K6", K6_SM90), ("K7", K7_SM90)):
        ptxas = _build.ptxas_report(kernel)
        sass = _build.sass_counts(kernel, ("HGMMA", "UTMALDG", "UTMASTG",
                                           "USETMAXREG", "STL", "LDL"))
        # which warp role spills: the spills' addresses against each role's
        # setmaxnreg, its TMA loads or wgmma, and the exits
        sites = _build.sass_sites(kernel, ("STL", "LDL", "USETMAXREG",
                                           "HGMMA", "UTMALDG", "UTMASTG",
                                           "EXIT"))
        out[key] = {"ptxas": ptxas, "sass": sass}
        report[kernel] = {"ptxas": ptxas, "sass": sass, "sass_sites": sites}
    for d, kernel in K1_MMA.items():
        out[f"K1@{d} mma"] = {"ptxas": _build.ptxas_report(kernel),
                              "sass": _build.sass_counts(
                                  kernel, ("HMMA", "STL", "LDL"))}
    emit({"phase": "build", "library": lib.name, "seconds": seconds,
          **report, "mma_sync": {k: v for k, v in out.items()
                                 if k.endswith("mma")}})
    for kernel, r in report.items():
        if not (r["sass"]["HGMMA"] and r["sass"]["UTMALDG"]):
            raise AssertionError(f"{kernel} issues no wgmma or no TMA load: "
                                 f"{r['sass']}")
    return out


def _compare(name, fwd, plain, args):
    o, lse = fwd(*args)
    torch.cuda.synchronize()
    o_p, lse_p = plain(*args)
    err_o = (o.float() - o_p.float()).abs().max().item()
    rel_o = err_o / o_p.float().abs().max().item()
    err_l = (lse - lse_p).abs().max().item()
    ok = err_o <= O_BOUND and rel_o <= O_REL_BOUND and err_l <= LSE_BOUND
    emit({"phase": "kernels", "case": name, "shape": [list(a.shape) for a in args
                                                      if torch.is_tensor(a)],
          "max_abs_err_o": err_o, "rel_err_o": rel_o, "max_abs_err_lse": err_l,
          "bound_o": O_BOUND, "bound_rel_o": O_REL_BOUND,
          "bound_lse": LSE_BOUND, "ok": ok})
    if not ok:
        raise AssertionError(f"kernel {name} disagrees with its plain version")
    return err_o, rel_o


def _compare_fused(name, args):
    """K5 against its plain version on the same inputs (no lse: K5 has
    none)."""
    o = swa_local_global_fwd(*args)
    torch.cuda.synchronize()
    o_p = swa_local_global_plain(*args).float()
    err = (o.float() - o_p).abs().max().item()
    rel = err / o_p.abs().max().item()
    ok = err <= O_BOUND and rel <= O_REL_BOUND
    emit({"phase": "kernels", "case": name,
          "shape": [list(a.shape) for a in args if torch.is_tensor(a)],
          "max_abs_err_o": err, "rel_err_o": rel, "bound_o": O_BOUND,
          "bound_rel_o": O_REL_BOUND, "ok": ok})
    if not ok:
        raise AssertionError(f"kernel {name} disagrees with its plain version")
    return err, rel


def v5_joint_len():
    """K1's sequence on the V5 12B at HxWxFRAMES: Bert + mT5 text tokens
    and the video's patches (13,437 at 384x672x49f)."""
    return (BERT_LEN + TEXT_LEN
            + ((FRAMES - 1) // 4 + 1) * (H // 16) * (W // 16))


# V4 (EasyAnimateV4's HunyuanDiT-3D, 16 heads x 88, 40 layers) at
# 512x512x144f: the slice_mag MagViT's 144 // 4 = 36 latent frames of
# 32 x 32 patches, 36,864 tokens; K1's three shapes there, each over the
# CFG batch's 32 heads: self attention, the text cross pass over Bert's 77 +
# mT5's 256 tokens, the CLIP cross pass over the Resampler's 16
V4_H = V4_W = 512
V4_FRAMES = 144
V4_HEADS, V4_HEAD_DIM, V4_LAYERS = 16, 88, 40
V4_TOKENS = V4_FRAMES // 4 * (V4_H // 16) * (V4_W // 16)
V4_BH = 2 * V4_HEADS
V4_KV = {"self": V4_TOKENS, "text": BERT_LEN + TEXT_LEN, "clip": 16}
# the I2V request's CLIP ViT-L patch states (16 x 16 patches, width 1,024)
# and its gate: with NEW_PHASE_STEPS = 2, shut at step 0, open at step 1
V4_CLIP_N, V4_CLIP_DIM, V4_CLIP_RATIO = 256, 1024, 0.5
# K1 launches per CFG evaluation: each layer's attn1 and attn2, and for
# I2V its attn_clip (which runs with the gate shut too, on zero states)
V4_K1_T2V, V4_K1_I2V = 2 * V4_LAYERS, 3 * V4_LAYERS


def k1_bound(bh, sq, skv, d):
    """K1's bound for one call: 2 products of 2 * bh * sq * skv * d
    operations; q and o [bh, sq, d] and k and v [bh, skv, d] in bf16, the
    float32 lse [bh, sq, 1]."""
    return bound(4 * bh * sq * skv * d,
                 2 * bh * d * (2 * sq + 2 * skv) + 4 * bh * sq)


def phase_kernels_v4(gen):
    """K1 at head dim 88 (its TMA + wgmma kernel, csrc/flash_fwd.cu on
    fwd_split_sm90.cuh) against its plain version at V4's three shapes and
    on 12 ragged heads, with its kernel / plain / SDPA (yardstick) times
    and bounds at each shape."""
    dev = DEVICE

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    d = V4_HEAD_DIM
    q = rand(V4_BH, V4_TOKENS, d, scale=d ** -0.5 * LOG2E)
    k_self, v_self = rand(V4_BH, V4_TOKENS, d), rand(V4_BH, V4_TOKENS, d)
    errs, shapes = [], {}
    for name, skv in V4_KV.items():
        k, v = ((k_self, v_self) if name == "self"
                else (rand(V4_BH, skv, d), rand(V4_BH, skv, d)))
        errs.append(_compare(f"K1@88 {name} {V4_TOKENS} x {skv}",
                             flash_attention_fwd, flash_attention_plain,
                             (q, k, v, skv)))
        q4, k4, v4 = (x.view(2, V4_HEADS, -1, d) for x in (q, k, v))
        bms, by = k1_bound(V4_BH, V4_TOKENS, skv, d)
        iters = 5 if name == "self" else 20
        shapes[name] = {
            "shape": [[V4_BH, V4_TOKENS, d], [V4_BH, skv, d]],
            "ms": cuda_ms(lambda: flash_attention_fwd(q, k, v), iters),
            "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v), 2),
            "sdpa_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4), iters),
            "bound_ms": bms, "bound_by": by}
        shapes[name]["tflops"] = (4 * V4_BH * V4_TOKENS * skv * d
                                  / shapes[name]["ms"] / 1e9)
        shapes[name]["share_of_bound"] = bms / shapes[name]["ms"]
        del k, v, q4, k4, v4
    del q, k_self, v_self
    # 12 heads of 1001 rows (not a multiple of the 192-row q blocks or the
    # 96-row kv tiles), each head offset by its own mean: a tile read
    # across a head's end, or columns 88-95 read from the next row, would
    # show
    shift = torch.arange(12, device=dev).view(12, 1, 1) % 3 - 1.0
    qh = rand(12, 1001, d, scale=d ** -0.5 * LOG2E)
    kh, vh = ((rand(12, 1001, d).float() + shift).to(torch.bfloat16)
              for _ in range(2))
    errs.append(_compare("K1@88 ragged heads 1001", flash_attention_fwd,
                         flash_attention_plain, (qh, kh, vh, 1001)))
    stats = {"shapes": shapes, "max_abs_err": max(e[0] for e in errs),
             "max_rel_err": max(e[1] for e in errs)}
    emit({"phase": "kernels", "case": "K1@88 times", **stats,
          "note": "TMA + wgmma kernel flash_fwd_d88_sm90; sdpa_ms is a "
                  "yardstick, not on the path"})
    torch.cuda.empty_cache()
    return stats


def phase_kernels(gen):
    dev = torch.device("cuda")

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    qs = 64 ** -0.5 * LOG2E  # the wrappers' pre-scale of q
    stats = {}
    # K1: dense joint attention (also with kv_valid inside the last kv
    # tile), SWA cross pass, ragged + kv_valid < S, ragged heads
    q, k, v = rand(96, 13360, 64, scale=qs), rand(96, 13360, 64), rand(96, 13360, 64)
    errs = [_compare("K1 dense", flash_attention_fwd, flash_attention_plain,
                     (q, k, v, 13360)),
            _compare("K1 dense kv_valid 13000", flash_attention_fwd,
                     flash_attention_plain, (q, k, v, 13000))]
    stats["K1"] = {
        "ms": cuda_ms(lambda: flash_attention_fwd(q, k, v), 5),
        "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v), 2)}
    q4, k4, v4 = (x.view(2, 48, 13360, 64) for x in (q, k, v))
    stats["K1"]["sdpa_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4), 5)
    kc, vc = rand(96, 1027, 64), rand(96, 1027, 64)
    errs.append(_compare("K1 cross", flash_attention_fwd,
                         flash_attention_plain, (q, kc, vc, 1027)))
    stats["K1"]["cross_ms"] = cuda_ms(lambda: flash_attention_fwd(q, kc, vc), 5)
    stats["K1"]["cross_plain_ms"] = cuda_ms(
        lambda: flash_attention_plain(q, kc, vc), 2)
    g4, h4 = (x.view(2, 48, S_GLOBAL, 64) for x in (kc, vc))
    stats["K1"]["cross_sdpa_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(q4, g4, h4), 5)
    # the serve phase's other K1 shapes: one CFG half (cfg_split's halves,
    # cfg_skip's cond-only steps) and the long video's second window (45
    # frames: 12 latent frames of 24 x 42 tokens + the text)
    errs.append(_compare("K1 dense one CFG half", flash_attention_fwd,
                         flash_attention_plain,
                         (q[:48], k[:48], v[:48], 13360)))
    del q, k, v, q4, k4, v4, kc, vc, g4, h4
    # the V5 12B's joint length: the Bert (77) and mT5 (256) text tokens
    # and the video's, an odd length whose last tile the kernel masks
    s_v5 = v5_joint_len()
    q, k, v = rand(96, s_v5, 64, scale=qs), rand(96, s_v5, 64), rand(96, s_v5, 64)
    errs.append(_compare(f"K1 dense V5 {s_v5}", flash_attention_fwd,
                         flash_attention_plain, (q, k, v, s_v5)))
    stats["K1"]["v5_ms"] = cuda_ms(lambda: flash_attention_fwd(q, k, v), 5)
    stats["K1"]["v5_shape"] = [96, s_v5, 64]
    del q, k, v
    s_win = 12 * (H // 16) * (W // 16) + TEXT_LEN
    q, k, v = rand(96, s_win, 64, scale=qs), rand(96, s_win, 64), rand(96, s_win, 64)
    errs.append(_compare(f"K1 dense long-video window {s_win}",
                         flash_attention_fwd, flash_attention_plain,
                         (q, k, v, s_win)))
    del q, k, v
    qr, kr, vr = rand(16, 1001, 64, scale=qs), rand(16, 1100, 64), rand(16, 1100, 64)
    errs.append(_compare("K1 ragged kv_valid 1037", flash_attention_fwd,
                         flash_attention_plain, (qr, kr, vr, 1037)))
    # 12 heads of 1001 rows (not a multiple of the 128-row tiles), each head
    # offset by its own mean: a tile that read or wrote across a head's end
    # would carry another head's values
    shift = torch.arange(12, device=dev).view(12, 1, 1) % 3 - 1.0
    qh = rand(12, 1001, 64, scale=qs)
    kh, vh = ((rand(12, 1001, 64).float() + shift).to(torch.bfloat16)
              for _ in range(2))
    errs.append(_compare("K1 ragged heads sq 1001", flash_attention_fwd,
                         flash_attention_plain, (qh, kh, vh, 1001)))
    stats["K1"].update(max_abs_err=max(e[0] for e in errs),
                       max_rel_err=max(e[1] for e in errs))

    # K2: all 6 permuted head groups in one call, window = one frame
    q, k, v = rand(96, 13104, 64, scale=qs), rand(96, 13104, 64), rand(96, 13104, 64)
    errs = [_compare("K2 window 1008", sliding_window_fwd,
                     sliding_window_plain, (q, k, v, 1008))]
    stats["K2"] = {
        "ms": cuda_ms(lambda: sliding_window_fwd(q, k, v, 1008), 5),
        "plain_ms": cuda_ms(lambda: sliding_window_plain(q, k, v, 1008), 2)}
    q4, k4, v4 = (x.view(2, 48, S_VID, 64) for x in (q, k, v))
    mask = band_mask(S_VID, WINDOW, dev)
    stats["K2"]["library_ms"], stats["K2"]["library_error"] = library_ms(
        lambda: sdpa_band(q4, k4, v4, mask))

    # K5: the same band plus the global rows, against the pair it replaces
    # (K2 + the K1 cross pass of the video queries) and the two SDPA calls
    # that compute the same (no single library call does)
    gk, gv = rand(96, S_GLOBAL, 64), rand(96, S_GLOBAL, 64)
    errs5 = [_compare_fused("K5 window 1008 global 1027",
                            (q, k, v, gk, gv, WINDOW))]
    stats["K5"] = {
        "ms": cuda_ms(lambda: swa_local_global_fwd(q, k, v, gk, gv, WINDOW), 5),
        "plain_ms": cuda_ms(
            lambda: swa_local_global_plain(q, k, v, gk, gv, WINDOW), 2),
        "unfused_pair_ms": cuda_ms(
            lambda: (sliding_window_fwd(q, k, v, WINDOW),
                     flash_attention_fwd(q, gk, gv)), 5),
        "library_ms": None,
        "library_note": "no single PyTorch call computes K5"}
    g4, h4 = (x.view(2, 48, S_GLOBAL, 64) for x in (gk, gv))
    cross_ms, _ = library_ms(lambda: F.scaled_dot_product_attention(q4, g4, h4))
    if stats["K2"]["library_ms"] is not None and cross_ms is not None:
        stats["K5"]["sdpa_band_plus_cross_ms"] = (stats["K2"]["library_ms"]
                                                  + cross_ms)
    del q, k, v, q4, k4, v4, gk, gv, g4, h4, mask
    qr, kr, vr = rand(8, 3001, 64, scale=qs), rand(8, 3001, 64), rand(8, 3001, 64)
    errs.append(_compare("K2 ragged 3001 window 300", sliding_window_fwd,
                         sliding_window_plain, (qr, kr, vr, 300)))
    errs.append(_compare("K2 ragged heads 1001 window 200", sliding_window_fwd,
                         sliding_window_plain, (qh, kh, vh, 200)))
    stats["K2"].update(max_abs_err=max(e[0] for e in errs),
                       max_rel_err=max(e[1] for e in errs))
    gr, hr = rand(8, 300, 64), rand(8, 300, 64)
    errs5.append(_compare_fused("K5 ragged 3001 window 300 global 300",
                                (qr, kr, vr, gr, hr, 300)))
    stats["K5"].update(max_abs_err=max(e[0] for e in errs5),
                       max_rel_err=max(e[1] for e in errs5))
    emit({"phase": "kernels", "times_ms": stats,
          "note": "sdpa_ms, library_ms and sdpa_band_plus_cross_ms are "
                  "yardsticks, not on the path"})
    torch.cuda.empty_cache()
    return stats


def _bwd_case(name, bwd, plain, fwd_args, extra, gen, kv_valid=None):
    """Run the kernel pair and its plain version on the same residuals and
    cotangent do ~ N(0, 1); check each gradient within BWD_BOUND of the
    plain version's max |value|, and dk/dv exactly 0 past kv_valid."""
    qf, kf, vf = fwd_args
    o, lse = (flash_attention_fwd(qf, kf, vf, kv_valid) if kv_valid is not None
              else sliding_window_fwd(qf, kf, vf, *extra))
    do = torch.randn(o.shape, generator=gen, device=o.device).to(torch.bfloat16)
    args = (qf, kf, vf, o, lse, do, *extra)
    got = bwd(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    diff = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
    rel = {f"rel_err_{n}": d / w.float().abs().max().item()
           for n, d, w in zip(("dq", "dk", "dv"), diff, want)}
    pad_zero = (kv_valid is None or
                not (got[1][:, kv_valid:].any() or got[2][:, kv_valid:].any()))
    ok = max(rel.values()) <= BWD_BOUND and pad_zero
    emit({"phase": "kernels_bwd", "case": name,
          "shape": [list(a.shape) for a in fwd_args], **rel,
          "max_abs_err": max(diff), "bound": BWD_BOUND,
          "dk_dv_zero_past_kv_valid": pad_zero, "ok": ok})
    if not ok:
        raise AssertionError(f"backward {name} disagrees with its plain version")
    return (max(diff), max(rel.values())), args


def _entry_ms(name, args, outs, sizes, iters=5):
    """ms of one C entry point alone on prepared tensors (no counter)."""
    ptrs = [x.data_ptr() for x in args] + [x.data_ptr() for x in outs]
    return cuda_ms(lambda: _build.launch(name, args[0].device, *ptrs, *sizes),
                   iters)


def phase_kernels_bwd(gen):
    dev = torch.device("cuda")

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    qs = 64 ** -0.5 * LOG2E
    stats = {"K3": {}, "K4": {}, "K6": {}, "K7": {}}

    def time_pair(tag, prefix, args, sizes, bwd, plain, sdpa=None):
        qf, kf, vf, o, lse, do = args[:6]
        di = row_dot(o, do)
        ins = (qf, kf, vf, do, lse, di)
        dq, dk, dv = (torch.empty_like(x) for x in (qf, kf, vf))
        k_dq, k_dkv = ("K3", "K4") if prefix == "flash" else ("K6", "K7")
        t = {k_dq: _entry_ms(f"ea_{prefix}_bwd_dq_bf16", ins, (dq,), sizes),
             k_dkv: _entry_ms(f"ea_{prefix}_bwd_dkv_bf16", ins, (dk, dv), sizes),
             "pair_ms": cuda_ms(lambda: bwd(*args), 5),
             "plain_ms": cuda_ms(lambda: plain(*args), 2)}
        for k in (k_dq, k_dkv):
            stats[k][tag + "ms"] = t[k]
            stats[k][tag + "plain_ms"] = t["plain_ms"]  # one plain pass: both
        stats[k_dq][tag + "pair_ms"] = stats[k_dkv][tag + "pair_ms"] = t["pair_ms"]
        if sdpa is not None:
            stats[k_dq]["sdpa_bwd_ms"] = stats[k_dkv]["sdpa_bwd_ms"] = sdpa

    # K3 + K4: dense joint attention, SWA cross pass, ragged + kv_valid < S
    q, k, v = rand(96, 13360, 64, scale=qs), rand(96, 13360, 64), rand(96, 13360, 64)
    errs = []
    err, args = _bwd_case("K3+K4 dense", flash_attention_bwd,
                          flash_attention_bwd_plain, (q, k, v), (13360,), gen,
                          kv_valid=13360)
    errs.append(err)
    q4, k4, v4 = (x.view(2, 48, 13360, 64).detach().requires_grad_(True)
                  for x in (q, k, v))
    do4 = args[5].view(2, 48, 13360, 64)
    fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 3)
    full_ms = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), do4), 3)
    time_pair("", "flash", args, (96, 13360, 13360, 13360, 64),
              flash_attention_bwd, flash_attention_bwd_plain,
              sdpa=full_ms - fwd_ms)
    del args, q4, k4, v4, do4
    kc, vc = rand(96, 1027, 64), rand(96, 1027, 64)
    err, args = _bwd_case("K3+K4 cross", flash_attention_bwd,
                          flash_attention_bwd_plain, (q, kc, vc), (1027,), gen,
                          kv_valid=1027)
    errs.append(err)
    time_pair("cross_", "flash", args, (96, 13360, 1027, 1027, 64),
              flash_attention_bwd, flash_attention_bwd_plain)
    # yardstick: SDPA's backward (dq, dk, dv) at the cross shape
    q4, g4, h4 = (x.view(2, 48, -1, 64).detach().requires_grad_(True)
                  for x in (q, kc, vc))
    do4 = args[5].view(2, 48, S_DENSE, 64)
    fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, g4, h4), 5)
    full_ms = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q4, g4, h4), (q4, g4, h4), do4), 5)
    stats["K3"]["cross_sdpa_bwd_ms"] = stats["K4"]["cross_sdpa_bwd_ms"] = (
        full_ms - fwd_ms)
    del q, k, v, kc, vc, args, q4, g4, h4, do4
    qr, kr, vr = rand(16, 1001, 64, scale=qs), rand(16, 1100, 64), rand(16, 1100, 64)
    errs.append(_bwd_case("K3+K4 ragged kv_valid 1037", flash_attention_bwd,
                          flash_attention_bwd_plain, (qr, kr, vr), (1037,),
                          gen, kv_valid=1037)[0])
    for key in ("K3", "K4"):
        stats[key]["max_abs_err"] = max(e[0] for e in errs)
        stats[key]["max_rel_err"] = max(e[1] for e in errs)

    # K6 + K7: all 6 permuted head groups in one call, window = one frame
    q, k, v = rand(96, 13104, 64, scale=qs), rand(96, 13104, 64), rand(96, 13104, 64)
    err, args = _bwd_case("K6+K7 window 1008", sliding_window_bwd,
                          sliding_window_bwd_plain, (q, k, v), (1008,), gen)
    errs = [err]
    time_pair("", "swa", args, (96, 13104, 1008, 64), sliding_window_bwd,
              sliding_window_bwd_plain)
    # yardstick: one SDPA backward with the boolean band mask computes dq,
    # dk and dv together
    q4, k4, v4 = (x.view(2, 48, S_VID, 64).detach().requires_grad_(True)
                  for x in (q, k, v))
    do4 = args[5].view(2, 48, S_VID, 64)
    mask = band_mask(S_VID, WINDOW, dev)
    fwd_ms, err_f = library_ms(lambda: sdpa_band(q4, k4, v4, mask))
    full_ms, err_b = library_ms(lambda: torch.autograd.grad(
        sdpa_band(q4, k4, v4, mask), (q4, k4, v4), do4))
    for key in ("K6", "K7"):
        stats[key]["library_bwd_ms"] = (full_ms - fwd_ms if None not in
                                        (fwd_ms, full_ms) else None)
        stats[key]["library_error"] = err_f or err_b
    del q, k, v, args, q4, k4, v4, do4, mask
    qr, kr, vr = rand(8, 3001, 64, scale=qs), rand(8, 3001, 64), rand(8, 3001, 64)
    errs.append(_bwd_case("K6+K7 ragged 3001 window 300", sliding_window_bwd,
                          sliding_window_bwd_plain, (qr, kr, vr), (300,),
                          gen)[0])
    for key in ("K6", "K7"):
        stats[key]["max_abs_err"] = max(e[0] for e in errs)
        stats[key]["max_rel_err"] = max(e[1] for e in errs)
    emit({"phase": "kernels_bwd", "times_ms": stats,
          "note": "ms: one kernel alone; pair_ms: the wrapper (di + both "
                  "kernels); plain_ms: the plain backward (both gradients); "
                  "sdpa_bwd_ms is a yardstick, not on the path"})
    torch.cuda.empty_cache()
    return stats


def _tiny_models(dtype, inpaint=False, v5=False):
    """Tiny MMDiT (6 heads x 16, one dense + one SWA layer; with inpaint,
    4 + 1 + 4 input channels; with v5, two dense layers with V5's two text
    streams at the tiny towers' widths, their norms and after_norm) and a
    4-block MagViT VAE, random float32 weights from a fixed seed, cast to
    dtype."""
    cfg = dataclasses.replace(PRESETS["tiny"], num_attention_heads=6,
                              swa_layers=None if v5 else (1,),
                              in_channels=9 if inpaint else 4)
    if v5:
        cfg = dataclasses.replace(
            cfg, text_embed_dim=TINY_BERT.hidden_size,
            text_embed_dim_t5=TINY_T5.d_model, add_norm_text_encoder=True,
            after_norm=True)
    vae_cfg = MagvitVAEConfig(latent_channels=4,
                              block_out_channels=(32, 64, 128, 128),
                              norm_num_groups=8, decode_chunk_frames=4)
    gen = torch.Generator().manual_seed(7)
    models = (init_random_(EasyAnimateTransformer3D(cfg, device="cpu"), gen),
              init_random_(AutoencoderKLMagvit(vae_cfg, device="cpu"), gen))
    if dtype == "float32":
        return models
    cast = (EasyAnimateTransformer3D(dataclasses.replace(cfg, dtype=dtype),
                                     device="cpu"),
            AutoencoderKLMagvit(dataclasses.replace(vae_cfg, dtype=dtype),
                                device="cpu"))
    for dst, src in zip(cast, models):
        dst.load_state_dict(src.state_dict())
    return cast


def _tiny_v5_prompts(device):
    """V5's two streams for the tiny reference: the tiny Bert and mT5
    towers (random float32 weights from a fixed seed, float32 on the card
    too, as the port runs them) on a CFG pair of right-padded ids. Returns
    the pipeline's keywords, [positive, negative] in each stream."""
    gen = torch.Generator().manual_seed(12)
    out = {}
    for cls, enc_cls, cfg, n, key in (
            (BertModel, BertTextEncoder, TINY_BERT, 12, ""),
            (MT5EncoderModel, MT5TextEncoder, TINY_T5, 16, "_t5")):
        tower = init_random_(cls(cfg, device="cpu"), gen).to(device)
        ids = torch.randint(1, cfg.vocab_size, (2, n), generator=gen)
        mask = (torch.arange(n)[None] < torch.tensor([[n - 2], [3]])).long()
        emb, _ = enc_cls(tower, max_length=n).encode_ids(ids * mask, mask)
        out[f"prompt_embeds{key}"] = emb[:1]
        out[f"negative_prompt_embeds{key}"] = emb[1:]
    return out


# the tiny V4 request's frames: 4 latent frames of the slice_mag MagViT
# (mini_batch 8 / 2) decode to 2 chunks of 5 frames, and smooth_output
# re-decodes their middle 2 (the one re-decoded frame is broadcast, as JAX
# does)
V4_REF_FRAMES = 16


def _tiny_v4_models(dtype):
    """Tiny V4 (2 heads x 88, 4 layers so that both skip halves exist, the
    yaml's time_position_encoding, text widths of the tiny Bert and mT5
    towers) and the 4-block MagViT in V4's slice_mag (mini_batch 8 / 2),
    random float32 weights from a fixed seed, cast to dtype."""
    cfg = HunyuanConfig(num_attention_heads=2, attention_head_dim=88,
                        num_layers=4, cross_attention_dim=TINY_BERT.hidden_size,
                        cross_attention_dim_t5=TINY_T5.d_model,
                        pooled_projection_dim=32, text_len=12, text_len_t5=16,
                        time_position_encoding=True, dtype="float32")
    vae_cfg = MagvitVAEConfig(latent_channels=4,
                              block_out_channels=(32, 64, 128, 128),
                              norm_num_groups=8, chunk_mode="slice_mag",
                              mini_batch_encoder=8, mini_batch_decoder=2)
    gen = torch.Generator().manual_seed(7)
    models = (init_random_(HunyuanTransformer3D(cfg, device="cpu"), gen),
              init_random_(AutoencoderKLMagvit(vae_cfg, device="cpu"), gen))
    if dtype == "float32":
        return models
    cast = (HunyuanTransformer3D(dataclasses.replace(cfg, dtype=dtype),
                                 device="cpu"),
            AutoencoderKLMagvit(dataclasses.replace(vae_cfg, dtype=dtype),
                                device="cpu"))
    for dst, src in zip(cast, models):
        dst.load_state_dict(src.state_dict())
    return cast


def reference_runs(kind, runs):
    """The tiny request of `kind` from fixed weights, noise and prompt:
    T2V, I2V from a random start image through get_image_to_video_latent,
    V5 (the tiny towers' two streams into the tiny dual-stream MMDiT,
    DDIM), or V4 (the same two streams into the tiny HunyuanDiT, DDIM,
    V4_REF_FRAMES through the slice_mag MagViT), once per (name, device,
    dtype) of `runs`. Returns {name: float32 latents on the CPU} and the
    decoded uint8 video of the run named "card" (None without one); for
    V4 also the card's decode without smoothing. "legacy": the tiny V1-V3
    Transformer3D (_tiny_legacy_models) at 128 x 128 x 5f, DDIM."""
    gen = torch.Generator().manual_seed(11)
    v4, legacy = kind == "v4", kind == "legacy"
    # the legacy request at 128 x 128: 64 tokens a frame, so that the text
    # and Global_Self passes (2 frames) run past 64 q rows on K1's d 72
    # persistent walk and the spatial and temporal ones on its short-head
    # kernel
    px = 128 if legacy else 64
    lat0 = torch.randn(1, 4, V4_REF_FRAMES // 4 if v4 else 2, px // 8,
                       px // 8, generator=gen)
    pos = torch.randn(1, 6, 24, generator=gen)
    kw = dict(height=px, width=px, video_length=V4_REF_FRAMES if v4 else 5,
              num_inference_steps=3, guidance_scale=6.0, latents=lat0,
              output_type="latent")
    inpaint, v5 = kind == "i2v", kind in ("v5", "v4")
    if inpaint:
        image = torch.randint(0, 256, (64, 64, 3), generator=gen,
                              dtype=torch.uint8).numpy()
        video, mask = get_image_to_video_latent(image, None, 5, (64, 64))
        # the augmentation's draws would differ between the two devices
        kw.update(video=video, mask_video=mask, noise_aug_strength=0.0)
    pipe_cls = EasyAnimateInpaintPipeline if inpaint else EasyAnimatePipeline
    outs, decoded = {}, None
    for name, device, dtype in runs:
        models = (_tiny_v4_models(dtype) if v4
                  else _tiny_legacy_models(dtype) if legacy
                  else _tiny_models(dtype, inpaint, v5))
        model, vae = (m.to(device) for m in models)
        pipe = pipe_cls(model, vae, device)
        if v5:  # V5's and V4's scheduler (the yamls' ddim), two streams
            pipe.scheduler = DDIMConfig()
            out = pipe(**_tiny_v5_prompts(device), **kw)
        elif legacy:  # V1-V3's ddim, one T5 stream
            pipe.scheduler = DDIMConfig()
            out = pipe(pos, torch.zeros_like(pos), **kw)
        else:
            out = pipe(pos, torch.zeros_like(pos), **kw)
        outs[name] = out.float().cpu()
        if name == "card":
            decoded = pipe.decode_latents(out, to_uint8=True)
            if v4:  # smooth_output on by default for slice_mag
                decoded = (decoded, pipe.decode_latents(
                    out, smooth=False, to_uint8=True))
    return outs, decoded


def phase_reference(kind):
    """The tiny request of `kind` (reference_runs) on the card (bf16,
    kernels) against the CPU (float32, plain versions); V5, V4 and V1-V3
    ("legacy") also against their bf16 floor. V4's decode must smooth (its
    middle frames differ from the unsmoothed decode's)."""
    rel = {"v5": (REF_V5_REL_BOUND, REF_V5_FLOOR_MULT),
           "v4": (REF_V4_REL_BOUND, REF_V4_FLOOR_MULT),
           "legacy": (REF_LEGACY_REL_BOUND, REF_LEGACY_FLOOR_MULT)}.get(kind)
    runs = [("cpu", "cpu", "float32"), ("card", "cuda", "bfloat16")]
    if rel:  # the bf16 floor: the plain versions in bf16 on the CPU
        runs.append(("cpu_bf16", "cpu", "bfloat16"))
    outs, video = reference_runs(kind, runs)
    frames, want_frames = (V4_REF_FRAMES, 10) if kind == "v4" else (5, 5)
    px = 128 if kind == "legacy" else 64
    diff = (outs["card"] - outs["cpu"]).abs()
    err = diff.max().item()
    row = {"phase": "reference", "what": f"tiny {kind.upper()} {px}x{px}x"
           f"{frames}f, 3 steps: card bf16 kernels vs CPU float32 plain",
           "max_abs_err_latents": err,
           "mean_abs_err_latents": diff.mean().item()}
    if kind == "v4":
        video, unsmoothed = video
        blend = np.abs(video.astype(np.int16) - unsmoothed)
        row.update(smoothed_frames=[int(i) for i in np.nonzero(
            blend.max(axis=(0, 1, 3, 4)))[0]])
        ok = bool(blend[:, :, 4:-4].max() > 0 and blend[:, :, :4].max() == 0)
    else:
        ok = True
    if rel:
        # DDIM's x0 steps take random-weight latents far from N(0, 1), so
        # the V5, V4 and V1-V3 cases are held relative to their scale
        scale = outs["cpu"].abs().max().item()
        floor = (outs["cpu_bf16"] - outs["cpu"]).abs().max().item()
        row.update(latents_abs_max=scale, rel_err_latents=err / scale,
                   cpu_bf16_rel_err_latents=floor / scale,
                   bound_rel=rel[0], bound_over_floor=rel[1])
        ok = ok and err / scale <= rel[0] and err <= rel[1] * floor
    else:
        row["bound"] = REF_BOUND
        ok = err <= REF_BOUND
    ok = (ok and video.shape == (1, 3, want_frames, px, px)
          and video.dtype.name == "uint8")
    emit({**row, "video_shape": list(video.shape), "ok": ok})
    if not ok:
        raise AssertionError(f"tiny {kind} pipeline on the card disagrees "
                             "with the CPU")


def _tiny_train_inputs():
    """One batch and one set of draws for the tiny training checks, made on
    the CPU from a seed (the card and the CPU get the same numbers)."""
    gen = torch.Generator().manual_seed(13)
    lat = torch.randn(1, 4, 3, 16, 16, generator=gen)
    batch = {"latents": lat, "text": torch.randn(1, 5, 24, generator=gen)}
    draws = ttrainer.draw_flow_inputs(gen, lat, ttrainer.TrainConfig().loss)
    return batch, draws


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


def _rel_err(got, want):
    """max |got - want| over all tensors, relative to max |want|."""
    scale = max(w.abs().max().item() for w in want.values())
    return max((got[k].float().cpu() - w).abs().max().item()
               for k, w in want.items()) / scale


def phase_train_reference():
    """A tiny SFT step and a tiny LoRA step, on the card in bf16 through the
    kernels and on the CPU in float32 through the plain versions, from the
    same weights and draws: loss and gradients, then one step each; then
    train_reference_errors's LCM, reward and VAE-GAN steps."""
    batch, draws = _tiny_train_inputs()
    tcfg = ttrainer.TrainConfig()
    lcfg = tlora.LoRAConfig(rank=4)
    res = {}
    lora = tlora.lora_init(_tiny_models("float32")[0], lcfg,
                           torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    for f in lora.values():  # non-zero up: the down factors get gradients
        f["up"].normal_(0.0, 0.01, generator=gen)
    for device, dtype in (("cpu", "float32"), ("cuda", "bfloat16")):
        model, _ = _tiny_models(dtype)
        model = model.to(device)
        b, d = _to(batch, device), ttrainer.FlowDraws(*_to(tuple(draws), device))
        b["rope"] = build_rope(model.cfg, 128, 128, 3, device=device)
        loss, _ = ttrainer.make_loss_fn(model, tcfg)(b, d)
        loss.backward()
        sft_grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                     if p.grad is not None}
        state, sft_m = ttrainer.make_train_step(model, tcfg)(
            ttrainer.create_train_state(model, tcfg), b, draws=d)

        model, _ = _tiny_models(dtype)
        model = model.to(device)
        init, step = tlora.make_lora_train_step(model, tcfg, lcfg)
        lstate = init(lora={p: {k: t.clone().to(device) for k, t in f.items()}
                            for p, f in lora.items()})
        with tlora.attach_lora(model, lstate.params, lcfg):
            pred, target = ttrainer.flow_prediction(model, b, d)
            lloss = ttrainer.masked_mse_loss(pred, target)
            lloss.backward()
        lora_grads = {k: t.grad.float().cpu() for k, t
                      in tlora.flatten_lora(lstate.params).items()
                      if t.grad is not None}
        lstate, lora_m = step(lstate, b, draws=d)
        res[device] = dict(sft_loss=loss.item(), sft_grads=sft_grads,
                           sft_step_loss=sft_m["loss"].item(),
                           lora_loss=lloss.item(), lora_grads=lora_grads,
                           lora_step_loss=lora_m["loss"].item())
    cpu, gpu = res["cpu"], res["cuda"]
    out = {"phase": "train_reference",
           "what": "tiny MMDiT (6 heads x 16, dense + SWA layer), 1x4x3x16x16 "
                   "latents: card bf16 kernels vs CPU float32 plain; LCM "
                   "(rank 4, EMA target), reward (3 steps, tail 2, tiny "
                   "CLIP score of one 64x64 frame) and the tiny MagViT's "
                   "ae_step + disc_step (float32 on both, LPIPS, "
                   "Discriminator3D)"}
    for kind in ("sft", "lora"):
        out[f"{kind}_loss_rel_err"] = abs(gpu[f"{kind}_loss"] - cpu[f"{kind}_loss"]
                                          ) / abs(cpu[f"{kind}_loss"])
        out[f"{kind}_grad_rel_err"] = _rel_err(gpu[f"{kind}_grads"],
                                               cpu[f"{kind}_grads"])
        out[f"{kind}_step_loss"] = [cpu[f"{kind}_step_loss"],
                                    gpu[f"{kind}_step_loss"]]
    ok = (set(gpu["sft_grads"]) == set(cpu["sft_grads"])
          and set(gpu["lora_grads"]) == set(cpu["lora_grads"])
          and all(out[f"{k}_loss_rel_err"] <= TRAIN_LOSS_BOUND
                  and out[f"{k}_grad_rel_err"] <= TRAIN_GRAD_BOUND
                  for k in ("sft", "lora")))
    for kind, row in train_reference_errors().items():
        out.update({f"{kind}_loss_err": row["err"][0],
                    f"{kind}_grad_rel_l2": row["err"][1],
                    f"{kind}_grad_rel_err": row["err"][2],
                    f"{kind}_bounds": row["bounds"],
                    f"{kind}_step_loss": row["step_loss"]})
        if "floor" in row:
            out[f"{kind}_bf16_floor"] = row["floor"]
        ok = ok and row["ok"]
    out.update(loss_bound=TRAIN_LOSS_BOUND, grad_bound=TRAIN_GRAD_BOUND,
               ok=ok)
    emit(out)
    if not ok:
        raise AssertionError("tiny training step on the card disagrees with the CPU")


class ClipWordTokenizer:
    """A word-level stand-in for a CLIP tokenizer (its files are not in the
    repository): bos, each whitespace-separated word hashed to an id below
    it, eos, padded with eos to max_length (as OpenAI's CLIP pads); the
    Hugging Face call interface the reward models use."""

    model_max_length = 77

    def __init__(self, vocab_size=49408):
        self.bos, self.eos = vocab_size - 2, vocab_size - 1

    def __call__(self, prompts, padding, truncation, max_length,
                 return_tensors):
        ids = np.full((len(prompts), max_length), self.eos, np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for i, text in enumerate(prompts):
            row = [self.bos] + [zlib.crc32(w.encode()) % self.bos
                                for w in text.split()]
            row = row[:max_length - 1] + [self.eos]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@contextlib.contextmanager
def grads_seen(module, name):
    """Within the block, the optimizers that module.<name> makes keep each
    update's gradients (float32 copies on the CPU, in call order)."""
    seen, real = [], getattr(module, name)

    def factory(*a, **k):
        tx = real(*a, **k)

        def update(grads, state, params=None):
            seen.append({n: g.detach().float().cpu() for n, g in grads.items()})
            return tx.update(grads, state, params)

        return toptim.GradientTransformation(tx.init, update)

    setattr(module, name, factory)
    try:
        yield seen
    finally:
        setattr(module, name, real)


TINY_REWARD_LATENTS = (1, 4, 3, 8, 8)  # 64x64 pixels through the tiny MagViT
REWARD_PROMPTS = ("a red bird on a branch", "a cat asleep on a sofa")


def _tiny_clip(device):
    """A 2-layer CLIP (32 wide, 32 px, gelu), random weights from a seed."""
    cfg = tclip.CLIPConfig(
        tclip.CLIPTextConfig(vocab_size=1000, hidden_size=32,
                             intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=2, hidden_act="gelu",
                             eos_token_id=999),
        tclip.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                               num_hidden_layers=2, num_attention_heads=2,
                               image_size=32, patch_size=8, hidden_act="gelu"),
        projection_dim=16)
    model = init_random_(tclip.CLIPModel(cfg, device="cpu"),
                         torch.Generator().manual_seed(19))
    return model.to(device)


def _tiny_gan(device):
    """Discriminator3D (base 8, 2 layers) and LPIPS, random from a seed."""
    gen = torch.Generator().manual_seed(23)
    disc = init_random_(Discriminator3D(8, 2, device="cpu"), gen)
    lpips = init_random_(LPIPS(device="cpu"), gen).requires_grad_(False)
    return disc.to(device), lpips.to(device)


def _clone_lora(lora, device):
    return {p: {k: t.detach().clone().to(device) for k, t in f.items()}
            for p, f in lora.items()}


def _train_reference_slice(pairs, seed=17):
    """The LCM step and the reward step (tiny CLIP score) on each (device,
    dtype) of `pairs`, from the same weights, and factors and draws from
    `seed`: [{"<kind>_loss": float, "<kind>_grads": {name: tensor}}] in the
    order of `pairs`, for kind lcm and reward (each optimizer's input
    gradients)."""
    batch, _ = _tiny_train_inputs()
    gen = torch.Generator().manual_seed(seed)
    lcfg = tlora.LoRAConfig(rank=4)
    lora = tlora.lora_init(_tiny_models("float32")[0], lcfg, gen)
    for f in lora.values():  # non-zero up: the down factors get gradients
        f["up"].normal_(0.0, 0.01, generator=gen)
    ema = {p: {k: t + 0.01 * torch.randn(t.shape, generator=gen)
               for k, t in f.items()} for p, f in lora.items()}
    lcm_cfg = tlcm.LCMConfig(num_ddim_timesteps=10)
    lcm_draws = tlcm.LCMDraws(torch.tensor([6]),
                              torch.randn(batch["latents"].shape,
                                          generator=gen), torch.tensor([7.5]))
    rcfg = treward.RewardConfig(num_sample_steps=3, backprop_strategy="tail",
                                backprop_num_steps=2, guidance_scale=3.0)
    r_noise = torch.randn(TINY_REWARD_LATENTS, generator=gen)
    res = []
    for device, dtype in pairs:
        out = {}
        model, vae = (m.to(device) for m in _tiny_models(dtype))
        b = _to(batch, device)
        b["rope"] = build_rope(model.cfg, 128, 128, 3, device=device)
        with grads_seen(tlcm, "make_optimizer") as seen:
            init, step = tlcm.make_lcm_train_step(
                model, DDIMConfig(), lcm_cfg, lcfg, ttrainer.TrainConfig())
            st = init(lora=_clone_lora(lora, device))
            st.ema_params = _clone_lora(ema, device)
            _, m = step(st, b, draws=tlcm.LCMDraws(*_to(tuple(lcm_draws),
                                                         device)))
        out.update(lcm_loss=m["loss"].item(), lcm_grads=seen[-1])

        scorer = CLIPScoreReward(_tiny_clip(device), ClipWordTokenizer(1000))
        rb = {"text": b["text"], "latent_shape": TINY_REWARD_LATENTS,
              "rope": build_rope(model.cfg, 64, 64, 3, device=device)}
        with grads_seen(treward, "make_optimizer") as seen:
            init, step = treward.make_reward_train_step(
                model, vae, lambda fr: scorer(fr, REWARD_PROMPTS)[1][None],
                rcfg, lcfg, ttrainer.TrainConfig(),
                vae_scaling=vae.cfg.scaling_factor)
            st = init(lora=_clone_lora(lora, device))
            _, m = step(st, rb, draws=treward.RewardDraws(
                r_noise.to(device), treward.backprop_step_mask(rcfg)))
        out.update(reward_loss=m["loss"].item(), reward_grads=seen[-1])
        res.append(out)
    return res


def _vae_train_reference(device, seed=17):
    """The tiny MagViT's ae_step and disc_step (float32, LPIPS,
    Discriminator3D, disc_start 0) on `device`, each from the initial
    weights (an Adam step moves a parameter by ~lr * sign(g), so one side's
    disc_step after its ae_step would read other weights wherever a
    gradient sat within rounding of 0), on a clip and sample draw from
    `seed`: {"<kind>_loss", "<kind>_grads"} for kind vae and disc."""
    gen = torch.Generator().manual_seed(seed)
    video = torch.rand((1, 3, 5, 64, 64), generator=gen) * 2 - 1
    noise = torch.randn((1, 4, 2, 8, 8), generator=gen).to(device)
    vb = {"video": video.to(device)}
    cfg = tvt.VAETrainConfig(loss=VAELossConfig(disc_start=0))
    out = {}
    for kind in ("vae", "disc"):
        vae32 = _tiny_models("float32")[1].to(device)
        disc, lpips = _tiny_gan(device)
        with grads_seen(tvt, "_adam") as seen:
            state = tvt.create_vae_train_state(vae32, disc, cfg)
            ae, ds = tvt.make_vae_train_steps(vae32, disc, cfg, lpips)
            if kind == "vae":
                _, aux = ae(state, vb, noise=noise)
                loss = aux["loss"]
            else:
                _, aux = ds(state, vb, noise=noise)
                loss = aux["disc_loss"]
        out.update({f"{kind}_loss": loss.item(), f"{kind}_grads": seen[0]})
    return out


def _rel_l2(got, want):
    """||got - want|| over ||want||, all tensors as one vector."""
    num = sum(((got[k].float().cpu() - w) ** 2).sum().item()
              for k, w in want.items())
    return math.sqrt(num / sum((w ** 2).sum().item() for w in want.values()))


def train_step_errors(got, want, kind):
    """(loss error, gradients' relative L2 error, max |gradient error| over
    the largest |gradient|) of one train_reference step against another;
    see TRAIN_REFERENCE_BOUNDS."""
    loss, grads = f"{kind}_loss", f"{kind}_grads"
    scale = (math.exp(tclip.CLIPConfig.logit_scale_init_value)
             if kind == "reward" else abs(want[loss]))
    return (abs(got[loss] - want[loss]) / scale,
            _rel_l2(got[grads], want[grads]),
            _rel_err(got[grads], want[grads]))


def train_reference_errors(seed=17):
    """The card against the CPU in float32 on the tiny LCM and reward steps
    (the card's MMDiT in bf16 through the kernels; "floor": the CPU's plain
    versions in bf16, reported, not bounded) and the tiny VAE steps
    (float32 on both): {kind: {"err": train_step_errors, "bounds":
    TRAIN_REFERENCE_BOUNDS[kind], "floor" for lcm and reward, "step_loss":
    [cpu, card], "ok": bool}}."""
    f32, bf16, card = _train_reference_slice(
        (("cpu", "float32"), ("cpu", "bfloat16"), ("cuda", "bfloat16")), seed)
    cpu_vae, card_vae = (_vae_train_reference(d, seed) for d in ("cpu", "cuda"))
    f32.update(cpu_vae)
    card.update(card_vae)
    rows = {}
    for kind, bounds in TRAIN_REFERENCE_BOUNDS.items():
        err = train_step_errors(card, f32, kind)
        rows[kind] = {"err": err, "bounds": bounds,
                      "step_loss": [f32[f"{kind}_loss"], card[f"{kind}_loss"]],
                      "ok": (set(card[f"{kind}_grads"]) == set(f32[f"{kind}_grads"])
                             and err[0] <= bounds[0] and err[1] <= bounds[1])}
        if kind in ("lcm", "reward"):
            rows[kind]["floor"] = train_step_errors(bf16, f32, kind)
    return rows


def build_12b(seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = EasyAnimateTransformer3D(PRESETS["v5.1-12b"], device="meta")
    vae = AutoencoderKLMagvit(MagvitVAEConfig(dtype="bfloat16",
                                              decode_chunk_frames=4),
                              device="meta")
    model = init_random_(model.to_empty(device=dev), gen)
    vae = init_random_(vae.to_empty(device=dev), gen)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    emit({"phase": "build_12b", "params": n,
          "bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
          "vae_params": sum(p.numel() for p in vae.parameters()),
          "seconds": time.perf_counter() - t0})
    return model, vae


def swa_variant(model):
    """The same weights with swa_layers = 1..47 (SWA adds no parameters)."""
    cfg = dataclasses.replace(model.cfg, swa_layers=tuple(range(1, 48)))
    swa = EasyAnimateTransformer3D(cfg, device="meta")
    swa.load_state_dict(model.state_dict(), assign=True)
    return swa


def request(phase, pipe, seed, steps, counters, embeds=None,
            embeds_from="text phase (Qwen2-VL tower)", **inputs):
    """One request through the pipeline's __call__ (T2V, or I2V with the
    `inputs`); checks the output, the per-step latents and the kernels'
    launch counts. `embeds` (positive, negative) replace the random prompt
    embeddings. A pre-hook stamps the transformer's first call, so the
    time before it (the VAE encode of an I2V request) stands apart.
    Returns the launches, the uint8 video and the final latents."""
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = 0.02 * torch.randn(1, TEXT_LEN, pipe.transformer.cfg.text_embed_dim,
                             generator=gen, device=dev)
    neg = torch.zeros_like(pos)
    if embeds is not None:
        pos, neg = embeds
    lat0 = torch.randn(pipe.latent_shape(1, FRAMES, H, W), generator=gen,
                       device=dev)
    before = {k: f.launches for k, f in counters.items()}
    stamps, prev, first_call = [], [lat0.to(pipe.transformer.cfg.torch_dtype)], []

    def stamp_first_call(module, args):
        if not first_call:
            torch.cuda.synchronize()
            first_call.append(time.perf_counter())

    def check_step(i, lat):
        if not bool(torch.isfinite(lat).all()):  # syncs: stamps are real
            raise AssertionError(f"{phase}: non-finite latents at step {i}")
        if torch.equal(prev[0], lat):
            raise AssertionError(f"{phase}: latents unchanged at step {i}")
        prev[0] = lat.clone()
        stamps.append(time.perf_counter())

    hook = pipe.transformer.register_forward_pre_hook(stamp_first_call)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        video = pipe(pos, neg, height=H, width=W, video_length=FRAMES,
                     num_inference_steps=steps, guidance_scale=6.0,
                     latents=lat0, generator=gen, output_type="uint8",
                     callback=check_step, **inputs)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    t_end = time.perf_counter()
    launched = {k: f.launches - before[k] for k, f in counters.items()}
    step_s = [b - a for a, b in zip(first_call + stamps, stamps)]
    out = {"phase": phase, "seed": seed, "steps": steps,
           "video_shape": list(video.shape), "video_dtype": str(video.dtype),
           "video_mean": float(video.mean()),
           "before_denoise_s": first_call[0] - t0,
           "denoise_s_per_step": sum(step_s) / steps,
           "denoise_s_per_step_after_first": (
               sum(step_s[1:]) / (steps - 1) if steps > 1 else None),
           "first_step_s": step_s[0], "vae_decode_s": t_end - stamps[-1],
           "request_s": t_end - t0,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launched}
    if "video" in inputs:
        out["vae_encode_s"] = out["before_denoise_s"]
    if embeds is not None:
        out["prompt_embeds"] = embeds_from
    emit(out)
    if video.shape != (1, 3, FRAMES, H, W) or video.dtype.name != "uint8":
        raise AssertionError(f"{phase}: video {video.shape} {video.dtype}")
    return {"launched": launched, "video": video, "latents": prev[0]}


LOADER_STEPS = 2
# loader: the loaded and the in-memory modules on the same inputs. Equal
# weights on one card give equal results; if they do not, max |difference|
# over max |in-memory| is held to this
LOADER_BOUND = 1e-3
# the V5.1-12B widths cut to 2 layers, layer 1 SWA: K1 twice a step (the
# dense layer and layer 1's cross pass), K2 once
LOADER_LAUNCHES = {"K1": 2 * LOADER_STEPS, "K2": LOADER_STEPS}
LOADER_SHARD_BYTES = 256 * 2 ** 20
FULL_VAE_JSON = {"_class_name": "AutoencoderKLMagvit", "in_channels": 3,
                 "out_channels": 3, "latent_channels": 16,
                 "block_out_channels": [128, 256, 512, 512],
                 "down_block_types": list(MagvitVAEConfig.down_block_types),
                 "up_block_types": list(MagvitVAEConfig.up_block_types),
                 "layers_per_block": 2, "norm_num_groups": 32,
                 "mini_batch_encoder": 4, "mini_batch_decoder": 1,
                 "scaling_factor": 0.7119, "cache_mag_vae": True}


def _dir_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def _cosine(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def phase_loader(seed, path_run):
    """A reference-layout V5.1 directory written by the port's own writer
    (transformer at the 12B widths cut to 2 layers, layer 1 SWA, sharded;
    the full MagViT; a FlowMatch scheduler) into a temporary directory,
    loaded with load_pipeline on the card (strict), every tensor checked
    equal to the written one; one request on the loaded and one on the
    written in-memory modules (equal results), then an fp8 load and its
    request."""
    cfg = dataclasses.replace(PRESETS["v5.1-12b"], num_layers=2,
                              swa_layers=(1,))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = init_random_(EasyAnimateTransformer3D(cfg, device="meta")
                         .to_empty(device=DEVICE), gen)
    vae = init_random_(AutoencoderKLMagvit(
        MagvitVAEConfig(dtype="bfloat16", decode_chunk_frames=4),
        device="meta").to_empty(device=DEVICE), gen)
    out = {"phase": "loader", "layers": cfg.num_layers,
           "swa_layers": list(cfg.swa_layers), "steps": LOADER_STEPS,
           "params": sum(p.numel() for p in model.parameters()),
           "vae_params": sum(p.numel() for p in vae.parameters())}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loader_") as root:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards = save_reference_checkpoint(
            os.path.join(root, "transformer"), model.state_dict(),
            mmdit_config_json(cfg), max_shard_bytes=LOADER_SHARD_BYTES)
        save_reference_checkpoint(os.path.join(root, "vae"), vae.state_dict(),
                                  FULL_VAE_JSON)
        os.makedirs(os.path.join(root, "scheduler"))
        with open(os.path.join(root, "scheduler", "scheduler_config.json"),
                  "w") as f:
            json.dump({"_class_name": "FlowMatchEulerDiscreteScheduler",
                       "num_train_timesteps": 1000, "shift": 3.0,
                       "use_dynamic_shifting": True}, f)
        out.update(write_s=time.perf_counter() - t0, dir_bytes=_dir_bytes(root),
                   transformer_shards=len(shards))

        t0 = time.perf_counter()
        pipe = load_pipeline(root)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        pairs = [(model.state_dict(), pipe.transformer.state_dict()),
                 (vae.state_dict(), pipe.vae.state_dict())]
        same_keys = all(set(want) == set(got) for want, got in pairs)
        unequal = [k for want, got in pairs for k, v in want.items()
                   if k not in got or not torch.equal(got[k], v)]
        del pairs  # its references would keep the loaded copy alive
        out.update(tensors_equal=not unequal and same_keys,
                   loaded_device=str(pipe.device))
        if unequal or not same_keys:
            raise AssertionError(f"loader: loaded tensors differ: {unequal[:6]}")

        def run(phase, p):
            return path_run(phase, lambda: request(
                phase, p, seed + 1, LOADER_STEPS, COUNTERS),
                dict(dict.fromkeys(COUNTERS, 0), **LOADER_LAUNCHES))

        loaded = run("loader_loaded", pipe)
        del pipe
        memory = run("loader_in_memory", EasyAnimatePipeline(model, vae))
        ref = memory["latents"].float()
        out["latents_identical"] = torch.equal(loaded["latents"],
                                               memory["latents"])
        out["video_identical"] = bool((loaded["video"] == memory["video"]).all())
        out["latents_rel_diff"] = ((loaded["latents"].float() - ref).abs().max()
                                   / ref.abs().max()).item()
        if out["latents_rel_diff"] > LOADER_BOUND:
            raise AssertionError(f"loader: loaded and in-memory latents differ "
                                 f"by {out['latents_rel_diff']}")
        del model, vae
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        pipe = load_pipeline(root, fp8_weights=True)
        torch.cuda.synchronize()
        out["fp8_load_s"] = time.perf_counter() - t0
        out["fp8_byte_share"] = fp8_byte_share(pipe.transformer)
        out["fp8_transformer_bytes"] = sum(
            p.numel() * p.element_size() for p in pipe.transformer.parameters())
        fp8 = run("loader_fp8", pipe)  # checks finite, changing latents
        out["fp8_latents_cosine_to_bf16"] = _cosine(fp8["latents"], ref)
        # the quantized block linears, each filled from the file on the
        # card: W8A8, and packed int4 computing as W4A8 (the default)
        for mode, kw in (("int8", {"int8_linears": True}),
                         ("w4a8", {"int4_weights": True})):
            del pipe
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipe = load_pipeline(root, **kw)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            load_peak = torch.cuda.max_memory_allocated() / 2**30
            line, lat = path_run(f"loader_{mode}", lambda: latent_request(
                "loader", mode, pipe, seed + 1, LOADER_STEPS,
                LOADER_LAUNCHES["K1"]),
                dict(dict.fromkeys(COUNTERS, 0), **LOADER_LAUNCHES),
                quant_launches(cfg, mode, LOADER_STEPS))
            line.update(load_s=load_s, load_peak_gib=load_peak,
                        linear_quant=pipe.transformer.cfg.linear_quant,
                        transformer_bytes=module_bytes(pipe.transformer),
                        latents_cosine_to_bf16=_cosine(lat, ref))
            emit(line)
            if not line["latents_changed_every_step"] or \
                    line["linear_quant"] != mode:
                raise AssertionError(f"loader {mode}: {line}")
            out[f"{mode}_load"] = {k: line[k] for k in (
                "load_s", "load_peak_gib", "transformer_bytes",
                "latents_cosine_to_bf16")}
    out.update(bound=LOADER_BOUND, ok=True)
    emit(out)
    del pipe
    torch.cuda.empty_cache()
    return out


TEXT_ENCODES = 5


def phase_text(seed):
    """The full Qwen2-VL-7B text tower (27 of its 28 layers, bf16, random
    weights built on meta and filled on the card) encodes a CFG pair of
    TEXT_LEN right-padded token ids (positive ~40 valid tokens, negative
    ~10); then it is freed, as the reference's offload frees it. Returns
    the (positive, negative) embeddings."""
    cfg = Qwen2Config()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tower = Qwen2TextEncoder(cfg, device="meta").to_empty(device=DEVICE)
    init_random_(tower, torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    enc = QwenVLTextEncoder(tower, max_length=TEXT_LEN)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (2, TEXT_LEN), generator=gen)
    valid = torch.tensor([[40], [10]])
    mask = (torch.arange(TEXT_LEN)[None] < valid).long()
    ids = torch.where(mask.bool(), ids, 151643)  # Qwen2's pad id, right side
    emb, _ = enc.encode_ids(ids, mask)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(TEXT_ENCODES):
        t0 = time.perf_counter()
        emb, _ = enc.encode_ids(ids, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n_params = sum(p.numel() for p in tower.parameters())
    layer_params = sum(p.numel() for p in tower.layers.parameters())
    linear_flops = 2 * layer_params * ids.numel()
    finite = bool(torch.isfinite(emb).all())
    out = {"phase": "text", "layers": len(tower.layers),
           "config": dataclasses.asdict(cfg), "params": n_params,
           "tower_bytes": sum(p.numel() * p.element_size()
                              for p in tower.parameters()),
           "batch": list(ids.shape), "valid_tokens": valid.flatten().tolist(),
           "build_s": build_s, "text_encode_s": sum(times) / len(times),
           "text_encode_s_each": times,
           "linear_tflops": linear_flops / (sum(times) / len(times)) / 1e12,
           "peak_gib_above_resident": (torch.cuda.max_memory_allocated()
                                       - base) / 2 ** 30,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "embeds_shape": list(emb.shape), "embeds_finite": finite,
           "embeds_std_valid": [emb[i, :v].float().std().item()
                                for i, v in enumerate(valid.flatten())]}
    del enc, tower
    torch.cuda.empty_cache()
    out["after_free_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    emit(out)
    if not finite or tuple(emb.shape) != (2, TEXT_LEN, cfg.hidden_size):
        raise AssertionError(f"text: embeddings {tuple(emb.shape)}, finite "
                             f"{finite}")
    return emb[:1], emb[1:]


def phase_v5_text(seed):
    """V5's two prompt towers at their published widths (V5_BERT: hidden
    1024 x 24 layers; V5_T5, mT5-XL's encoder: d_model 2048 x 24 blocks),
    float32 as the port runs them (TF32 off), random weights built on meta
    and filled on the card, each encode a CFG pair of right-padded token
    ids (Bert BERT_LEN, mT5 TEXT_LEN; positive ~40 valid tokens, negative
    10); then both are freed before the denoise. Returns ((Bert positive,
    negative), (mT5 positive, negative))."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out, embeds, ok = {"phase": "v5_text"}, [], True
    for name, cls, enc_cls, cfg, length, dim in (
            ("bert", BertModel, BertTextEncoder, V5_BERT, BERT_LEN,
             V5_BERT.hidden_size),
            ("mt5", MT5EncoderModel, MT5TextEncoder, V5_T5, TEXT_LEN,
             V5_T5.d_model)):
        t0 = time.perf_counter()
        tower = init_random_(cls(cfg, device="meta").to_empty(device=DEVICE),
                             gen)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        enc = enc_cls(tower, max_length=length)
        g = torch.Generator().manual_seed(seed)
        valid = torch.tensor([[min(40, length)], [10]])
        mask = (torch.arange(length)[None] < valid).long()
        ids = torch.randint(1, cfg.vocab_size, (2, length), generator=g) * mask
        emb, _ = enc.encode_ids(ids, mask)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(TEXT_ENCODES):
            t0 = time.perf_counter()
            emb, _ = enc.encode_ids(ids, mask)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        blocks = tower.encoder.layer if name == "bert" else tower.encoder.block
        block_params = sum(p.numel() for p in blocks.parameters())
        finite = bool(torch.isfinite(emb).all())
        mean_s = sum(times) / len(times)
        out[name] = {
            "config": dataclasses.asdict(cfg),
            "params": sum(p.numel() for p in tower.parameters()),
            "bytes": sum(p.numel() * p.element_size()
                         for p in tower.parameters()),
            "batch": list(ids.shape), "valid_tokens": valid.flatten().tolist(),
            "build_s": build_s, "encode_ms": mean_s * 1e3,
            "encode_ms_each": [t * 1e3 for t in times],
            # the block linears' products, float32 without TF32
            "linear_tflops": 2 * block_params * ids.numel() / mean_s / 1e12,
            "embeds_shape": list(emb.shape), "embeds_finite": finite}
        ok = ok and finite and tuple(emb.shape) == (2, length, dim)
        embeds.append((emb[:1].clone(), emb[1:].clone()))
        del enc, tower, emb
    out["pair_ms"] = out["bert"]["encode_ms"] + out["mt5"]["encode_ms"]
    out["peak_gib_above_resident"] = (torch.cuda.max_memory_allocated()
                                      - base) / 2 ** 30
    torch.cuda.empty_cache()
    out["after_free_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    emit(out)
    if not ok:
        raise AssertionError(f"v5_text: embeddings {out}")
    return embeds


def after_norm_ms(cfg):
    """ms a CFG step spends in V5's after_norm (each block's float32
    LayerNorm of its video and text FFN outputs, models/blocks.py), timed
    with CUDA events on random bf16 tensors of the request's shapes: what
    V5's step adds beside its 77 more text tokens."""
    dev, dim = DEVICE, cfg.inner_dim
    n_vid = ((FRAMES - 1) // 4 + 1) * (H // 16) * (W // 16)
    w = torch.ones(dim, dtype=torch.bfloat16, device=dev)
    b = torch.zeros_like(w)
    per = {}
    for name, n in (("vid", n_vid), ("txt", BERT_LEN + TEXT_LEN)):
        x = torch.randn(2, n, dim, device=dev).to(torch.bfloat16)
        per[name] = cuda_ms(lambda: fp32_layer_norm(x, w, b, cfg.norm_eps), 10)
    return {"ms_per_call": per,
            "ms_per_step": cfg.num_layers * (per["vid"] + per["txt"])}


def v5_variant(model, seed):
    """The V5 12B (PRESETS["v5-12b"]: the V5 yaml's text streams over the
    V5.1 12B's widths) on the resident 12B's tensors, as swa_variant does;
    what V5 adds (text_proj with its RMS norm at the Bert's 1024,
    text_proj_t5 at mT5's 2048, each block's after_norm norm3) is filled on
    the card from `seed`."""
    v5 = EasyAnimateTransformer3D(PRESETS["v5-12b"], device="meta")
    own = v5.state_dict()
    shared = {k: t for k, t in model.state_dict().items()
              if k in own and own[k].shape == t.shape}
    v5.load_state_dict(shared, strict=False, assign=True)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    new = [v5.text_proj, v5.text_proj_t5,
           *(blk.norm3 for blk in v5.transformer_blocks)]
    for mod in new:
        init_random_(mod.to_empty(device=DEVICE), gen)
    if any(t.is_meta for t in v5.state_dict().values()):
        raise AssertionError("v5_variant: a tensor is left unfilled")
    return v5


def inpaint_variant(model, seed):
    """V5.1-12B-InP on the dense 12B's tensors (load_state_dict with
    assign=True shares them; a second 23.6 GB copy would not fit beside the
    activations) and a random proj.weight with 16 + 1 + 16 input channels."""
    inpaint = EasyAnimateTransformer3D(PRESETS["v5.1-12b-inpaint"],
                                       device="meta")
    shape = inpaint.proj.weight.shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sd = dict(model.state_dict())
    sd["proj.weight"] = (torch.randn(shape, generator=gen, device=DEVICE)
                         * shape[1:].numel() ** -0.5).to(torch.bfloat16)
    inpaint.load_state_dict(sd, assign=True)
    return inpaint


def i2v_inputs(seed):
    """A random uint8 start frame at the sample size (so no resize) through
    get_image_to_video_latent: video (1, 3, 49, H, W) in [0, 1] and the mask
    of the frames to generate."""
    gen = torch.Generator().manual_seed(seed)
    image = torch.randint(0, 256, (H, W, 3), generator=gen,
                          dtype=torch.uint8).numpy()
    video, mask = get_image_to_video_latent(image, None, FRAMES, (H, W))
    return {"video": video, "mask_video": mask}


def v4_models(seed):
    """V4's HunyuanDiT at full width and depth: HunyuanConfig's defaults
    (40 layers, 16 x 88 heads, Bert 1,024 x 77 and mT5 2,048 x 256, pooled
    1,024, learned sigma) plus the V4 yaml's fields (basic blocks,
    time_position_encoding; the card has no yaml reader, so they are
    written here), random bf16 weights built on meta and filled on the
    card; and the V4 yaml's MagViT (slice_mag, mini_batch 8 / 2) with
    latent_channels 4, the transformer's in_channels (the yaml leaves it
    unset and MagvitVAEConfig's 16 is V5's)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    cfg = HunyuanConfig(basic_block_type="basic", time_position_encoding=True)
    model = init_random_(HunyuanTransformer3D(cfg, device="meta").to_empty(
        device=DEVICE), gen)
    vae = init_random_(AutoencoderKLMagvit(
        MagvitVAEConfig(latent_channels=4, chunk_mode="slice_mag",
                        mini_batch_encoder=8, mini_batch_decoder=2,
                        dtype="bfloat16"), device="meta").to_empty(
        device=DEVICE), gen)
    torch.cuda.synchronize()
    emit({"phase": "v4_build", "params": sum(p.numel()
                                             for p in model.parameters()),
          "bytes": sum(p.numel() * p.element_size()
                       for p in model.parameters()),
          "vae_params": sum(p.numel() for p in vae.parameters()),
          "seconds": time.perf_counter() - t0})
    return model, vae


def v4_inpaint_variant(model, seed):
    """V4's InP transformer (in_channels 4 + 4 + 4: latents, the
    VAE-encoded mask, the masked video; out_channels 8) on the T2V model's
    tensors, with a random 12-channel patchify."""
    cfg = dataclasses.replace(model.cfg, in_channels=12, out_channels=8)
    inpaint = HunyuanTransformer3D(cfg, device="meta")
    shape = inpaint.pos_embed_proj.weight.shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sd = dict(model.state_dict())
    sd["pos_embed_proj.weight"] = (
        torch.randn(shape, generator=gen, device=DEVICE)
        * shape[1:].numel() ** -0.5).to(torch.bfloat16)
    inpaint.load_state_dict(sd, assign=True)
    return inpaint


def v4_request(phase, pipe, seed, steps, **inputs):
    """One V4 request at V4_H x V4_W x V4_FRAMES, CFG 6.0, DDIM, on random
    Bert [2, 77, 1024] and mT5 [2, 256, 2048] prompt embeddings (the towers
    are v5_text's: this bypasses them). T2V decodes (tiled at 512 px, so
    without smoothing, as in JAX); I2V (`inputs`: the start frame, the CLIP
    states) returns latents. Stamps each step, the transformer's first call
    (so an I2V's VAE encodes stand apart) and, through a pre-hook, whether
    each evaluation saw non-zero CLIP states."""
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = {k: torch.randn(2, n, w, generator=gen, device=dev)
           for k, n, w in (("bert", BERT_LEN, 1024), ("t5", TEXT_LEN, 2048))}
    lat0 = torch.randn(pipe.latent_shape(1, V4_FRAMES, V4_H, V4_W),
                       generator=gen, device=dev)
    stamps, calls = [], []
    prev = [lat0.to(pipe.transformer.cfg.torch_dtype)]

    def pre_hook(module, args, kwargs):
        if not calls:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        clip = kwargs.get("clip_encoder_hidden_states")
        calls.append(None if clip is None else bool(clip.abs().amax() > 0))

    def check_step(i, lat):
        if not bool(torch.isfinite(lat).all()):  # syncs: stamps are real
            raise AssertionError(f"{phase}: non-finite latents at step {i}")
        if torch.equal(prev[0], lat):
            raise AssertionError(f"{phase}: latents unchanged at step {i}")
        prev[0] = lat.clone()
        stamps.append(time.perf_counter())

    hook = pipe.transformer.register_forward_pre_hook(pre_hook,
                                                      with_kwargs=True)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = pipe(emb["bert"][:1], emb["bert"][1:],
                   prompt_embeds_t5=emb["t5"][:1],
                   negative_prompt_embeds_t5=emb["t5"][1:], height=V4_H,
                   width=V4_W, video_length=V4_FRAMES,
                   num_inference_steps=steps, guidance_scale=6.0,
                   latents=lat0, generator=gen,
                   output_type="latent" if inputs else "uint8",
                   callback=check_step, **inputs)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    t_end = time.perf_counter()
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    row = {"phase": phase, "seed": seed, "steps": steps,
           "latent_shape": list(prev[0].shape),
           "tokens": V4_TOKENS, "before_denoise_s": stamps[0] - t0,
           "denoise_s_per_step": sum(step_s) / steps, "step_s": step_s,
           "after_denoise_s": t_end - stamps[-1], "request_s": t_end - t0,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "clip_states_nonzero_per_evaluation": calls}
    if inputs:
        row.update(vae_encode_s=row["before_denoise_s"],
                   clip_apply_ratio=inputs["clip_apply_ratio"])
        ok = (tuple(out.shape) == tuple(lat0.shape)
              and bool(torch.isfinite(out).all()) and any(calls)
              and not all(calls))
    else:
        # slice_mag decodes each chunk of mini_batch_decoder latents with
        # its first frame not doubled, as JAX's does: 2 latents -> 5
        # frames, 36 -> 90
        vcfg = pipe.vae.cfg
        n = vcfg.mini_batch_decoder
        frames = (lat0.shape[2] // n
                  * (1 + (n - 1) * vcfg.temporal_compression))
        row.update(vae_decode_s=row["after_denoise_s"],
                   video_shape=list(out.shape), video_dtype=str(out.dtype))
        ok = (out.shape == (1, 3, frames, V4_H, V4_W)
              and out.dtype.name == "uint8")
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: output or CLIP gate wrong: {row}")


# V1-V3 (EasyAnimateV1-V3's Transformer3D: 28 layers of 16 heads x 72, the
# T5-XXL caption width 4,096, learned sigma) at 512x512 on random T5
# embeddings [2, LEGACY_TEXT_LEN, 4096] (the tower is cut): V2 and V3 take
# 144 frames through slice_mag (36 latents of 32 x 32 patches, 36,864
# tokens); V1 16 frames (the smoke's choice) through its 2D VAE, one latent
# a frame; PixArt one 512x512 image
LEGACY_H = LEGACY_W = 512
LEGACY_TEXT_LEN, LEGACY_CAPTION = 120, 4096
LEGACY_FRAMES = {"v3": 144, "v2": 144, "v1": 16, "pixart": 1}
LEGACY_HEADS, LEGACY_HEAD_DIM = 16, 72
LEGACY_TOKENS = 36 * (LEGACY_H // 16) * (LEGACY_W // 16)
_TS, _GS = "Temporal_Self", "Global_Self"
_MM = dict(num_transformer_block=1, temporal_position_encoding=True)
# the yamls' transformer_additional_kwargs and vae_kwargs
# (config/easyanimate_video_v{1,2,3}_*.yaml; the card has no yaml reader,
# so they are written here and go through utils/config.py's builders)
LEGACY_YAML = {
    "v1": ({"transformer_type": "Transformer3DModel",
            "basic_block_type": "motionmodule",
            "motion_module_type": "VanillaGrid",
            "motion_module_kwargs": dict(
                _MM, num_attention_heads=8, attention_block_types=[_TS, _TS],
                block_size=2)},
           {"vae_type": "AutoencoderKL"}),
    "v2": ({"transformer_type": "Transformer3DModel",
            "basic_block_type": "motionmodule", "enable_uvit": True,
            "motion_module_type": "Vanilla",
            "motion_module_kwargs": dict(
                _MM, num_attention_heads=8, attention_block_types=[_TS, _TS],
                block_size=1)},
           {"vae_type": "AutoencoderKLMagvit", "chunk_mode": "slice_mag",
            "mini_batch_encoder": 9, "mini_batch_decoder": 3}),
    "v3": ({"transformer_type": "Transformer3DModel",
            "basic_block_type": "global_motionmodule", "enable_uvit": True,
            "motion_module_type": "Vanilla",
            "motion_module_kwargs_even": dict(
                _MM, num_attention_heads=16, attention_block_types=[_TS, _TS]),
            "motion_module_kwargs_odd": dict(
                _MM, num_attention_heads=16, attention_block_types=[_TS, _GS])},
           {"vae_type": "AutoencoderKLMagvit", "mini_batch_encoder": 8,
            "mini_batch_decoder": 2, "chunk_mode": "slice_mag"}),
}
# K1 launches per CFG evaluation by head dim, and by head dim those that
# attend over at most 64 q and kv rows (the short-head kernel): each
# layer's spatial and text passes (d 72, 1,024 and 36,864 or 16,384 q rows,
# flash_fwd_d72_sm90); V3's motion modules at 16 heads (d 72): 2
# Temporal_Self passes over 36 frames on even layers, Temporal_Self +
# Global_Self (36,864 q rows) on odd ones; V2's at 8 heads (d 144): 2
# Temporal_Self passes over 36 frames; V1's the same over a 2 x 2 cell's 4
# x 16 = 64 tokens; PixArt's basic blocks none
LEGACY_K1 = {"v3": ({72: 112}, {72: 42}), "v2": ({72: 56, 144: 56}, {144: 56}),
             "v1": ({72: 56, 144: 56}, {144: 56}), "pixart": ({72: 56}, {})}
# K1's V1-V3 shapes, each over the CFG batch: (name, d, b*h, sq, skv)
LEGACY_K1_CASES = (
    ("K1@72 Global_Self", 72, 2 * LEGACY_HEADS, LEGACY_TOKENS, LEGACY_TOKENS),
    ("K1@72 spatial", 72, 2 * 36 * LEGACY_HEADS, 1024, 1024),
    ("K1@72 text", 72, 2 * LEGACY_HEADS, LEGACY_TOKENS, LEGACY_TEXT_LEN),
    ("K1@72 temporal", 72, 2 * 1024 * LEGACY_HEADS, 36, 36),
    ("K1@144 V2 temporal", 144, 2 * 1024 * 8, 36, 36),
    ("K1@144 V1 grid", 144, 2 * 256 * 8, 64, 64))
# V3's temporal pass at its published 768 x 768: b*h = 2 * 48^2 * 16, past
# gridDim.y's 65,535
LEGACY_BIG_BH = 2 * 48 * 48 * LEGACY_HEADS


def k1_route(d, sq, skv):
    """Which kernel ea_flash_fwd_bf16 runs for these shapes at d 72 or
    144: "short" (flash_fwd_short_sm90), "sm90" (flash_fwd_d72_sm90's
    persistent walk) or "mma" (the mma.sync body, d 144 only)."""
    lib = _build.load_library()
    if lib.ea_flash_fwd_uses_short(d, sq, skv):
        return "short"
    return "sm90" if lib.ea_flash_fwd_uses_sm90(d, sq, skv) else "mma"


def phase_kernels_legacy(gen):
    """K1 at head dims 72 (flash_fwd_short_sm90 on fwd_short_sm90.cuh at
    most 64 q and kv rows, csrc/flash_fwd.cu::flash_fwd_d72_sm90's walk on
    fwd_split_sm90.cuh past them) and 144 (flash_fwd_short_sm90 at most 64
    q and kv rows, the mma.sync body of attn_fwd.cuh past them) against
    its plain version at the V1-V3 shapes of LEGACY_K1_CASES, with the
    route each ran and kernel / plain / SDPA (yardstick) times and bounds;
    then at b*h = LEGACY_BIG_BH, on 36-row heads over 100 kv rows (the
    walk) and on 12 ragged heads. Returns the K1@72 and K1@144 stats."""
    dev = DEVICE

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    stats = {72: {"shapes": {}, "errs": []}, 144: {"shapes": {}, "errs": []}}
    for name, d, bh, sq, skv in LEGACY_K1_CASES:
        q = rand(bh, sq, d, scale=d ** -0.5 * LOG2E)
        k, v = rand(bh, skv, d), rand(bh, skv, d)
        st = stats[d]
        st["errs"].append(_compare(f"{name} {list(q.shape)} x {skv}",
                                   flash_attention_fwd, flash_attention_plain,
                                   (q, k, v, skv)))
        heads = LEGACY_HEADS if d == 72 else 8
        q4, k4, v4 = (x.view(bh // heads, heads, -1, d) for x in (q, k, v))
        bms, by = k1_bound(bh, sq, skv, d)
        long = sq * skv > 1e8
        sdpa, sdpa_error = library_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4),
            5 if long else 20)
        row = {"shape": [[bh, sq, d], [bh, skv, d]],
               "ms": cuda_ms(lambda: flash_attention_fwd(q, k, v),
                             5 if long else 20),
               "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v), 2),
               "sdpa_ms": sdpa, "bound_ms": bms, "bound_by": by,
               "route": k1_route(d, sq, skv)}
        if sdpa_error:
            row["sdpa_error"] = sdpa_error
        row["share_of_bound"] = bms / row["ms"]
        st["shapes"][name] = row
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    # b*h past 65,535 (the q blocks and b*h folded into blockIdx.x), each
    # head offset by its own mean: a block that read or wrote another
    # head's rows would show
    shift = torch.arange(LEGACY_BIG_BH, device=dev).view(-1, 1, 1) % 5 - 2.0
    q = rand(LEGACY_BIG_BH, 36, 72, scale=72 ** -0.5 * LOG2E)
    k, v = ((rand(LEGACY_BIG_BH, 36, 72).float() + shift).to(torch.bfloat16)
            for _ in range(2))
    stats[72]["errs"].append(_compare(f"K1@72 b*h {LEGACY_BIG_BH}",
                                      flash_attention_fwd,
                                      flash_attention_plain, (q, k, v, 36)))
    stats[72]["big_bh_ms"] = cuda_ms(lambda: flash_attention_fwd(q, k, v), 20)
    stats[72]["big_bh_route"] = k1_route(72, 36, 36)
    del q, k, v, shift
    # at most 64 q rows over more than 64 kv rows: d 72's walk, its q block
    # mostly TMA's zero rows past sq
    q = rand(4096, 36, 72, scale=72 ** -0.5 * LOG2E)
    k, v = rand(4096, 100, 72), rand(4096, 100, 72)
    stats[72]["errs"].append(_compare("K1@72 [4096, 36, 72] x 100",
                                      flash_attention_fwd,
                                      flash_attention_plain, (q, k, v, 100)))
    stats[72]["short_q_long_kv_route"] = k1_route(72, 36, 100)
    if stats[72]["short_q_long_kv_route"] != "sm90":
        raise AssertionError("K1@72 [4096, 36, 72] x 100 did not run "
                             f"{K1_D72_SM90}")
    del q, k, v
    # 12 heads of 1001 rows (not a multiple of the 192-row q blocks or the
    # 96-row kv tiles), each head offset by its own mean: columns 72-79
    # read from the next row would show
    shift = torch.arange(12, device=dev).view(12, 1, 1) % 3 - 1.0
    for d in (72, 144):
        qh = rand(12, 1001, d, scale=d ** -0.5 * LOG2E)
        kh, vh = ((rand(12, 1001, d).float() + shift).to(torch.bfloat16)
                  for _ in range(2))
        stats[d]["errs"].append(_compare(f"K1@{d} ragged heads 1001",
                                         flash_attention_fwd,
                                         flash_attention_plain,
                                         (qh, kh, vh, 1001)))
    for d, st in stats.items():
        errs = st.pop("errs")
        st.update(max_abs_err=max(e[0] for e in errs),
                  max_rel_err=max(e[1] for e in errs))
        emit({"phase": "kernels", "case": f"K1@{d} times", **st,
              "note": "sdpa_ms is a yardstick, not on the path; route: the "
                      "kernel the shape ran (short: flash_fwd_short_sm90, "
                      "sm90: flash_fwd_d72_sm90, mma: the mma.sync body)"})
    torch.cuda.empty_cache()
    return stats


def _tiny_legacy_models(dtype):
    """Tiny V1-V3 Transformer3D at the kernels' new head dims (2 heads x
    72; global motion modules, 1 head of 144 on the even layer and 2 of 72
    on the odd one; caption width 24) and the reference's 4-block MagViT,
    random float32 weights from a fixed seed, cast to dtype."""
    cfg = Transformer3DConfig(
        num_attention_heads=2, attention_head_dim=72, num_layers=2,
        caption_channels=24, dtype="float32",
        motion_module_even=MotionModuleConfig(num_attention_heads=1),
        motion_module_odd=MotionModuleConfig(
            num_attention_heads=2, attention_block_types=(_TS, _GS)))
    vae_cfg = MagvitVAEConfig(latent_channels=4,
                              block_out_channels=(32, 64, 128, 128),
                              norm_num_groups=8, decode_chunk_frames=4)
    gen = torch.Generator().manual_seed(7)
    models = (init_random_(Transformer3D(cfg, device="cpu"), gen),
              init_random_(AutoencoderKLMagvit(vae_cfg, device="cpu"), gen))
    if dtype == "float32":
        return models
    cast = (Transformer3D(dataclasses.replace(cfg, dtype=dtype), device="cpu"),
            AutoencoderKLMagvit(dataclasses.replace(vae_cfg, dtype=dtype),
                                device="cpu"))
    for dst, src in zip(cast, models):
        dst.load_state_dict(src.state_dict())
    return cast


def legacy_models(edition, seed):
    """The V1-V3 (or PixArt's) model at full width and depth from its yaml's
    fields (LEGACY_YAML) through build_transformer and build_vae, random
    bf16 weights built on meta and filled on the card. V2's and V3's
    MagViT take latent_channels 4, the transformer's in_channels (the
    yamls leave it unset and MagvitVAEConfig's 16 is V5's). PixArt:
    Transformer2D over the V3 yaml's fields, and the V3 yaml's MagViT in
    the cache_mag protocol: slice_mag maps one frame to 0 latents (as in
    JAX), and JAX's PixArt runs over a cache_mag MagViT."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    t_kw, v_kw = LEGACY_YAML["v3" if edition == "pixart" else edition]
    model, cfg = tconfig.build_transformer(t_kw, dtype="bfloat16",
                                           device="meta")
    if edition == "pixart":
        model = Transformer2D(cfg, device="meta")
        v_kw = dict(v_kw, chunk_mode="cache_mag")
    extra = {} if v_kw["vae_type"] == "AutoencoderKL" else {"latent_channels": 4}
    vae, _ = tconfig.build_vae(v_kw, dtype="bfloat16", device="meta", **extra)
    model = init_random_(model.to_empty(device=DEVICE), gen)
    vae = init_random_(vae.to_empty(device=DEVICE), gen)
    torch.cuda.synchronize()
    emit({"phase": f"{edition}_build", "params": sum(
        p.numel() for p in model.parameters()),
          "bytes": sum(p.numel() * p.element_size()
                       for p in model.parameters()),
          "vae": type(vae).__name__, "vae_chunk_mode": vae.cfg.chunk_mode,
          "vae_params": sum(p.numel() for p in vae.parameters()),
          "seconds": time.perf_counter() - t0})
    return model, vae


def legacy_request(phase, pipe, seed, steps, frames):
    """One V1-V3 T2V (or PixArt T2I) request at LEGACY_H x LEGACY_W, CFG
    6.0, DDIM, on random T5 embeddings [2, LEGACY_TEXT_LEN, 4096] (the
    T5-XXL tower is cut), decoded to uint8: s/step, decode s, peak; checks
    each step's latents and the output's shape."""
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn(2, LEGACY_TEXT_LEN, LEGACY_CAPTION, generator=gen,
                      device=dev)
    image = isinstance(pipe, PixArtMagvitPipeline)
    shape = pipe.latent_shape(1, frames, LEGACY_H, LEGACY_W)
    lat0 = torch.randn(shape, generator=gen, device=dev)
    stamps, calls = [], []
    prev = [lat0.to(pipe.transformer.cfg.torch_dtype)]

    def pre_hook(module, args):
        if not calls:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        calls.append(1)

    def check_step(i, lat):
        if not bool(torch.isfinite(lat).all()):  # syncs: stamps are real
            raise AssertionError(f"{phase}: non-finite latents at step {i}")
        if torch.equal(prev[0], lat):
            raise AssertionError(f"{phase}: latents unchanged at step {i}")
        prev[0] = lat.clone()
        stamps.append(time.perf_counter())

    hook = pipe.transformer.register_forward_pre_hook(pre_hook)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = pipe(emb[:1], emb[1:], height=LEGACY_H, width=LEGACY_W,
                   **({} if image else {"video_length": frames}),
                   num_inference_steps=steps, guidance_scale=6.0,
                   latents=lat0, generator=gen, output_type="uint8",
                   callback=check_step)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    t_end = time.perf_counter()
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    p = pipe.transformer.cfg.patch_size
    vcfg = pipe.vae.cfg
    if image:
        want = (1, 3, LEGACY_H, LEGACY_W)
    elif vcfg.chunk_mode == "slice_mag":  # 1 + (n - 1) * tc frames a chunk
        n, t = vcfg.mini_batch_decoder, shape[2]
        want = (1, 3, sum(1 + (min(n, t - i) - 1) * vcfg.temporal_compression
                          for i in range(0, t, n)), LEGACY_H, LEGACY_W)
    else:  # V1's 2D VAE: one frame a latent
        want = (1, 3, frames, LEGACY_H, LEGACY_W)
    row = {"phase": phase, "seed": seed, "steps": steps,
           "latent_shape": list(shape),
           "tokens": shape[2] * (shape[3] // p) * (shape[4] // p),
           "evaluations": len(calls), "before_denoise_s": stamps[0] - t0,
           "denoise_s_per_step": sum(step_s) / steps, "step_s": step_s,
           "vae_decode_s": t_end - stamps[-1], "request_s": t_end - t0,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "vae": type(pipe.vae).__name__,
           "output_shape": list(out.shape), "output_dtype": str(out.dtype)}
    ok = tuple(out.shape) == want and out.dtype.name == "uint8"
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: output {out.shape} {out.dtype}, "
                             f"expected {want} uint8")


# the control and samplers phases' steps (PNDM's: min(--steps, 4)); with
# 4 the whole run took 357 s on an H100 against a ~330 s budget
NEW_PHASE_STEPS = 2
# control: the V5.1 Control models on the 12B's tensors
CONTROL_IDENTITY_STEPS = 2
# max |control - t2v| / max |t2v| of the identity check's final bf16
# latents: the 48-channel proj with zeros on the control channels computes
# the T2V patchify with another reduction length, so the two runs may
# differ in the last bits; a wrong concat order or channel count puts the
# 12B's weights on control channels and moves the latents by O(1)
CONTROL_IDENTITY_BOUND = 1e-2
# max |Euler - DDIM| / max |DDIM| of the samplers phase's final latents:
# in float32 the two agree to 5e-5 (tests/test_samplers.py
# test_euler_equals_ddim_exactly); in bf16 Euler's sigma-space latents and
# its scaled model input round differently, and 4 CFG-6 steps of random
# weights amplify that. The phase measures the floor of that rounding: DDIM
# again from the noise scaled by 1 + 2^-8 (about one bf16 rounding of the
# first latents). The check holds Euler within the larger of this bound
# and twice that floor; a missing scale_model_input or a wrong sigma
# schedule gives O(1)
EULER_DDIM_BOUND = 5e-2
# the floor's perturbation of the initial noise
ULP_NOISE_SCALE = 1.0 + 2.0 ** -8
SAMPLERS = ("DDIM", "Euler", "Euler A", "DPM++", "PNDM")


def control_variant(model, seed, in_channels, proj_weight=None,
                    swa_layers=None):
    """A V5.1 Control model on the dense 12B's tensors (assign=True shares
    them): proj.weight with `in_channels` inputs (16 latents + 16 control
    video or 6 camera + 16 reference), random unless given, and a random
    ref_proj (add_ref_latent_in_control_model, the published Control
    configs' setting)."""
    cfg = dataclasses.replace(model.cfg, in_channels=in_channels,
                              add_ref_latent_in_control_model=True,
                              swa_layers=swa_layers)
    control = EasyAnimateTransformer3D(cfg, device="meta")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sd = dict(model.state_dict())
    for name in ("proj.weight", "ref_proj.weight"):
        shape = control.state_dict()[name].shape
        sd[name] = (torch.randn(shape, generator=gen, device=DEVICE)
                    * shape[1:].numel() ** -0.5).to(model.proj.weight.dtype)
    sd["ref_proj.bias"] = torch.zeros_like(model.proj.bias)
    if proj_weight is not None:
        sd["proj.weight"] = proj_weight
    control.load_state_dict(sd, assign=True)
    return control


def control_inputs(seed):
    """A random uint8 control clip and reference image at the sample size
    through get_video_to_video_latent (no resize, so no PIL): control_video
    (1, 3, 49, H, W) and ref_image (1, 3, 1, H, W) in [0, 1]."""
    gen = torch.Generator().manual_seed(seed)
    clip = torch.randint(0, 256, (FRAMES, H, W, 3), generator=gen,
                         dtype=torch.uint8).numpy()
    video, _ = get_video_to_video_latent(clip, FRAMES, (H, W))
    ref, _ = get_video_to_video_latent(clip[FRAMES // 2:FRAMES // 2 + 1], 1,
                                       (H, W))
    return {"control_video": video, "ref_image": ref}


def write_pose_file(path, n):
    """A RealEstate10K-format trajectory of n frames: a forward dolly with
    a slow yaw (0.01 rad a frame), the published Control-Camera
    intrinsics' form (normalized fx, fy, cx, cy)."""
    with open(path, "w") as f:
        f.write("chip_smoke: forward dolly with a slow yaw\n")
        for i in range(n):
            yaw = 0.01 * i
            rot = np.array([[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0],
                            [-np.sin(yaw), 0.0, np.cos(yaw)]])
            w2c = np.concatenate([rot, [[0.0], [0.0], [-0.04 * i]]], axis=1)
            row = [i, 0.474812461, 0.844111024, 0.5, 0.5, 0, 0,
                   *w2c.reshape(-1)]
            f.write(" ".join(f"{float(x):.9f}" for x in row) + "\n")


def latent_request(phase, name, pipe, seed, steps, expect_k1,
                   noise_scale=1.0, **kw):
    """One latent-only request to `pipe` from seeded noise (times
    `noise_scale`) and prompt embeddings: each step stamped after a sync,
    the latents checked finite, K1's launches held to `expect_k1`. Returns
    (JSON line, latents)."""
    dev, k1 = pipe.device, COUNTERS["K1"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = 0.02 * torch.randn(1, TEXT_LEN, pipe.transformer.cfg.text_embed_dim,
                             generator=gen, device=dev)
    lat0 = torch.randn(pipe.latent_shape(1, FRAMES, H, W), generator=gen,
                       device=dev) * noise_scale
    stamps, prev, changed = [], [lat0], []

    def stamp(i, lat):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        changed.append(not torch.equal(lat, prev[0]))
        prev[0] = lat.clone()

    before = k1.launches
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = pipe(pos, torch.zeros_like(pos), height=H, width=W,
               video_length=FRAMES, num_inference_steps=steps,
               guidance_scale=6.0, latents=lat0, generator=gen,
               output_type="latent", callback=stamp, **kw)
    torch.cuda.synchronize()
    step_s = [b - a for a, b in zip([t0] + stamps, stamps)]
    out = {"phase": phase, "request": name, "steps": steps,
           "evaluations": len(stamps), "step_s": step_s,
           "s_per_step_after_first": (sum(step_s[1:]) / (len(step_s) - 1)
                                      if len(step_s) > 1 else None),
           "request_s": time.perf_counter() - t0,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "K1": k1.launches - before, "expect_k1": expect_k1,
           "latents_finite": bool(torch.isfinite(lat).all()),
           "latents_changed_every_step": all(changed),
           "latents_max_abs": lat.float().abs().max().item()}
    if out["K1"] != expect_k1 or not out["latents_finite"]:
        emit(out)
        raise AssertionError(f"{phase} {name}: K1 {out['K1']} != "
                             f"{expect_k1} or non-finite latents")
    return out, lat


def phase_control(model, vae, seed, steps):
    """V5.1-12B-Control on the 12B's tensors: a control clip + reference
    image request (both VAE encodes timed apart) and the identity check;
    then the Control-Camera SWA variant on a 49-pose trajectory read back
    through plucker_from_file (no reference: the zeros branch)."""
    encode_s = []

    def timed_encode(vae_, x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vae_encode(vae_, x)
        torch.cuda.synchronize()
        encode_s.append({"frames": x.shape[2], "s": time.perf_counter() - t0})
        return out

    ins = control_inputs(seed)
    pipe = EasyAnimateControlPipeline(control_variant(model, seed + 1, 48),
                                      vae)
    control_module.vae_encode = timed_encode
    try:
        res = request("control", pipe, seed + 2, steps, COUNTERS, **ins)
    finally:
        control_module.vae_encode = vae_encode
    if res["launched"]["K1"] != 48 * steps or res["launched"]["K2"]:
        raise AssertionError(f"control: launches {res['launched']}")
    emit({"phase": "control", "request": "video+ref encodes",
          "control_clip_encode_s": encode_s[0]["s"],
          "reference_encode_s": encode_s[1]["s"],
          "encodes": encode_s})
    del res

    # identity: the 12B's proj on the first 16 input channels, zeros on
    # the 32 control + reference channels, against the T2V pipeline
    n = CONTROL_IDENTITY_STEPS
    w = model.proj.weight
    ident = torch.cat([w, torch.zeros(w.shape[0], 32, *w.shape[2:],
                                      dtype=w.dtype, device=w.device)], dim=1)
    pipe = EasyAnimateControlPipeline(
        control_variant(model, seed + 1, 48, proj_weight=ident), vae)
    out_c, lat_c = latent_request("control", "identity_control", pipe,
                                  seed + 3, n, 48 * n, **ins)
    out_t, lat_t = latent_request("control", "identity_t2v",
                                  EasyAnimatePipeline(model, vae), seed + 3,
                                  n, 48 * n)
    rel = ((lat_c.float() - lat_t.float()).abs().max()
           / lat_t.float().abs().max()).item()
    emit({"phase": "control", "request": "identity", "steps": n,
          "rel_diff_vs_t2v": rel, "bound": CONTROL_IDENTITY_BOUND,
          "control_step_s": out_c["step_s"], "t2v_step_s": out_t["step_s"]})
    if not rel <= CONTROL_IDENTITY_BOUND:
        raise AssertionError(f"control: identity off by {rel}")
    del pipe, lat_c, lat_t, ident, ins

    # Control-Camera on the SWA variant: 16 latents + 6 Plücker + 16
    # reference channels, no reference image
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poses.txt")
        write_pose_file(path, FRAMES)
        t0 = time.perf_counter()
        rays = plucker_from_file(path, H, W)
        plucker_s = time.perf_counter() - t0
    camera = np.ascontiguousarray(rays.transpose(3, 0, 1, 2)[None])
    if camera.shape != (1, 6, FRAMES, H, W) or not np.isfinite(camera).all():
        raise AssertionError(f"control: Plücker video {camera.shape}")
    pipe = EasyAnimateControlPipeline(control_variant(
        model, seed + 4, 38, swa_layers=tuple(range(1, 48))), vae)
    res = request("control_camera", pipe, seed + 5, steps, COUNTERS,
                  control_camera_video=camera)
    emit({"phase": "control_camera", "plucker_host_s": plucker_s,
          "plucker_bytes": rays.nbytes, "camera_shape": list(camera.shape)})
    if res["launched"]["K1"] != 48 * steps or \
            res["launched"]["K2"] != 47 * steps:
        raise AssertionError(f"control_camera: launches {res['launched']}")
    del pipe, res, camera, rays
    torch.cuda.empty_cache()


def phase_samplers(model, vae, seed, steps, pndm_steps):
    """Flow and the five other samplers through make_scheduler with the
    12B's FlowMatch config as base, each from the same noise and prompt,
    latent output: s/step beside Flow's, K1 48 per transformer evaluation,
    finite latents, and Euler held against DDIM. PNDM runs `pndm_steps`
    (4 reach every PLMS order) and evaluates once more."""
    pipe = EasyAnimatePipeline(model, vae)
    base = pipe.scheduler
    lats, flow_step = {}, None
    for name in ("Flow",) + SAMPLERS:
        pipe.scheduler = make_scheduler(name, base=base)
        n = pndm_steps if name == "PNDM" else steps
        out, lats[name] = latent_request("samplers", name, pipe, seed, n,
                                         48 * (n + (name == "PNDM")))
        if name == "Flow":
            flow_step = out["s_per_step_after_first"]
        out.update(scheduler=type(pipe.scheduler).__name__,
                   flow_s_per_step_after_first=flow_step)
        emit(out)
    pipe.scheduler = make_scheduler("DDIM", base=base)
    out, lats["floor"] = latent_request("samplers", "DDIM, noise x (1 + "
                                        "2^-8)", pipe, seed, steps, 48 * steps,
                                        noise_scale=ULP_NOISE_SCALE)
    emit(out)
    pipe.scheduler = base
    ddim = lats["DDIM"].float()

    def rel(name):
        diff = lats[name].float() - ddim
        return ((diff.abs().max() / ddim.abs().max()).item(),
                (diff.norm() / ddim.norm()).item())

    (euler, euler_l2), (floor, floor_l2) = rel("Euler"), rel("floor")
    limit = max(EULER_DDIM_BOUND, 2 * floor)
    emit({"phase": "samplers", "request": "euler_vs_ddim",
          "rel_diff": euler, "rel_l2": euler_l2, "floor_rel_diff": floor,
          "floor_rel_l2": floor_l2, "bound": EULER_DDIM_BOUND,
          "limit": limit})
    if not euler <= limit:
        raise AssertionError(f"samplers: Euler off DDIM by {euler} (the "
                             f"bf16 floor {floor})")
    del lats, ddim, pipe
    torch.cuda.empty_cache()


# --- the quantized block linears (easyanimate_tpu_torch/ops/quant.py) ------

QCOUNTERS = {"Q1": tquant.quantize_rows, "Q2": tquant.dequantize_rows,
             "Q3": tquant.unpack_int4_weight}
# the 12B's shapes: a CFG pair of 13,104 video tokens through its block
# linears' (in, out) widths: q/k/v/out, ff.wi, ff.wo
Q_TOKENS = 2 * 13104
Q_WIDTHS = ((3072, 3072), (3072, 12288), (12288, 3072))
# float32 operations outside the tensor cores (the H100 data sheet)
PEAK_F32_FLOPS = 67e12
# JAX's guards at these shapes (tests/test_quant.py:203-236, 411-432),
# 256 tokens with 4 outlier rows at 8x
QUANT_GUARD_TOKENS = 256
INT8_COS, INT8_TOKEN_COS = 0.999, 0.995
W4A8_W4A16_COS, W4A8_FLOAT_COS = 0.999, 0.99
QUANT_MODES = ("int8", "w4a8", "int4")
QUANT_LORA_RANK = 128


def bound_f32(ops, n_bytes):
    """(least ms, what bounds it) for a pass of float32 operations outside
    the tensor cores against its bytes."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def module_bytes(module):
    """Resident bytes of a module: parameters and buffers (the quantized
    linears' int8 weights and scales are buffers)."""
    return nbytes(*module.parameters(), *module.buffers())


def bf16_ulps(a, b):
    """Largest distance between two bf16 tensors in units in the last
    place (0: equal bits)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs().max().item()


def quant_launches(cfg, mode, evaluations):
    """Q1-Q3 launches of `evaluations` transformer calls: 12 block linears
    a layer (both streams), whose q, k and v share one Q1 per stream; Q1
    and Q2 on the int8 products, Q3 on each packed int4 weight."""
    assert cfg.mmdit_layers >= cfg.num_layers  # both streams in every layer
    n = evaluations * cfg.num_layers
    int8_product, int4_weight = mode in ("int8", "w4a8"), mode != "int8"
    return {"Q1": 8 * n * int8_product, "Q2": 12 * n * int8_product,
            "Q3": 12 * n * int4_weight}


def quantized_copy(model, mode):
    """`model` with its block linears quantized to `mode` on its device:
    the other tensors are shared, each block linear is quantized as it is
    assigned (QuantLinear._load_from_state_dict)."""
    cfg = dataclasses.replace(model.cfg, linear_quant=mode)
    qmodel = EasyAnimateTransformer3D(cfg, device="meta")
    qmodel.load_state_dict(model.state_dict(), assign=True)
    return qmodel


def _quant_case(stats, key, case, ok, err, ms, plain_ms, bound, **extra):
    line = {"phase": "quant_kernels", "kernel": key, "case": case,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "ok": ok, **extra}
    emit(line)
    if not ok:
        raise AssertionError(f"{key} {case} disagrees with its plain version")
    stats.setdefault(key, {"cases": []})["cases"].append(line)
    if "ms" not in stats[key]:  # the first case is the kernel's row
        stats[key].update(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                          bound_by=bound[1], shape=extra["shape"])
    stats[key]["max_abs_err"] = max(stats[key].get("max_abs_err", 0.0), err)


@torch.no_grad()
def phase_quant_kernels(gen):
    """Q1, Q2 and Q3 against their plain versions at the 12B's shapes (Q1
    and Q3's int8 outputs bit for bit, the bf16 outputs within 1 ulp), with
    kernel / plain times and bounds; then the whole quantized linear in
    each mode at the 12B's widths, held to JAX's cosine guards and timed
    beside F.linear in bf16 (a yardstick the port never calls)."""
    dev = DEVICE
    stats = {}
    m = Q_TOKENS

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    xs = {}
    for k in (3072, 12288):  # Q1: the activations of each fan-in
        x = rand(m, k).to(torch.bfloat16)
        x[:4] *= 8.0  # outlier tokens
        xq, ax = tquant.quantize_rows(x)
        torch.cuda.synchronize()
        xq_p, ax_p = tquant.quantize_rows_plain(x)
        ok = torch.equal(xq, xq_p) and torch.equal(ax, ax_p)
        err = (xq.int() - xq_p.int()).abs().max().item()
        _quant_case(stats, "Q1", f"[{m}, {k}]", ok, err,
                    cuda_ms(lambda: tquant.quantize_rows(x), 10),
                    cuda_ms(lambda: tquant.quantize_rows_plain(x), 3),
                    bound_f32(4 * m * k, nbytes(x, xq, ax)), shape=[m, k],
                    bit_exact=ok)
        xs[k] = (x, xq, ax)
    # Q2 on the accumulators of the products the 12B makes: ff.wo (K
    # 12,288 -> N 3,072, |acc| past 2^24) and ff.wi (K 3,072 -> N 12,288)
    for k, n in ((12288, 3072), (3072, 12288)):
        x, xq, ax = xs[k]
        wq, ws = tquant.quantize_weight_int8(rand(n, k, scale=k ** -0.5))
        bias = rand(n, scale=0.02)
        acc = tquant.int_mm(xq, wq)
        y = tquant.dequantize_rows(acc, ax, ws, bias)
        torch.cuda.synchronize()
        y_p = tquant.dequantize_rows_plain(acc, ax, ws, bias)
        ulps = bf16_ulps(y, y_p)
        _quant_case(stats, "Q2", f"[{m}, {n}] from K {k}", ulps <= 1,
                    (y.float() - y_p.float()).abs().max().item(),
                    cuda_ms(lambda: tquant.dequantize_rows(acc, ax, ws, bias),
                            10),
                    cuda_ms(lambda: tquant.dequantize_rows_plain(
                        acc, ax, ws, bias), 3),
                    bound_f32(4 * m * n, nbytes(acc, ax, ws, bias, y)),
                    shape=[m, n], max_ulps=ulps,
                    acc_max_abs=acc.abs().max().item())
        del acc, y, y_p
    del xs
    # Q3 on ff.wi [12288, 3072] and ff.wo [3072, 12288]: the W4A8 regrid
    # (int4_compute "int8", the default) first, then W4A16
    for n, k in ((12288, 3072), (3072, 12288)):
        w = rand(n, k, scale=k ** -0.5)
        w[:, 5] *= 10.0  # an outlier in-feature
        packed, scale = tquant.quantize_weight_int4(w)
        q8, s8 = tquant.unpack_int4_weight(packed, scale, "int8")
        torch.cuda.synchronize()
        q8_p, s8_p = tquant.unpack_int4_weight_plain(packed, scale, "int8")
        ok = torch.equal(q8, q8_p) and torch.equal(s8, s8_p)
        _quant_case(stats, "Q3", f"int8 regrid [{n}, {k}]", ok,
                    (q8.int() - q8_p.int()).abs().max().item(),
                    cuda_ms(lambda: tquant.unpack_int4_weight(packed, scale,
                                                              "int8"), 10),
                    cuda_ms(lambda: tquant.unpack_int4_weight_plain(
                        packed, scale, "int8"), 3),
                    bound_f32(3 * n * k, nbytes(packed, scale, q8, s8)),
                    shape=[n, k], bit_exact=ok)
        wb = tquant.unpack_int4_weight(packed, scale, torch.bfloat16)
        torch.cuda.synchronize()
        wb_p = tquant.unpack_int4_weight_plain(packed, scale, torch.bfloat16)
        ulps = bf16_ulps(wb, wb_p)
        _quant_case(stats, "Q3", f"bf16 [{n}, {k}]", ulps <= 1,
                    (wb.float() - wb_p.float()).abs().max().item(),
                    cuda_ms(lambda: tquant.unpack_int4_weight(
                        packed, scale, torch.bfloat16), 10),
                    cuda_ms(lambda: tquant.unpack_int4_weight_plain(
                        packed, scale, torch.bfloat16), 3),
                    bound_f32(n * k, nbytes(packed, scale, wb)),
                    shape=[n, k], max_ulps=ulps)
        del w, packed, scale, q8, s8, q8_p, s8_p, wb, wb_p

    # the whole linear in each mode at the 12B's widths
    linears = {}
    for fan_in, fan_out in Q_WIDTHS:
        x = rand(1, QUANT_GUARD_TOKENS, fan_in)
        x[:, :4] = rand(1, 4, fan_in, scale=8.0)
        x = x.to(torch.bfloat16)
        w = rand(fan_out, fan_in, scale=fan_in ** -0.5)
        b = rand(fan_out, scale=0.02)
        want = F.linear(x.float(), w, b)  # float32 from the same bf16 x
        got, ms = {}, {}
        xt = rand(m, fan_in).to(torch.bfloat16)
        for mode in QUANT_MODES:
            lin = tquant.QuantLinear(fan_in, fan_out, mode, device=dev,
                                     dtype=torch.bfloat16)
            lin.set_weight_(w)
            with torch.no_grad():
                lin.bias.copy_(b)
                got[mode] = lin(x).float()
                ms[mode] = cuda_ms(lambda: lin(xt), 5)
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        ms["bf16_linear"] = cuda_ms(lambda: F.linear(xt, wb, bb), 5)
        g, t = got["int8"].reshape(-1, fan_out), want.reshape(-1, fan_out)
        tok = F.cosine_similarity(g, t, dim=-1).min().item()
        cos = {"int8_vs_float": _cosine(got["int8"], want),
               "int8_token_min": tok,
               "w4a8_vs_w4a16": _cosine(got["w4a8"], got["int4"]),
               "w4a8_vs_float": _cosine(got["w4a8"], want),
               "w4a16_vs_float": _cosine(got["int4"], want)}
        ok = (cos["int8_vs_float"] > INT8_COS and tok > INT8_TOKEN_COS
              and cos["w4a8_vs_w4a16"] > W4A8_W4A16_COS
              and cos["w4a8_vs_float"] > W4A8_FLOAT_COS)
        line = {"phase": "quant_kernels", "case": f"linear {fan_in} -> "
                f"{fan_out}", "guard_tokens": QUANT_GUARD_TOKENS,
                "cosines": cos, "timed_tokens": m, "ms": ms,
                "bounds": {"int8_cos": INT8_COS,
                           "int8_token_cos": INT8_TOKEN_COS,
                           "w4a8_w4a16_cos": W4A8_W4A16_COS,
                           "w4a8_float_cos": W4A8_FLOAT_COS}, "ok": ok}
        emit(line)
        if not ok:
            raise AssertionError(f"quantized linear {fan_in} -> {fan_out} "
                                 f"below JAX's guards: {cos}")
        linears[f"{fan_in}x{fan_out}"] = ms
    stats["linears"] = linears
    torch.cuda.empty_cache()
    return stats


def phase_quant(model, vae, seed, steps):
    """The resident 12B at full width and depth, 384x672x49f, CFG 6.0,
    latent output: a bf16 request, then the same request (the same noise
    and prompt) as int8, w4a8 and int4, each quantized from the resident
    bf16 weights and freed after: s/step, peak memory, the transformer's
    resident bytes, the launches of Q1-Q3 and K1, and the final latents'
    cosine to the bf16 request's. Then a rank-128 LoRA with random
    factors merged into the int8 model and unmerged through the
    controller: every weight back within one int8 step."""
    pipe = EasyAnimatePipeline(model, vae)
    expect_k1 = 48 * steps
    allocated = torch.cuda.memory_allocated() / 2**30
    out, ref = latent_request("quant", "bf16", pipe, seed, steps, expect_k1)
    out.update(transformer_bytes=module_bytes(model),
               allocated_before_gib=allocated)
    emit(out)
    results = {"bf16": out}
    for mode in QUANT_MODES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qmodel = quantized_copy(model, mode)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        allocated = torch.cuda.memory_allocated() / 2**30
        before = {k: f.launches for k, f in QCOUNTERS.items()}
        out, lat = latent_request("quant", mode, EasyAnimatePipeline(qmodel,
                                                                     vae),
                                  seed, steps, expect_k1)
        launched = {k: f.launches - before[k] for k, f in QCOUNTERS.items()}
        expect = quant_launches(model.cfg, mode, steps)
        block = torch.nn.ModuleList(m for m in qmodel.modules()
                                    if isinstance(m, tquant.QuantLinear))
        out.update(quantize_s=quantize_s, allocated_before_gib=allocated,
                   launches=launched,
                   expect_launches=expect,
                   transformer_bytes=module_bytes(qmodel),
                   block_linear_bytes=module_bytes(block),
                   block_linears=len(block),
                   latents_cosine_to_bf16=_cosine(lat, ref))
        emit(out)
        if launched != expect or not out["latents_changed_every_step"]:
            raise AssertionError(f"quant {mode}: launches {launched} != "
                                 f"{expect}, or latents unchanged at a step")
        results[mode] = out
        if mode == "int8":
            results["lora"] = quant_lora_roundtrip(qmodel, vae, seed)
        del qmodel, block, lat  # the copy is freed before the next one
        torch.cuda.empty_cache()
    return results


@torch.no_grad()
def quant_lora_roundtrip(qmodel, vae, seed):
    """A rank-128 kohya LoRA file with random factors, merged into the int8
    model's 576 block linears and unmerged through the controller's
    update_lora: each weight moved by the merge and back within one int8
    step (the larger of the merged and the final scale; two roundings of
    half a step each), plus the float32 rounding of the dequantized values
    (1e-4 of a step), after it."""
    ctl = EasyAnimateController(pipeline=EasyAnimatePipeline(qmodel, vae))
    cfg = tlora.LoRAConfig(rank=QUANT_LORA_RANK)
    targets = tlora.target_modules(qmodel, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    lora = {p: {"down": 0.02 * torch.randn(m.in_features, cfg.rank,
                                           generator=gen, device=DEVICE),
                "up": 0.02 * torch.randn(cfg.rank, m.out_features,
                                         generator=gen, device=DEVICE)}
            for p, m in targets.items()}
    before = {p: (m.weight.clone(), m.scale.clone())
              for p, m in targets.items()}
    out = {"phase": "quant", "request": "lora_merge_unmerge",
           "rank": cfg.rank, "modules": len(lora)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quant_") as root:
        path = os.path.join(root, "lora.safetensors")
        t0 = time.perf_counter()
        save_lora_reference(path, lora, cfg.alpha)
        out["write_s"] = time.perf_counter() - t0
        del lora
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.update_lora(path)
        torch.cuda.synchronize()
        out["merge_s"] = time.perf_counter() - t0
    merged_scale = {p: m.scale.clone() for p, m in targets.items()}
    moved = sum(not torch.equal(m.weight, before[p][0])
                for p, m in targets.items())
    t0 = time.perf_counter()
    ctl.update_lora(None)
    torch.cuda.synchronize()
    out["unmerge_s"] = time.perf_counter() - t0
    worst = 0.0
    for p, m in targets.items():
        w0 = before[p][0].float() * before[p][1][:, None]
        step = torch.maximum(merged_scale[p], m.scale)[:, None]
        worst = max(worst, ((m.dequantized_weight() - w0).abs() / step)
                    .max().item())
    out.update(modules_moved_by_merge=moved, worst_error_in_steps=worst,
               scales_changed=sum(not torch.equal(m.scale, before[p][1])
                                  for p, m in targets.items()),
               bound_steps=1.0)
    out["ok"] = moved == len(targets) and worst <= 1.0 + 1e-4
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"quant LoRA round trip: {moved} of "
                             f"{len(targets)} moved, worst {worst} steps")
    return out


def swa_fused_inputs(seed):
    """The 12B's per-layer SWA streams: b 2 (CFG), 48 heads x 64, 256 text
    tokens, (f, h, w) = (13, 24, 42) video tokens; bf16 leaves that take
    gradients, and the two cotangents."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    n_vid = ((FRAMES - 1) // 4 + 1) * (H // 16) * (W // 16)
    mk = lambda n: torch.randn(2, 48, n, 64, generator=gen, device=DEVICE
                               ).to(torch.bfloat16)
    ins = [mk(n).requires_grad_(True) for n in (TEXT_LEN,) * 3 + (n_vid,) * 3]
    return ins, (mk(TEXT_LEN), mk(n_vid))


def swa_fused_run(ins, cot, fuse, backward=True):
    """swa_attention_streams forward (and backward from `cot`)."""
    kw = dict(num_frames=(FRAMES - 1) // 4 + 1, height=H // 16, width=W // 16)
    if not backward:
        with torch.no_grad():
            return swa_attention_streams(*ins, fuse_cross=fuse, **kw)
    outs = swa_attention_streams(*ins, fuse_cross=fuse, **kw)
    return outs, torch.autograd.grad(outs, ins, cot)


def phase_swa_fused(ins, cot, fused):
    """fuse_cross=True against False on the same streams: outputs and
    gradients within FUSED_BOUND of max |unfused|; full-call times."""
    unfused = swa_fused_run(ins, cot, False)
    torch.cuda.synchronize()
    names = ["out_text", "out_video"] + [f"d_{n}" for n in (
        "q_txt", "k_txt", "v_txt", "q_vid", "k_vid", "v_vid")]
    rel = {}
    for n, a, b in zip(names, [*fused[0], *fused[1]],
                       [*unfused[0], *unfused[1]]):
        rel[n] = ((a.float() - b.float()).abs().max()
                  / b.float().abs().max()).item()
    del unfused
    times = {}
    for fuse in (True, False):
        tag = "fused" if fuse else "unfused"
        times[f"{tag}_fwd_ms"] = cuda_ms(
            lambda: swa_fused_run(ins, cot, fuse, backward=False), 5)
        times[f"{tag}_fwd_bwd_ms"] = cuda_ms(
            lambda: swa_fused_run(ins, cot, fuse), 3)
    ok = max(rel.values()) <= FUSED_BOUND
    emit({"phase": "swa_fused", "shapes": {
              "text": list(ins[0].shape), "video": list(ins[3].shape)},
          "rel_err_fused_vs_unfused": rel, "bound": FUSED_BOUND,
          "times_ms": times, "ok": ok})
    if not ok:
        raise AssertionError("swa_fused: fuse_cross=True disagrees with False")
    return times


# serve: requests in the server's protocol through the controller
SERVE_PROMPT = ("A young woman with beautiful clear eyes and blonde hair "
                "stands in a forest, wearing a white dress and a crown")
SERVE_NEGATIVE = ("Blurring, mutation, deformation, distortion, dark and "
                  "solid, comics")
# max |split - batched| / max |batched| of the final (bf16) latents. It
# read 0.0 (bit-identical) in both runs on an H100 80GB HBM3 at 700 W;
# 1e-3 admits at most a last-bit difference in a latent under a quarter of
# the largest, so a wrongly sliced cond entry or a changed guidance fails
CFG_SPLIT_BOUND = 1e-3
LONG_TOTAL, LONG_PARTIAL, LONG_OVERLAP = 90, 49, 4


class WordTokenizer:
    """A word-level stand-in for the Qwen2-VL tokenizer (its files are not
    in the repository): the chat template, each whitespace-separated word
    hashed to an id, right padding to max_length with Qwen2's pad id. It
    has the two methods QwenVLTextEncoder.__call__ uses."""

    pad_id = 151643

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        text = " ".join(part["text"] for m in messages
                        for part in m["content"])
        return f"<|im_start|>user\n{text}<|im_end|>\n<|im_start|>assistant\n"

    def __call__(self, texts, padding, max_length, truncation, padding_side,
                 return_tensors):
        ids = torch.full((len(texts), max_length), self.pad_id)
        mask = torch.zeros((len(texts), max_length), dtype=torch.int64)
        for i, text in enumerate(texts):
            words = [zlib.crc32(w.encode()) % self.pad_id
                     for w in text.split()][:max_length]
            ids[i, :len(words)] = torch.tensor(words)
            mask[i, :len(words)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def serve_request(name, ctl, payload, expect_k1, marks, per_step=None,
                  **extra):
    """One request: payload -> request_kwargs -> controller.generate (with
    `extra` kwargs), a callback stamping each step after a sync with the
    K1 launches since the previous stamp. step_s[0] runs from the end of
    the prompt encode (marks["encoded"]). Checks the request's K1 and K2
    launches (`expect_k1` may be a function of the pipeline, read after the
    run) and, given `per_step`, each step's K1 launches. Returns (JSON
    line, result, the last step's latents)."""
    pipe, k1, k2 = ctl.pipeline, COUNTERS["K1"], COUNTERS["K2"]
    stamps, last = [], []

    def stamp(i, latents):
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), k1.launches))
        last[:] = [latents]

    kwargs = request_kwargs(ctl, payload)
    before = (k1.launches, k2.launches)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = ctl.generate(**kwargs, callback=stamp, **extra)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launched = {"K1": k1.launches - before[0], "K2": k2.launches - before[1]}
    prev = [(marks["encoded"], before[0])] + stamps
    step_s = [t - p for (t, _), (p, _) in zip(stamps, prev)]
    step_k1 = [n - p for (_, n), (_, p) in zip(stamps, prev)]
    if callable(expect_k1):
        expect_k1 = expect_k1(pipe)
    out = {"phase": "serve", "request": name,
           "payload": {k: v for k, v in payload.items()
                       if not k.endswith("textbox")},
           "extra": {k: list(v.shape) if hasattr(v, "shape") else v
                     for k, v in extra.items()},
           "fetch_yuv420": kwargs.get("fetch_yuv420", False),
           "request_s": t_end - t0, "step_s": step_s, "step_k1": step_k1,
           "decode_s": t_end - stamps[-1][0],
           "teacache_skips": pipe.last_teacache_skips,
           "launches": launched, "expect_k1": expect_k1,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30}
    if launched != {"K1": expect_k1, "K2": 0} or (
            per_step is not None and not set(step_k1) <= set(per_step)):
        emit(out)
        raise AssertionError(f"serve {name}: launches {launched} (per step "
                             f"{step_k1}), K1 expected {expect_k1}")
    return out, result, last[0]


def phase_serve(model, vae, seed, steps):
    """Requests in the JAX server's JSON protocol, each through
    api.server.request_kwargs and EasyAnimateController.generate, on the
    resident 12B with the full Qwen2-VL tower encoding every prompt:
    TeaCache at 0.1 with the 4:2:0 fetch (the server's defaults), TeaCache
    at 1e9, cfg_skip_ratio 0.25, cfg_split against batched CFG, the
    sampler dropdown (Euler, then the model's FlowMatch again), the
    overlapped decode against the untiled one, a two-window long video
    and a V2V request with Euler on the inpaint variant. Returns the
    phase's launches."""
    tower = Qwen2TextEncoder(Qwen2Config(), device="meta").to_empty(
        device=DEVICE)
    init_random_(tower, torch.Generator(device=DEVICE).manual_seed(seed))
    enc = QwenVLTextEncoder(tower, tokenizer=WordTokenizer(),
                            max_length=TEXT_LEN)
    encode_s, marks = [], {}

    def encode_text(prompts):
        t0 = time.perf_counter()
        emb, _ = enc(prompts)
        torch.cuda.synchronize()
        marks["encoded"] = time.perf_counter()
        encode_s.append(marks["encoded"] - t0)
        return {"text": emb}

    ctl = EasyAnimateController(EasyAnimatePipeline(model, vae),
                                encode_text=encode_text)
    pipe = ctl.pipeline
    base = {"prompt_textbox": SERVE_PROMPT,
            "negative_prompt_textbox": SERVE_NEGATIVE,
            "sample_step_slider": steps, "width_slider": W,
            "height_slider": H, "length_slider": FRAMES,
            "cfg_scale_slider": 6.0, "seed_textbox": seed}
    total_k1 = 0

    def run(name, payload, expect_k1, **extra):
        nonlocal total_k1
        encode_s.clear()
        out, result, lat = serve_request(name, ctl, payload, expect_k1,
                                         marks, **extra)
        out["text_encode_s"] = list(encode_s)
        total_k1 += out["launches"]["K1"]
        return out, result, lat

    # 1. TeaCache at 0.1 and the 4:2:0 fetch: the server's defaults
    out, planes, lat_tea = run(
        "teacache_0.1", dict(base, enable_teacache=True,
                             teacache_threshold=0.1),
        lambda p: 48 * (steps - p.last_teacache_skips), per_step=(0, 48))
    rgb = video_rgb(planes)
    out.update(
        plane_shapes=[list(p.shape) for p in planes],
        fetched_bytes=sum(p.nbytes for p in planes),
        rgb_uint8_bytes=3 * FRAMES * H * W,
        rgb_rebuilt_shape=list(rgb.shape),
        rgb_rebuilt_finite=bool(np.isfinite(rgb).all()))
    emit(out)
    if (not isinstance(planes, YUV420Video)
            or planes.y.shape != (1, FRAMES, H, W)
            or planes.u.shape != (1, FRAMES, H // 2, W // 2)
            or rgb.shape != (1, 3, FRAMES, H, W)):
        raise AssertionError(f"serve: 4:2:0 result {out['plane_shapes']}")

    # 2. TeaCache at 1e9: every interior step skipped
    out, _, _ = run("teacache_1e9", dict(base, enable_teacache=True,
                                         teacache_threshold=1e9),
                    48 * min(steps, 2), per_step=(0, 48))
    skipped = [t for t, n in zip(out["step_s"], out["step_k1"]) if n == 0]
    computed = [t for t, n in zip(out["step_s"][1:], out["step_k1"][1:])
                if n == 48]
    out.update(skipped_step_s=skipped, computed_step_s=computed)
    emit(out)
    if out["teacache_skips"] != max(steps - 2, 0):
        raise AssertionError(f"serve: {out['teacache_skips']} skips at 1e9")

    # 3. cfg_skip_ratio 0.25: the last round(0.25 * steps) steps cond-only
    n_cond = min(steps, max(0, int(round(0.25 * steps))))
    out, _, _ = run("cfg_skip_0.25", dict(base, cfg_skip_ratio=0.25),
                    48 * steps)
    out.update(cond_only_steps=n_cond,
               cond_only_step_s=out["step_s"][steps - n_cond:],
               cfg_step_s=out["step_s"][1:steps - n_cond])
    emit(out)

    # 4. cfg_split against batched CFG from the same seed
    plain = dict(base, yuv420_fetch=False)
    out_b, lat_b, _ = run("cfg_batched", plain, 48 * steps,
                          output_type="latent")
    emit(out_b)
    out, lat_s, _ = run("cfg_split", plain, 96 * steps, output_type="latent",
                        cfg_split=True)
    rel = ((lat_s.float() - lat_b.float()).abs().max()
           / lat_b.float().abs().max()).item()
    out.update(rel_diff_vs_batched=rel, bound=CFG_SPLIT_BOUND,
               batched_max_memory_allocated_gib=out_b[
                   "max_memory_allocated_gib"])
    emit(out)
    if not rel <= CFG_SPLIT_BOUND:
        raise AssertionError(f"serve: cfg_split latents off by {rel}")
    del lat_s

    # the sampler dropdown: Euler for one request, then the model's own
    # FlowMatch again for the next request without the field (the same
    # payload as cfg_batched, so the same latents)
    flow = pipe.scheduler
    out, lat_e, _ = run("sampler_euler", dict(plain, sampler_dropdown="Euler"),
                        48 * steps, output_type="latent")
    out.update(scheduler=type(pipe.scheduler).__name__,
               latents_finite=bool(torch.isfinite(lat_e).all()))
    emit(out)
    if out["scheduler"] != "EulerConfig" or not out["latents_finite"]:
        raise AssertionError(f"serve: sampler_dropdown Euler ran "
                             f"{out['scheduler']}")
    out, lat_f, _ = run("sampler_default", plain, 48 * steps,
                        output_type="latent")
    rel = ((lat_f.float() - lat_b.float()).abs().max()
           / lat_b.float().abs().max()).item()
    out.update(scheduler=type(pipe.scheduler).__name__,
               rel_diff_vs_cfg_batched=rel,
               euler_rel_diff_vs_flow=((lat_e.float() - lat_f.float()).abs()
                                       .max() / lat_f.float().abs().max()
                                       ).item())
    emit(out)
    if pipe.scheduler is not flow or not rel <= CFG_SPLIT_BOUND:
        raise AssertionError(f"serve: the request after Euler ran "
                             f"{out['scheduler']}, {rel} off cfg_batched")
    del lat_b, lat_e, lat_f

    # 5. the overlapped decode of request 1's latents against the untiled
    # vae_decode (uint8 on the card), timed in turns; the untiled one's
    # device part and its host fetch also apart, the fetch being what the
    # overlap can hide
    fetch_s = []

    def untiled_decode():
        with torch.inference_mode():
            video = vae_decode(vae, (lat_tea.float() / vae.cfg.scaling_factor
                                     ).to(vae.cfg.torch_dtype))
            video = torch.round((video.float() / 2 + 0.5).clamp(0.0, 1.0)
                                * 255.0).to(torch.uint8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            video = video.cpu().numpy()
            fetch_s.append(time.perf_counter() - t0)
            return video

    decodes = {"overlapped": lambda: pipe.decode_latents_overlapped(lat_tea),
               "untiled": untiled_decode}
    times, videos = {k: [] for k in decodes}, {}
    for name in ("overlapped", "untiled", "untiled", "overlapped"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        videos[name] = decodes[name]()
        times[name].append(time.perf_counter() - t0)
    overlapped, untiled = videos["overlapped"], videos["untiled"]
    diff = int(np.abs(overlapped.astype(np.int16) - untiled).max())
    emit({"phase": "serve", "request": "decode_overlapped",
          "overlapped_s": times["overlapped"], "untiled_s": times["untiled"],
          "untiled_fetch_s": fetch_s,
          "untiled_device_s": [t - f for t, f in zip(times["untiled"],
                                                     fetch_s)],
          "fetched_bytes": untiled.nbytes,
          "order": "overlapped, untiled, untiled, overlapped",
          "max_abs_diff_uint8": diff, "bound": 1,
          "shape": list(overlapped.shape)})
    if diff > 1 or overlapped.shape != (1, 3, FRAMES, H, W):
        raise AssertionError(f"serve: overlapped decode off by {diff}")
    del videos, untiled, overlapped, lat_tea

    # 6. Long Video Generation on the inpaint variant: 90 frames in two
    # windows of 49 and 45 with 4 blended; each window's HostCopy timed
    # where it starts (the host's pinned allocation and enqueue) and where
    # it is waited for (window 1's after window 2 ran)
    ctl = EasyAnimateController(
        EasyAnimateInpaintPipeline(inpaint_variant(model, seed + 1), vae),
        encode_text=encode_text)
    copy_s = {"start": [], "wait": []}

    class TimedCopy(HostCopy):
        def __init__(self, tensor):
            t0 = time.perf_counter()
            super().__init__(tensor)
            copy_s["start"].append(time.perf_counter() - t0)

        def result(self):
            t0 = time.perf_counter()
            out = super().result()
            copy_s["wait"].append(time.perf_counter() - t0)
            return out

    controller_module.HostCopy = TimedCopy
    out, video, _ = run("long_video", dict(
        base, generation_method="Long Video Generation",
        length_slider=LONG_TOTAL, partial_video_length=LONG_PARTIAL,
        overlap_video_length=LONG_OVERLAP), 48 * steps * 2)
    controller_module.HostCopy = HostCopy
    # what a window's fetch costs where nothing runs beside it: a
    # synchronous pageable copy of a window-sized float video, three times
    window = torch.rand((1, 3, LONG_PARTIAL, H, W), device=DEVICE)
    sync_fetch_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window.cpu().numpy()
        sync_fetch_s.append(time.perf_counter() - t0)
    del window
    out.update(hostcopy_start_s=copy_s["start"],
               hostcopy_wait_s=copy_s["wait"],
               sync_window_fetch_s=sync_fetch_s)
    # window_s: from the prompt encode, or the previous window's last step
    # (its decode and this window's VAE encode between), to its last step
    ends = [i for i in range(len(out["step_s"])) if (i + 1) % steps == 0]
    out.update(windows=len(ends), video_shape=list(video.shape),
               window_s=[sum(out["step_s"][a + 1:b + 1])
                         for a, b in zip([-1] + ends, ends)],
               video_finite=bool(np.isfinite(video).all()))
    emit(out)
    if (video.shape != (1, 3, LONG_TOTAL, H, W) or not out["video_finite"]
            or len(ends) != 2):
        raise AssertionError(f"serve: long video {video.shape}")
    # V2V with Euler on the inpaint variant: strength 0.7 starts at step
    # steps - int(0.7 * steps) from the sigma-space noised clip
    v2v_steps = int(steps * 0.7)
    out, lat_v, _ = run(
        "v2v_euler", dict(plain, sampler_dropdown="Euler",
                          denoise_strength=0.7), 48 * v2v_steps,
        output_type="latent",
        source_video=control_inputs(seed + 2)["control_video"])
    out.update(denoise_steps=v2v_steps, scheduler=type(
        ctl.pipeline.scheduler).__name__,
        latents_finite=bool(torch.isfinite(lat_v).all()))
    emit(out)
    if out["scheduler"] != "EulerConfig" or not out["latents_finite"]:
        raise AssertionError(f"serve: V2V Euler {out}")
    del lat_v
    emit({"phase": "serve", "request": "mp4",
          "note": "the base64 mp4 encode needs imageio or cv2, which this "
                  "machine lacks; tests/test_torch_frontend.py::"
                  "test_http_request_returns_an_mp4 covers it on the CPU"})
    del ctl, enc, tower, video
    torch.cuda.empty_cache()
    return {"K1": total_k1}


DEVICE = torch.device("cuda")
# flash_attention_fwd.launches_sm90, sliding_window_fwd.launches_sm90 and
# swa_local_global_fwd.launches_sm90 count the K1, K2 and K5 launches that
# ran their TMA + wgmma kernels (d 64), flash_attention_bwd.launches_sm90
# and sliding_window_bwd.launches_sm90 the K3 + K4 and K6 + K7 launches
# that ran theirs (both kernels, one call); every main path runs at d 64
COUNTERS = {"K1": flash_attention_fwd, "K2": sliding_window_fwd,
            "K3": flash_attention_bwd, "K4": flash_attention_bwd,
            "K5": swa_local_global_fwd,
            "K6": sliding_window_bwd, "K7": sliding_window_bwd}


def reset_counts():
    """The main path's run starts here. K3 and K4 share one counter (each
    flash_attention_bwd call launches both), as do K6 and K7; K1 also
    counts its launches by head dim and those on its short-head kernel."""
    for fn in (*COUNTERS.values(), *QCOUNTERS.values()):
        fn.launches = 0
    flash_attention_fwd.launches_by_dim = {}
    flash_attention_fwd.launches_sm90 = 0
    flash_attention_fwd.launches_sm90_by_dim = {}
    flash_attention_fwd.launches_short = 0
    flash_attention_fwd.launches_short_by_dim = {}
    sliding_window_fwd.launches_sm90 = 0
    swa_local_global_fwd.launches_sm90 = 0
    flash_attention_bwd.launches_sm90 = 0
    sliding_window_bwd.launches_sm90 = 0


def read_counts():
    return {k: fn.launches for k, fn in COUNTERS.items()}


def train_batch(cfg, seed):
    """Random latents for HxWxFRAMES, random text embeddings (V5: both
    streams), RoPE."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(seed)
    lat = torch.randn(1, 16, (FRAMES - 1) // 4 + 1, H // 8, W // 8,
                      generator=gen, device=dev)
    v5 = cfg.text_embed_dim_t5 is not None  # Bert's 77 + mT5's 256 tokens
    txt = 0.02 * torch.randn(1, BERT_LEN if v5 else TEXT_LEN,
                             cfg.text_embed_dim, generator=gen, device=dev)
    batch = {"latents": lat, "text": txt,
             "rope": build_rope(cfg, H, W, lat.shape[2], device=dev)}
    if v5:
        batch["text_t5"] = 0.02 * torch.randn(
            1, TEXT_LEN, cfg.text_embed_dim_t5, generator=gen, device=dev)
    return batch, gen


@torch.no_grad()
def checksum(model):
    """Per-tensor (sum of the raw 16-bit words, sum of squares): any change
    of a bf16 weight moves it."""
    return [(p.view(torch.int16).sum(dtype=torch.int64).item(),
             p.float().square().sum().item()) for p in model.parameters()]


def train_phase(phase, step_fn, state, batch, gen, expect, steps=TRAIN_STEPS,
                after_step=None):
    """Run `steps` training steps from the reset counts; check finite
    losses and the launches of every step against `expect`."""
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, generator=gen)
        loss = metrics["loss"].item()  # syncs
        times.append(time.perf_counter() - t0)
        got = {k: n - before[k] for k, n in read_counts().items()}
        if got != expect:
            raise AssertionError(f"{phase}: step {i} launches {got} != {expect}")
        if not math.isfinite(loss):
            raise AssertionError(f"{phase}: loss {loss} at step {i}")
        losses.append(loss)
        if after_step is not None:
            after_step(i, state)
    out = {"phase": phase, "steps": steps, "losses": losses,
           "grad_norm_last": metrics["grad_norm"].item(),
           "s_per_step": times, "s_per_step_after_first":
               sum(times[1:]) / max(len(times) - 1, 1),
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step": expect}
    return state, out


def phase_lora(phase, model, seed, expect, steps=TRAIN_STEPS):
    """make_lora_train_step on frozen bf16 12B weights: rank 128, alpha 16,
    TrainConfig defaults, 384x672x49f, remat on; `steps` steps on one
    batch (V5's with its text_t5)."""
    before = checksum(model)
    batch, gen = train_batch(model.cfg, seed)
    lcfg = tlora.LoRAConfig(rank=128)
    init, step = tlora.make_lora_train_step(model, ttrainer.TrainConfig(), lcfg)
    state = init(gen)
    n_lora = sum(t.numel() for t in tlora.flatten_lora(state.params).values())

    # the last block's text-only modules never reach the loss (only video
    # tokens are predicted): their factors get zero gradients, as in JAX
    last = f"transformer_blocks.{model.cfg.num_layers - 1}."
    unreached = {last + m for m in ("attn2.to_q", "attn2.to_out.0",
                                    "txt_ff.net.0.proj", "txt_ff.net.2")}

    def up_moved(i, st):
        zero = {p for p, f in st.params.items() if not f["up"].any()}
        if i == 0 and zero != unreached:
            raise AssertionError(f"{phase}: up factors at 0 after step 1: "
                                 f"{sorted(zero)[:6]}")

    state, out = train_phase(phase, step, state, batch, gen, expect,
                             steps=steps, after_step=up_moved)
    frozen = checksum(model) == before
    out.update(batch_text={k: list(batch[k].shape) for k in ("text", "text_t5")
                           if k in batch},
               lora_rank=lcfg.rank, lora_alpha=lcfg.alpha,
               lora_params=n_lora, lora_modules=len(state.params),
               base_weights_unchanged=frozen,
               up_nonzero_after_step_1=len(state.params) - len(unreached),
               up_zero_unreached=sorted(unreached))
    emit(out)
    if not frozen:
        raise AssertionError(f"{phase}: the frozen base weights changed")
    del state
    torch.cuda.empty_cache()
    return out


SFT_LAUNCHES = {"K1": 8, "K2": 6, "K3": 4, "K4": 4, "K5": 0, "K6": 3, "K7": 3}
# the sft phase's runs: (name, TrainConfig fields, steps)
SFT_VARIANTS = (("sft", {}, TRAIN_STEPS),
                ("sft_came", {"optimizer": "came"}, TRAIN_STEPS),
                ("sft_adamw8bit", {"optimizer": "adamw8bit"}, TRAIN_STEPS),
                ("sft_ddpm", {"loss_type": "ddpm"}, 1))


def state_bytes(tree):
    """Bytes of the tensors in a (nested) training state."""
    tensors = []
    flatten_state(tree, tensors)
    return sum(t.numel() * t.element_size() for t in tensors)


# masters the sft and parallel phases require to move
SFT_WATCH = ("transformer_blocks.0.attn1.to_q.weight",
             "transformer_blocks.2.ff.net.2.weight", "proj_out.weight")


def phase_sft(seed):
    """make_train_step at the 12B widths, 4 layers (0 dense, 1-3 SWA),
    random weights, float32 masters, 384x672x49f: 3 steps each of AdamW,
    CAME and 8-bit AdamW, then 1 'ddpm' step (AdamW), each from fresh
    masters and optimizer state; s/step, peak memory and the optimizer
    state's bytes of each."""
    dev = DEVICE
    cfg = dataclasses.replace(PRESETS["v5.1-12b"], num_layers=4,
                              swa_layers=(1, 2, 3))
    model = EasyAnimateTransformer3D(cfg, device="meta")
    model = init_random_(model.to_empty(device=dev),
                         torch.Generator(device=dev).manual_seed(seed))
    watch = SFT_WATCH
    batch, gen = train_batch(cfg, seed)
    outs = []
    for name, fields, steps in SFT_VARIANTS:
        tcfg = ttrainer.TrainConfig(**fields)
        torch.cuda.empty_cache()
        state = ttrainer.create_train_state(model, tcfg)
        start = {n: state.params[n].clone() for n in watch}
        state, out = train_phase(
            name, ttrainer.make_train_step(model, tcfg), state, batch, gen,
            SFT_LAUNCHES, steps=steps)
        moved = {n: (state.params[n] - start[n]).abs().max().item()
                 for n in watch}
        synced = all(torch.equal(p, state.params[n].to(p.dtype))
                     for n, p in model.named_parameters())
        out.update(params=sum(p.numel() for p in model.parameters()),
                   layers=cfg.num_layers, swa_layers=list(cfg.swa_layers),
                   train_config=fields,
                   optimizer_state_bytes=state_bytes(state.opt_state),
                   master_bytes=state_bytes(state.params),
                   master_max_abs_change=moved, model_matches_masters=synced)
        emit(out)
        if not (all(v > 0 for v in moved.values()) and synced):
            raise AssertionError(f"{name}: the parameters did not move or the "
                                 "model does not hold its masters")
        outs.append(out)
        del state, start
    return outs


DRIVER_STEPS, DRIVER_CHECKPOINT = 3, 2


class _Recorded:
    """Wraps a callable: CUDA events around each call (device seconds of
    the work it queues, read after the run without adding a sync)."""

    def __init__(self, fn):
        self.fn, self.events = fn, []

    def __call__(self, *a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*a, **k)
        end.record()
        self.events.append((start, end))
        return out

    def seconds(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) / 1e3 for s, e in self.events]


def _media_reads(height, width):
    """Stand-ins for the dataset's file reads (the card machine has no
    PIL, imageio or cv2): seeded uint8 frames at the target size, by path,
    so the sampler, buckets, loader, collate and crop run as they are."""
    def frames(path, n):
        rng = np.random.default_rng(zlib.crc32(path.encode()))
        return rng.integers(0, 256, (n, height, width, 3), dtype=np.uint8)

    return {"_read_video": lambda path, idx: frames(path, len(idx)),
            "_read_image": lambda path: frames(path, 1)[0],
            "_probe_frame_count": lambda path: 0}


def phase_train_driver(model, vae, seed, root):
    """The training driver's loop (train.train, what `python -m
    easyanimate_tpu_torch.train` runs after loading) on the resident 12B
    and the full MagViT: LoRA rank 128 at HxWxFRAMES, batch 1, a manifest
    of 2 videos and 2 images (their file reads patched into the dataset
    module), prompts through the full Qwen2-VL tower (random weights, the
    stand-in tokenizer). DRIVER_CHECKPOINT steps with checkpointing at
    DRIVER_CHECKPOINT; then a resume from that checkpoint, which must
    restore the saved state and sampler cursor bit for bit, finishes step
    DRIVER_STEPS. Checks: finite losses, each step's launches those of
    phase_lora (K1 96, K3 48, K4 48), the kohya export read back by
    load_lora_reference equal to the final factors, the frozen base weights
    unchanged. Returns the phase's launches."""
    t_tower = time.perf_counter()
    tower = Qwen2TextEncoder(Qwen2Config(), device="meta").to_empty(
        device=DEVICE)
    init_random_(tower, torch.Generator(device=DEVICE).manual_seed(seed))
    enc = QwenVLTextEncoder(tower, tokenizer=WordTokenizer(),
                            max_length=TEXT_LEN)
    torch.cuda.synchronize()
    tower_s = time.perf_counter() - t_tower

    def encode_text(prompts):
        return {"text": enc(list(prompts))[0]}

    entries = [{"file_path": f"clip{i}.mp4", "type": "video",
                "num_frames": 120, "text": f"{SERVE_PROMPT} take {i}"}
               for i in range(2)]
    entries += [{"file_path": f"still{i}.png", "type": "image",
                 "text": f"a still of the forest, number {i}"}
                for i in range(2)]
    meta = os.path.join(root, "train.json")
    with open(meta, "w") as f:
        json.dump(entries, f)
    out_dir = os.path.join(root, "run")
    argv = ["--train_data_meta", meta, "--train_data_dir", root,
            "--output_dir", out_dir, "--lora_rank", "128",
            "--sample_height", str(H), "--sample_width", str(W),
            "--video_sample_n_frames", str(FRAMES),
            "--checkpointing_steps", str(DRIVER_CHECKPOINT),
            "--dataloader_num_workers", "2", "--no-sanity_check",
            "--seed", str(seed)]
    expect = {"K1": 96, "K2": 0, "K3": 48, "K4": 48, "K5": 0, "K6": 0,
              "K7": 0}
    step_launches, checks = [], {}
    make_step = train_module.make_lora_train_step

    def checked_lora_step(*a, **k):
        init, step = make_step(*a, **k)

        def counted(state, batch, **kw):
            before = read_counts()
            out = step(state, batch, **kw)
            got = {n: c - before[n] for n, c in read_counts().items()}
            step_launches.append(got)
            if got != expect:
                raise AssertionError(f"train_driver: step launches {got} "
                                     f"!= {expect}")
            return out

        return init, counted

    saved = {}

    class RecordingManager(CheckpointManager):
        """Holds the restored state against the saved one, bit for bit,
        before the resumed run trains on it."""

        def restore_latest(self, template=None, device=None):
            t0 = time.perf_counter()
            state, cursor, step = super().restore_latest(template, device)
            torch.cuda.synchronize()
            checks["restore_s"] = time.perf_counter() - t0
            got = []
            spec = flatten_state(state, got)
            checks["restored_step"] = step
            checks["restored_equal"] = spec == saved["spec"] and all(
                torch.equal(g.detach(), w)
                for g, w in zip(got, saved["tensors"]))
            checks["cursor_equal"] = cursor == saved["cursor"]
            return state, cursor, step

    encode = _Recorded(train_module.vae_encode)
    patches = [(train_module, "vae_encode", encode),
               (train_module, "make_lora_train_step", checked_lora_step),
               (train_module, "CheckpointManager", RecordingManager)]
    patches += [(dataset_module, k, v) for k, v in _media_reads(H, W).items()]
    originals = [(m, k, getattr(m, k)) for m, k, _ in patches]
    before = checksum(model)
    torch.cuda.reset_peak_memory_stats()
    try:
        for m, k, v in patches:
            setattr(m, k, v)
        first = train_module.train(train_module.parse_args(
            argv + ["--max_train_steps", str(DRIVER_CHECKPOINT)]),
            model, vae, encode_text, DEVICE)
        peak_first = torch.cuda.max_memory_allocated() / 2**30
        # the saved state stays on the card (8 GB) for the comparison
        tensors = []
        saved["spec"] = flatten_state(first.state, tensors)
        saved["tensors"] = [t.detach() for t in tensors]
        saved["cursor"] = first.sampler_state
        state_b = state_bytes(first.state)
        first.state = None
        del tensors
        second = train_module.train(train_module.parse_args(
            argv + ["--max_train_steps", str(DRIVER_STEPS),
                    "--resume_from_checkpoint"]),
            model, vae, encode_text, DEVICE)
    finally:
        for m, k, v in originals:
            setattr(m, k, v)
    peak = torch.cuda.max_memory_allocated() / 2**30
    saved.clear()
    lora, lcfg = load_lora_reference(model, second.lora_path, device=DEVICE)
    exported = lcfg.rank == 128 and set(lora) == set(second.state.params) and \
        all(torch.equal(lora[p][k], t.detach())
            for p, fac in second.state.params.items() for k, t in fac.items())
    frozen = checksum(model) == before
    losses = first.losses + second.losses
    out = {"phase": "train_driver", "lora_rank": 128, "batch": 1,
           "frames": FRAMES, "height": H, "width": W,
           "manifest": {"videos": 2, "images": 2},
           "steps": len(losses), "resumed_from": checks.get("restored_step"),
           "losses": losses, "s_per_step": first.step_s + second.step_s,
           "vae_encode_s": encode.seconds(),
           "checkpoint_save_s": first.save_s + second.save_s,
           "checkpoint_load_s": checks.get("restore_s"),
           "driver_load_s": second.load_s,
           "state_bytes": state_b, "tower_build_s": tower_s,
           "restored_state_bit_equal": checks.get("restored_equal"),
           "restored_cursor_equal": checks.get("cursor_equal"),
           "cursor_saved": first.sampler_state,
           "kohya_export_loads_equal": exported,
           "base_weights_unchanged": frozen,
           "step_launches": step_launches,
           "max_memory_allocated_gib_first_run": peak_first,
           "max_memory_allocated_gib": peak,
           "peak_note": "the first run's peak is the driver's own; the "
                        "overall one adds the saved state held on the card "
                        "for the bit-equality check",
           "text_tower": "resident beside the 12B, the VAE and the LoRA step"}
    emit(out)
    del lora, second, enc, tower
    torch.cuda.empty_cache()
    if not (all(map(math.isfinite, losses)) and len(losses) == DRIVER_STEPS
            and checks.get("restored_step") == DRIVER_CHECKPOINT
            and checks.get("restored_equal") and checks.get("cursor_equal")
            and exported and frozen and len(step_launches) == DRIVER_STEPS):
        raise AssertionError(f"train_driver: a check failed: {out}")
    return {k: v * DRIVER_STEPS for k, v in expect.items()}


LCM_STEPS = 2
LCM_RANK = 64  # the driver's default (examples/train_lcm_lora.py)
# per LCM step: the student's forward and its remat recompute, two teacher
# evaluations and the target's (K1 5 x 48); one backward (K3, K4 48)
LCM_LAUNCHES = {"K1": 5 * 48, "K2": 0, "K3": 48, "K4": 48, "K5": 0, "K6": 0,
                "K7": 0}


def phase_lcm(model, seed):
    """make_lcm_train_step on the resident bf16 12B: LoRA rank 64, LCMConfig
    defaults, 384x672x49f latents, random text (the negative text zeros),
    LCM_STEPS steps. Checks: each step's launches (LCM_LAUNCHES), the base
    weights unchanged (checksum), the LoRA moved, and after each step the
    EMA factors equal to d * e + (1 - d) * p, bit for bit."""
    before = checksum(model)
    batch, gen = train_batch(model.cfg, seed)
    lcfg = tlora.LoRAConfig(rank=LCM_RANK)
    lcm_cfg = tlcm.LCMConfig()
    init, step = tlcm.make_lcm_train_step(model, DDIMConfig(), lcm_cfg, lcfg,
                                          ttrainer.TrainConfig())
    state = init(gen)
    start = {k: t.detach().clone()
             for k, t in tlora.flatten_lora(state.params).items()}
    prev = {k: t.clone() for k, t in tlora.flatten_lora(state.ema_params).items()}
    ema_equal = []

    def check_ema(i, st):
        p, e = tlora.flatten_lora(st.params), tlora.flatten_lora(st.ema_params)
        d = lcm_cfg.ema_decay
        ema_equal.append(all(torch.equal(e[k], d * prev[k] + (1 - d) * p[k])
                             for k in e))
        prev.update({k: t.clone() for k, t in e.items()})

    state, out = train_phase("lcm", step, state, batch, gen, LCM_LAUNCHES,
                             steps=LCM_STEPS, after_step=check_ema)
    moved = max((t.detach() - start[k]).abs().max().item()
                for k, t in tlora.flatten_lora(state.params).items())
    frozen = checksum(model) == before
    out.update(lora_rank=lcfg.rank, lora_alpha=lcfg.alpha,
               lora_params=sum(t.numel() for t in start.values()),
               lcm_config=dataclasses.asdict(lcm_cfg),
               base_weights_unchanged=frozen, lora_max_abs_change=moved,
               ema_equal_after_each_step=ema_equal)
    emit(out)
    del state, start, prev
    torch.cuda.empty_cache()
    if not (frozen and moved > 0 and len(ema_equal) == LCM_STEPS
            and all(ema_equal)):
        raise AssertionError(f"lcm: a check failed: {out}")
    return out


REWARD_SAMPLE_STEPS, REWARD_SELECTED, REWARD_RANK = 4, 2, 32
# per reward step: 4 CFG evaluations at batch 2 (K1 4 x 48) and the two
# selected steps' remat recompute (2 x 48) and backward (K3, K4 2 x 48)
REWARD_LAUNCHES = {"K1": (REWARD_SAMPLE_STEPS + REWARD_SELECTED) * 48,
                   "K2": 0, "K3": REWARD_SELECTED * 48,
                   "K4": REWARD_SELECTED * 48, "K5": 0, "K6": 0, "K7": 0}
# the improved-aesthetic-predictor's linear stack over CLIP-L/14's 768:
# (index in its nn.Sequential, in, out)
AESTHETIC_HEAD = ((0, 768, 1024), (2, 1024, 128), (4, 128, 64), (6, 64, 16),
                  (7, 16, 1))


def _scorer_pass(scorer, frames, *args):
    """One forward + backward to the frames: (ms, reward, grad finite and
    non-zero)."""
    fr = frames.detach().clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, reward = scorer(fr, *args)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    g = fr.grad
    return ms, reward.item(), bool(torch.isfinite(g).all()) and bool(g.any())


def phase_reward(model, vae, seed):
    """make_reward_train_step on the resident bf16 12B and the full MagViT
    (bf16): LoRA rank 32, REWARD_SAMPLE_STEPS FlowMatch steps (the driver's
    50 cut to 4), 'tail' with REWARD_SELECTED selected, one decoded latent
    frame, CFG 6.0; the scorer a CLIP-H/14 at its published widths (random
    float32 weights, stand-in token ids) scoring against REWARD_PROMPTS.
    One step with DRTune off, one with it on: launches (REWARD_LAUNCHES),
    a non-zero LoRA gradient, the base weights unchanged. Then MPSReward
    (the same CLIP-H + a random cross model) and AestheticReward (a CLIP-L/14
    + a random head) alone on the last step's decoded frames, forward and
    backward to the frames, twice each (the first includes warm-up)."""
    before = checksum(model)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    clip_h = init_random_(tclip.CLIPModel(tclip.CLIP_PRESETS["clip-vit-h-14"],
                                          device=DEVICE), gen)
    torch.cuda.synchronize()
    clip_build_s = time.perf_counter() - t0
    tok = ClipWordTokenizer()
    scorer = CLIPScoreReward(clip_h, tok)
    decoded = {}

    def reward_fn(frames):
        decoded["frames"] = frames.detach()
        return scorer(frames, REWARD_PROMPTS)[1][None]

    cfg = model.cfg
    lat_frames = (FRAMES - 1) // 4 + 1
    batch = {"text": 0.02 * torch.randn(1, TEXT_LEN, cfg.text_embed_dim,
                                        generator=gen, device=DEVICE),
             "latent_shape": (1, 16, lat_frames, H // 8, W // 8),
             "rope": build_rope(cfg, H, W, lat_frames, device=DEVICE)}
    outs = []
    for drtune in (False, True):
        rcfg = treward.RewardConfig(
            num_sample_steps=REWARD_SAMPLE_STEPS, backprop_strategy="tail",
            backprop_num_steps=REWARD_SELECTED,
            stop_latent_model_input_gradient=drtune, num_decoded_latents=1,
            guidance_scale=6.0)
        init, step = treward.make_reward_train_step(
            model, vae, reward_fn, rcfg, tlora.LoRAConfig(rank=REWARD_RANK),
            ttrainer.TrainConfig(), vae_scaling=vae.cfg.scaling_factor)
        name = "reward_drtune" if drtune else "reward"
        state, out = train_phase(name, step, init(gen), batch, gen,
                                 REWARD_LAUNCHES, steps=1)
        out.update(reward_config=dataclasses.asdict(rcfg),
                   lora_rank=REWARD_RANK, scorer="CLIP-H/14 (random)",
                   decoded_frames=list(decoded["frames"].shape))
        emit(out)
        outs.append(out)
        del state
        torch.cuda.empty_cache()
    frames = decoded.pop("frames")

    cross = init_random_(MPSCrossModel(device=DEVICE), gen)
    mps = MPSReward(clip_h, tok, cross)
    clip_l = init_random_(tclip.CLIPModel(tclip.CLIP_PRESETS["clip-vit-l-14"],
                                          device=DEVICE), gen)
    head = {f"layers.{i}.weight": torch.randn(o, n, generator=gen,
                                              device=DEVICE) * n ** -0.5
            for i, n, o in AESTHETIC_HEAD}
    head.update({f"layers.{i}.bias": torch.zeros(o, device=DEVICE)
                 for i, n, o in AESTHETIC_HEAD})
    aesthetic = AestheticReward(clip_l, convert_aesthetic_head(head,
                                                               device=DEVICE))
    scorers = {}
    # MPS scores each sample against its own prompt (one frame, one prompt)
    for name, sc, args in (("mps", mps, ([REWARD_PROMPTS[0]],)),
                           ("aesthetic", aesthetic, ())):
        runs = [_scorer_pass(sc, frames, *args) for _ in range(2)]
        scorers[name] = {"ms": [r[0] for r in runs], "reward": runs[-1][1],
                         "finite_nonzero_frame_grad": all(r[2] for r in runs)}
    frozen = checksum(model) == before
    summary = {"phase": "reward_scorers", "frames": list(frames.shape),
               "clip_h_build_s": clip_build_s,
               "clip_h_params": sum(p.numel() for p in clip_h.parameters()),
               "clip_l_params": sum(p.numel() for p in clip_l.parameters()),
               "mps_cross_params": sum(p.numel() for p in cross.parameters()),
               "scorers": scorers, "base_weights_unchanged": frozen}
    emit(summary)
    del clip_h, clip_l, cross, mps, aesthetic, scorer, frames
    torch.cuda.empty_cache()
    ok = (frozen and all(o["grad_norm_last"] > 0 for o in outs)
          and all(v["finite_nonzero_frame_grad"]
                  and math.isfinite(v["reward"]) for v in scorers.values()))
    if not ok:
        raise AssertionError(f"reward: a check failed: {outs} {summary}")
    return outs, summary


# the parallel phase: the ring's sp sizes over V5.1's joint attention, the
# Ulysses head slices of the 12B's 48 heads (sp = 4), the driver's steps
PARALLEL_SPS = (2, 4)
ULYSSES_SP = 4
PARALLEL_STEPS = 2
# the driver's sharded runs against the plain one: the least share of the
# masters' elements updated with the same sign (one card: 0.99999 under
# FSDP2, 1 under ZeRO-2; four cards: 0.9996, tools/multigpu_check.py)
SIGN_AGREEMENT_BOUND = 0.999
# the 12B's SWA layer: 13 latent frames of 24 x 42 patches (window 1,008)
SWA_GRID = dict(num_frames=13, height=24, width=42)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _ring_hops(gen):
    """The ring's hop code at V5.1-12B's joint attention, q, k, v [2 x 48,
    13,360, 64] bf16, in one process: for sp in PARALLEL_SPS the sequence
    splits into sp contiguous shards; each shard's q visits every kv shard
    in ring order (K1 per hop, then the float32 merge), then the backward
    hops (K3 + K4 per hop from the merged o and lse, one di per shard),
    dq summed per q shard and dk, dv per kv shard. Held against one K1 and
    one K3 + K4 call over the whole sequence: o within O_REL_BOUND of
    max |o|, lse within LSE_BOUND, dq, dk, dv within BWD_BOUND. Times: one
    hop's kernels and one merge alone (CUDA events, no counter), their
    sum over the sp^2 hops against the one call. Returns (stats, launches
    of K1 and of the K3 + K4 pair)."""
    dev, d, s = DEVICE, HEAD_DIM, S_DENSE

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    q, k, v = rand(BH, s, d, scale=d ** -0.5 * LOG2E), rand(BH, s, d), \
        rand(BH, s, d)
    do = rand(BH, s, d)
    o_w, lse_w = flash_attention_fwd(q, k, v)
    dq_w, dk_w, dv_w = flash_attention_bwd(q, k, v, o_w, lse_w, do)
    di_w = row_dot(o_w, do)
    outs = [torch.empty_like(q) for _ in range(4)]
    lse_buf = torch.empty_like(lse_w)
    whole = {"fwd_ms": _entry_ms("ea_flash_fwd_bf16", (q, k, v),
                                 (outs[0], lse_buf), (BH, s, s, s, d)),
             "bwd_ms": (_entry_ms("ea_flash_bwd_dq_bf16",
                                  (q, k, v, do, lse_w, di_w), (outs[1],),
                                  (BH, s, s, s, d))
                        + _entry_ms("ea_flash_bwd_dkv_bf16",
                                    (q, k, v, do, lse_w, di_w),
                                    (outs[2], outs[3]), (BH, s, s, s, d))),
             "row_dot_ms": cuda_ms(lambda: row_dot(o_w, do), 5)}
    del outs, lse_buf
    stats, hops = {"whole": whole}, 0
    for sp in PARALLEL_SPS:
        n = s // sp
        cut = lambda x, i: x[:, i * n:(i + 1) * n].contiguous()
        qs, ks, vs, dos = ([cut(x, i) for i in range(sp)]
                           for x in (q, k, v, do))
        o_err = lse_err = 0.0
        merged = []
        for r in range(sp):
            o_acc = torch.zeros(BH, n, d, device=dev)
            lse_acc = torch.full((BH, n, 1), -torch.inf, device=dev)
            for j in range(sp):  # rank r sees its own block, then r-1, ...
                src = (r - j) % sp
                o_acc, lse_acc = ring_merge(o_acc, lse_acc, *ring_fwd_hop(
                    qs[r], ks[src], vs[src]))
            o_r = o_acc.to(torch.bfloat16)
            o_err = max(o_err, _rel(o_r, cut(o_w, r)))
            lse_err = max(lse_err, (lse_acc - cut(lse_w, r)).abs().max().item())
            merged.append((o_r, lse_acc))
        dq_err = dk_err = dv_err = 0.0
        dks = [torch.zeros(BH, n, d, device=dev) for _ in range(sp)]
        dvs = [torch.zeros(BH, n, d, device=dev) for _ in range(sp)]
        for r, (o_r, lse_r) in enumerate(merged):
            di = row_dot(o_r, dos[r])
            dq = torch.zeros(BH, n, d, device=dev)
            for j in range(sp):
                src = (r - j) % sp
                dqh, dkh, dvh = ring_bwd_hop(qs[r], ks[src], vs[src], o_r,
                                             lse_r, dos[r], di)
                dq += dqh.float()
                dks[src] += dkh.float()
                dvs[src] += dvh.float()
            dq_err = max(dq_err, _rel(dq, cut(dq_w, r)))
        for j in range(sp):
            dk_err = max(dk_err, _rel(dks[j], cut(dk_w, j)))
            dv_err = max(dv_err, _rel(dvs[j], cut(dv_w, j)))
        hops += sp * sp
        # one hop's kernels and one merge, timed alone
        o_r, lse_r = merged[0]
        di = row_dot(o_r, dos[0])
        hop_out = [torch.empty_like(qs[0]) for _ in range(3)]
        hop_lse = torch.empty_like(lse_r)
        fwd_ms = _entry_ms("ea_flash_fwd_bf16", (qs[0], ks[1], vs[1]),
                           (hop_out[0], hop_lse), (BH, n, n, n, d))
        acc = o_r.float()  # merged in place again and again: acc stays bounded
        merge_ms = cuda_ms(lambda: ring_merge(acc, lse_r, o_r, lse_r), 5)
        ins = (qs[0], ks[1], vs[1], dos[0], lse_r, di)
        bwd_ms = (_entry_ms("ea_flash_bwd_dq_bf16", ins, (hop_out[0],),
                            (BH, n, n, n, d))
                  + _entry_ms("ea_flash_bwd_dkv_bf16", ins,
                              (hop_out[1], hop_out[2]), (BH, n, n, n, d)))
        st = {"shard_rows": n, "hops": sp * sp, "o_rel_err": o_err,
              "lse_max_abs_err": lse_err, "dq_rel_err": dq_err,
              "dk_rel_err": dk_err, "dv_rel_err": dv_err,
              "hop_fwd_ms": fwd_ms, "merge_ms": merge_ms,
              "hop_bwd_ms": bwd_ms,
              "fwd_sum_ms": sp * sp * (fwd_ms + merge_ms),
              "bwd_sum_ms": sp * sp * bwd_ms + whole["row_dot_ms"],
              "fwd_sum_over_one_call": sp * sp * (fwd_ms + merge_ms)
              / whole["fwd_ms"],
              "bwd_sum_over_one_call": (sp * sp * bwd_ms + whole["row_dot_ms"])
              / (whole["bwd_ms"] + whole["row_dot_ms"])}
        stats[f"sp{sp}"] = st
        del qs, ks, vs, dos, merged, dks, dvs, hop_out
        if not (o_err <= O_REL_BOUND and lse_err <= LSE_BOUND
                and max(dq_err, dk_err, dv_err) <= BWD_BOUND):
            raise AssertionError(f"parallel: the ring's hops at sp={sp} "
                                 f"disagree with one call: {st}")
    del q, k, v, do, o_w, lse_w, dq_w, dk_w, dv_w
    torch.cuda.empty_cache()
    return stats, 1 + hops


def _ulysses_slices(gen):
    """The Ulysses pass's per-rank body on one card: swa_streams_heads on
    heads [12r, 12r + 12) of the 12B's 48 (r < ULYSSES_SP) at its SWA
    shapes (text 256, video 13,104 tokens, batch 2), each head in the
    direction group of its global index, against the same heads of the
    48-head swa_attention_streams (K2 + the K1 cross pass), timed after a
    warm-up call. Returns stats; K1 and K2 each launch 2 + ULYSSES_SP
    times."""
    dev, d = DEVICE, HEAD_DIM

    def rand(n):
        return torch.randn(2, 48, n, d, generator=gen, device=dev
                           ).to(torch.bfloat16)

    txt = [rand(TEXT_LEN) for _ in range(3)]
    vid = [rand(S_VID) for _ in range(3)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    swa_attention_streams(*txt, *vid, **SWA_GRID)  # warm-up
    start.record()
    o_t, o_v = swa_attention_streams(*txt, *vid, **SWA_GRID)
    end.record()
    torch.cuda.synchronize()
    whole_ms = start.elapsed_time(end)
    count = 48 // ULYSSES_SP
    errs, slice_ms = [], []
    for r in range(ULYSSES_SP):
        heads = slice(r * count, (r + 1) * count)
        part = [x[:, heads].contiguous() for x in (*txt, *vid)]
        start.record()
        ot_r, ov_r = swa_streams_heads(*part, head_start=heads.start,
                                       num_heads=48, **SWA_GRID)
        end.record()
        torch.cuda.synchronize()
        slice_ms.append(start.elapsed_time(end))
        errs.append(max(_rel(ot_r, o_t[:, heads]), _rel(ov_r, o_v[:, heads])))
    out = {"sp": ULYSSES_SP, "heads_per_rank": count,
           "max_rel_err": max(errs), "bound": O_REL_BOUND,
           "whole_ms": whole_ms, "slice_ms": slice_ms,
           "shape": {"text": [2, 48, TEXT_LEN, d], "video": [2, 48, S_VID, d],
                     **SWA_GRID}}
    del txt, vid, o_t, o_v
    torch.cuda.empty_cache()
    if max(errs) > O_REL_BOUND:
        raise AssertionError(f"parallel: a Ulysses head slice disagrees with "
                             f"the 48-head call: {out}")
    return out


class _UnwrittenCheckpoints(CheckpointManager):
    """The driver's checkpoint save as it runs (a sharded state gathered
    to the host by the first data rank, the barrier) without writing the
    ~11 GB state to disk: the bytes it would write are recorded."""

    written = []

    def _write(self, step, state, sampler_state):
        self.written.append(state_bytes(state))


def _parallel_driver(seed, root, mesh):
    """train.train, the driver's loop, with arguments from the driver's own
    parser: SFT on the sft phase's model (the 12B's widths, 4 layers, 1-3
    SWA; random weights from `seed`, float32 masters, AdamW), batch 1 at
    HxWxFRAMES from a 2-video, 2-image manifest (file reads patched as in
    train_driver), the full MagViT (random), fixed random text. Three runs
    of PARALLEL_STEPS steps from the same weights and seeds: plain,
    --distributed (ZeRO-2 on the 1-rank NCCL mesh) and --distributed
    --fsdp (FSDP2 per block). In every run the watched masters (SFT_WATCH)
    moved and the model holds its masters (FSDP's parameters gathered).
    The sharded runs' losses and logged grad norms within TRAIN_LOSS_BOUND
    of the plain run's, and at least SIGN_AGREEMENT_BOUND of the masters'
    elements updated with the plain run's sign (a first Adam update is
    about lr * sign(g), so only a gradient within rounding of 0 may flip);
    the masters' largest distance from the plain run's is held only to
    the sanity ceiling of Adam's envelope (2 * lr * steps, + 1% for
    float32 rounding), which two runs from one start cannot leave.
    Returns the runs' stats."""
    cfg = dataclasses.replace(PRESETS["v5.1-12b"], num_layers=4,
                              swa_layers=(1, 2, 3))
    vae = init_random_(AutoencoderKLMagvit(
        MagvitVAEConfig(dtype="bfloat16", decode_chunk_frames=4),
        device="meta").to_empty(device=DEVICE),
        torch.Generator(device=DEVICE).manual_seed(seed))
    text = 0.02 * torch.randn(1, TEXT_LEN, cfg.text_embed_dim,
                              generator=torch.Generator(device=DEVICE)
                              .manual_seed(seed + 1), device=DEVICE)

    def encode_text(prompts):
        return {"text": text.expand(len(prompts), -1, -1)}

    def fresh():
        model = EasyAnimateTransformer3D(cfg, device="meta")
        return init_random_(model.to_empty(device=DEVICE),
                            torch.Generator(device=DEVICE).manual_seed(seed))

    entries = [{"file_path": f"clip{i}.mp4", "type": "video",
                "num_frames": 120, "text": f"{SERVE_PROMPT} take {i}"}
               for i in range(2)]
    entries += [{"file_path": f"still{i}.png", "type": "image",
                 "text": f"a still of the forest, number {i}"}
                for i in range(2)]
    meta = os.path.join(root, "train.json")
    with open(meta, "w") as f:
        json.dump(entries, f)
    argv = ["--train_data_meta", meta, "--train_data_dir", root,
            "--sample_height", str(H), "--sample_width", str(W),
            "--video_sample_n_frames", str(FRAMES),
            "--max_train_steps", str(PARALLEL_STEPS),
            "--dataloader_num_workers", "2", "--no-sanity_check",
            "--seed", str(seed)]
    patches = [(train_module, "CheckpointManager", _UnwrittenCheckpoints)]
    patches += [(dataset_module, k, v) for k, v in _media_reads(H, W).items()]
    originals = [(m, k, getattr(m, k)) for m, k, _ in patches]
    init = {n: p.detach().clone() for n, p in fresh().named_parameters()}
    runs, plain = {}, None
    try:
        for m, k, v in patches:
            setattr(m, k, v)
        for name, flags in (("plain", []), ("zero2", ["--distributed"]),
                            ("fsdp", ["--distributed", "--fsdp"])):
            model = fresh()
            args = train_module.parse_args(
                argv + ["--output_dir", os.path.join(root, name)] + flags)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _UnwrittenCheckpoints.written = []
            res = train_module.train(args, model, vae, encode_text, DEVICE,
                                     mesh if flags else None)
            torch.cuda.synchronize()
            out = {"flags": flags, "losses": res.losses, "s_per_step": res.step_s,
                   "save_s": res.save_s,
                   "checkpoint_bytes": _UnwrittenCheckpoints.written,
                   "max_memory_allocated_gib":
                       torch.cuda.max_memory_allocated() / 2**30}
            with open(os.path.join(root, name, "metrics.jsonl")) as f:
                out["grad_norms"] = [json.loads(line)["grad_norm"]
                                     for line in f if "grad_norm" in line]
            masters = res.state.params
            moved = {n: (masters[n] - init[n].float()).abs().max().item()
                     for n in SFT_WATCH}
            synced = all(torch.equal(
                p.full_tensor() if isinstance(p, DTensor) else p,
                masters[n].to(p.dtype)) for n, p in model.named_parameters())
            out.update(master_max_abs_change=moved,
                       model_matches_masters=synced)
            if not (all(v > 0 for v in moved.values()) and synced):
                raise AssertionError(f"parallel: train {flags}: the masters "
                                     "did not move or the model does not "
                                     f"hold them: {out}")
            if plain is None:
                plain = (res.losses, out["grad_norms"], masters)
                out["largest_update"] = max(
                    (masters[n] - init[n].float()).abs().max().item()
                    for n in masters)
            else:
                rel = lambda got, want: max(abs(a - b) / abs(b)
                                            for a, b in zip(got, want))
                loss_err = rel(res.losses, plain[0])
                norm_err = rel(out["grad_norms"], plain[1])
                param_err = max((masters[n] - plain[2][n]).abs().max().item()
                                for n in masters)
                agree = sum(((masters[n] - init[n].float()).sign()
                             == (plain[2][n] - init[n].float()).sign())
                            .sum().item() for n in masters) / sum(
                                t.numel() for t in masters.values())
                # sanity ceiling; + 1% for float32 rounding of master +- lr
                envelope = 2 * args.learning_rate * PARALLEL_STEPS * 1.01
                out.update(
                    loss_rel_err=loss_err, grad_norm_rel_err=norm_err,
                    master_max_abs_err=param_err, master_bound=envelope,
                    update_sign_agreement=agree,
                    sign_agreement_bound=SIGN_AGREEMENT_BOUND,
                    bit_equal=all(torch.equal(masters[n], plain[2][n])
                                  for n in masters),
                    loss_bound=TRAIN_LOSS_BOUND)
                if not (loss_err <= TRAIN_LOSS_BOUND
                        and norm_err <= TRAIN_LOSS_BOUND
                        and agree >= SIGN_AGREEMENT_BOUND
                        and param_err <= envelope):
                    raise AssertionError(f"parallel: train {flags} disagrees "
                                         f"with the plain run: {out}")
            if not (len(res.losses) == PARALLEL_STEPS
                    and all(map(math.isfinite, res.losses))):
                raise AssertionError(f"parallel: train {flags}: {out}")
            runs[name] = out
            del model, res, masters
    finally:
        for m, k, v in originals:
            setattr(m, k, v)
    del vae, init, plain
    torch.cuda.empty_cache()
    return runs


def phase_parallel(seed, root):
    """The multi-GPU path on one card: (a) init_distributed joins a 1-rank
    NCCL group (a file store under `root`) and create_mesh builds the
    (1, 1, 1) mesh; (b) the ring's hop code over V5.1's joint attention
    at sp 2 and 4 (_ring_hops); (c) the Ulysses head slices of the SWA
    pass (_ulysses_slices); (d) the driver's SFT steps plain, with
    --distributed (ZeRO-2) and with --distributed --fsdp
    (_parallel_driver). Returns the phase's launches."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    dev = init_distributed(f"file://{os.path.join(root, 'store')}", 1, 0)
    try:
        mesh = create_mesh(MeshConfig(dp=1, sp=1, tp=1))
        group = {"backend": str(dist.get_backend()), "device": str(dev),
                 "world_size": dist.get_world_size(), "mesh": mesh.shape,
                 "init_s": time.perf_counter() - t0}
        print(f"parallel: {group}", flush=True)
        ring, ring_launches = _ring_hops(gen)
        ulysses = _ulysses_slices(gen)
        runs = _parallel_driver(seed + 1, root, mesh)
    finally:
        dist.destroy_process_group()
    emit({"phase": "parallel", "group": group, "ring": ring,
          "ring_launches": {"K1": ring_launches, "K3": ring_launches,
                            "K4": ring_launches},
          "ulysses": ulysses, "train": runs,
          "note": "ring: one K1 and one K3 + K4 call over the whole "
                  "[96, 13360, 64] against sp shards' hops; *_ms of hops "
                  "and merges timed alone (CUDA events), *_sum_ms over the "
                  "sp^2 hops; bwd sums add one row_dot per call. train: "
                  "the driver's loop on a 1-rank NCCL mesh, checkpoints "
                  "gathered but not written"})
    launches = dict.fromkeys(COUNTERS, 0)
    launches.update(K1=ring_launches + 2 + ULYSSES_SP, K2=2 + ULYSSES_SP,
                    K3=ring_launches, K4=ring_launches)
    for key, n in SFT_LAUNCHES.items():
        launches[key] += 3 * PARALLEL_STEPS * n
    return launches


VAE_PAIRS, VAE_SIZE, VAE_FRAMES = 3, 256, 17  # examples/train_vae.py defaults


def phase_vae_train(seed):
    """make_vae_train_steps on the full V5.1 MagViT (MagvitVAEConfig(),
    float32, as JAX trains it), Discriminator3D() and LPIPS (VGG16), all
    random from `seed`, on a random 256x256x17 clip, batch 1: VAE_PAIRS
    ae_step + disc_step pairs with disc_start 1 (pair 1's ae_step has the
    GAN branch off, every later step on). s per step, peak; checks: finite
    losses, a positive adaptive weight once the GAN branch is on, the
    decoder's last conv and the discriminator moved. Out of memory fails
    the phase (the widths are not narrowed)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vae = init_random_(AutoencoderKLMagvit(MagvitVAEConfig(), device=DEVICE),
                       gen)
    disc = init_random_(Discriminator3D(device=DEVICE), gen)
    lpips = init_random_(LPIPS(device=DEVICE), gen).requires_grad_(False)
    cfg = tvt.VAETrainConfig(loss=VAELossConfig(disc_start=1))
    state = tvt.create_vae_train_state(vae, disc, cfg)
    ae, ds = tvt.make_vae_train_steps(vae, disc, cfg, lpips)
    batch = {"video": torch.rand((1, 3, VAE_FRAMES, VAE_SIZE, VAE_SIZE),
                                 generator=gen, device=DEVICE) * 2 - 1}
    last0 = vae.decoder.conv_out.weight.detach().clone()
    disc0 = disc.conv_in.weight.detach().clone()
    rows = []
    for i in range(VAE_PAIRS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = ae(state, batch, generator=gen)
        loss = aux["loss"].item()
        t1 = time.perf_counter()
        state, daux = ds(state, batch, generator=gen)
        d_loss = daux["disc_loss"].item()
        t2 = time.perf_counter()
        rows.append({"ae_s": t1 - t0, "disc_s": t2 - t1, "loss": loss,
                     "disc_loss": d_loss,
                     **{k: aux[k].item() for k in
                        ("l1", "l2", "perceptual", "kl", "g_loss",
                         "d_weight")}})
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = ((vae.decoder.conv_out.weight - last0).abs().max().item(),
             (disc.conv_in.weight - disc0).abs().max().item())
    out = {"phase": "vae_train", "pairs": rows,
           "max_memory_allocated_gib": peak,
           "vae_params": sum(p.numel() for p in vae.parameters()),
           "disc_params": sum(p.numel() for p in disc.parameters()),
           "lpips_params": sum(p.numel() for p in lpips.parameters()),
           "clip": [1, 3, VAE_FRAMES, VAE_SIZE, VAE_SIZE], "disc_start": 1,
           "max_abs_change": {"decoder.conv_out.weight": moved[0],
                              "disc.conv_in.weight": moved[1]}}
    emit(out)
    del state, vae, disc, lpips, batch
    torch.cuda.empty_cache()
    if not (len(rows) == VAE_PAIRS
            and all(math.isfinite(r["loss"]) and math.isfinite(r["disc_loss"])
                    for r in rows)
            and all(r["d_weight"] > 0 for r in rows[1:])
            and moved[0] > 0 and moved[1] > 0):
        raise AssertionError(f"vae_train: a check failed: {out}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="denoise steps per request (25: the headline run)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    phase_device()
    build = phase_build()
    stats = phase_kernels(torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    v4_stats = phase_kernels_v4(
        torch.Generator(device="cuda").manual_seed(args.seed + 300))
    torch.cuda.synchronize()
    legacy_stats = phase_kernels_legacy(
        torch.Generator(device="cuda").manual_seed(args.seed + 400))
    torch.cuda.synchronize()
    stats.update(phase_kernels_bwd(
        torch.Generator(device="cuda").manual_seed(args.seed + 100)))
    torch.cuda.synchronize()
    qstats = phase_quant_kernels(
        torch.Generator(device="cuda").manual_seed(args.seed + 200))
    torch.cuda.synchronize()
    phase_reference("t2v")
    phase_reference("i2v")
    phase_reference("v5")
    phase_reference("v4")
    phase_reference("legacy")
    torch.cuda.synchronize()
    phase_train_reference()
    torch.cuda.synchronize()

    totals = dict.fromkeys(COUNTERS, 0)
    # launches_sm90 of K1-K7 over the path runs
    totals_sm90 = dict.fromkeys(COUNTERS, 0)
    sm90_counters = {"K1": (flash_attention_fwd, K1_SM90),
                     "K2": (sliding_window_fwd, K2_SM90),
                     "K3": (flash_attention_bwd, K3_SM90),
                     "K4": (flash_attention_bwd, K4_SM90),
                     "K5": (swa_local_global_fwd, K5_SM90),
                     "K6": (sliding_window_bwd, K6_SM90),
                     "K7": (sliding_window_bwd, K7_SM90)}

    totals_q = dict.fromkeys(QCOUNTERS, 0)
    totals_by_dim = {}  # K1's launches over the path runs by head dim,
    sm90_by_dim = {}  # those on its TMA + wgmma kernels
    short_by_dim = {}  # and those on its short-head kernel

    def path_run(phase, fn, expect=None, expect_q=None, k1_dims=None,
                 k1_short=None):
        """One main-path run: counts set to 0 just before, read just after;
        every launch of K1-K7 ran its TMA + wgmma kernel (d 64; K1 also at
        V4's d 88 and V1-V3's d 72 and 144), `k1_short` of K1's (by head
        dim: V1-V3's passes over at most 64 q and kv rows) its short-head
        kernel flash_fwd_short_sm90; K1's launches by head dim are
        `k1_dims` (when given); Q1-Q3 launched `expect_q` times (none on a
        float model's path)."""
        k1_short = k1_short or {}
        reset_counts()
        result = fn()
        got = read_counts()
        if expect is not None and got != expect:
            raise AssertionError(f"{phase} launches {got} != {expect}")
        by_dim = dict(flash_attention_fwd.launches_by_dim)
        if k1_dims is not None and by_dim != k1_dims:
            raise AssertionError(f"{phase} K1 launches by head dim {by_dim} "
                                 f"!= {k1_dims}")
        for d, n in by_dim.items():
            totals_by_dim[d] = totals_by_dim.get(d, 0) + n
        got_q = {k: f.launches for k, f in QCOUNTERS.items()}
        if got_q != (expect_q or dict.fromkeys(QCOUNTERS, 0)):
            raise AssertionError(f"{phase} Q launches {got_q} != {expect_q}")
        for k, n in got_q.items():
            totals_q[k] += n
        for key, (counter, kernel) in sm90_counters.items():
            if counter.launches_sm90 != got[key]:
                raise AssertionError(f"{phase}: {counter.launches_sm90} of "
                                     f"{got[key]} {key} launches ran {kernel}"
                                     f" or another TMA + wgmma kernel")
            totals_sm90[key] += counter.launches_sm90
        got_short = {d: n for d, n in
                     flash_attention_fwd.launches_short_by_dim.items() if n}
        if (got_short != k1_short or flash_attention_fwd.launches_short
                != sum(got_short.values())):
            raise AssertionError(
                f"{phase}: K1 launches on flash_fwd_short_sm90 by head dim "
                f"{got_short}, expected {k1_short}")
        for counts, totals_d in (
                (flash_attention_fwd.launches_sm90_by_dim, sm90_by_dim),
                (flash_attention_fwd.launches_short_by_dim, short_by_dim)):
            for d, n in counts.items():
                totals_d[d] = totals_d.get(d, 0) + n
        for k, n in got.items():
            totals[k] += n
        torch.cuda.synchronize()
        return result

    # before the 12B, so nothing else is resident: three requests (loaded,
    # in-memory, fp8-loaded)
    phase_loader(args.seed + 20, path_run)
    model, vae = build_12b(args.seed)
    text_embeds = phase_text(args.seed + 21)

    pipe = EasyAnimatePipeline(model, vae)
    steps = args.steps
    serve = dict.fromkeys(COUNTERS, 0)
    for r in range(2):  # the second on the text phase's embeddings
        path_run("dense", lambda: request(
            "dense", pipe, args.seed + 1 + r, steps, COUNTERS,
            embeds=text_embeds if r else None),
            dict(serve, K1=48 * steps))
    del text_embeds
    swa_model = swa_variant(model)
    pipe = EasyAnimatePipeline(swa_model, vae)
    path_run("swa", lambda: request("swa", pipe, args.seed + 3, steps, COUNTERS),
             dict(serve, K1=48 * steps, K2=47 * steps))
    pipe = EasyAnimateInpaintPipeline(inpaint_variant(model, args.seed + 7), vae)
    path_run("i2v", lambda: request("i2v", pipe, args.seed + 8, steps, COUNTERS,
                                    **i2v_inputs(args.seed + 9)),
             dict(serve, K1=48 * steps))
    del pipe
    torch.cuda.empty_cache()
    # the control and samplers phases run NEW_PHASE_STEPS (PNDM 4, its
    # every PLMS order) to keep the run near its time budget
    new_steps, pndm_steps = min(steps, NEW_PHASE_STEPS), min(steps, 4)
    # control: video + reference (dense), the identity check (a control
    # and a T2V request), camera on the SWA variant
    expect_control = dict(
        serve, K1=48 * (2 * new_steps + 2 * CONTROL_IDENTITY_STEPS),
        K2=47 * new_steps)
    path_run("control", lambda: phase_control(model, vae, args.seed + 40,
                                              new_steps), expect_control)
    # Flow and the five other samplers, and DDIM again from the perturbed
    # noise; PNDM evaluates pndm_steps + 1 times
    expect_samplers = dict(serve, K1=48 * (6 * new_steps + pndm_steps + 1))
    path_run("samplers", lambda: phase_samplers(
        model, vae, args.seed + 50, new_steps, pndm_steps), expect_samplers)
    # the quantized block linears: a bf16 request, then int8, w4a8 and
    # int4 from the same weights (each quantized copy freed after it)
    expect_quant = dict(serve, K1=48 * new_steps * (1 + len(QUANT_MODES)))
    expect_quant_q = {k: sum(quant_launches(model.cfg, mode, new_steps)[k]
                             for mode in QUANT_MODES) for k in QCOUNTERS}
    quant = path_run("quant", lambda: phase_quant(
        model, vae, args.seed + 70, new_steps), expect_quant, expect_quant_q)
    torch.cuda.empty_cache()
    # requests through the controller; K1's count depends on TeaCache's
    # decisions, so the phase checks each request's launches itself
    expect_requests = path_run(
        "serve", lambda: phase_serve(model, vae, args.seed + 30, steps))
    torch.cuda.empty_cache()

    # the fused SWA path: forward K5 + K1 (text queries); backward K2 + K1
    # (the fused Function's recompute), K6/K7, and K3/K4 twice (its global
    # half and the text queries' cross pass)
    ins, cot = swa_fused_inputs(args.seed + 10)
    expect_fused = dict(serve, K1=2, K2=1, K3=2, K4=2, K5=1, K6=1, K7=1)
    fused = path_run("swa_fused", lambda: swa_fused_run(ins, cot, True),
                     expect_fused)
    phase_swa_fused(ins, cot, fused)
    del ins, cot, fused
    torch.cuda.empty_cache()

    # training: K1 runs twice per layer per step (forward + remat recompute)
    n = TRAIN_STEPS
    lora_dense = {"K1": 96, "K2": 0, "K3": 48, "K4": 48, "K5": 0, "K6": 0,
                  "K7": 0}
    lora_swa = {"K1": 96, "K2": 94, "K3": 48, "K4": 48, "K5": 0, "K6": 47,
                "K7": 47}
    path_run("lora_dense", lambda: phase_lora(
        "lora_dense", model, args.seed + 4, lora_dense))
    path_run("lora_swa", lambda: phase_lora(
        "lora_swa", swa_model, args.seed + 5, lora_swa))
    del swa_model
    torch.cuda.empty_cache()
    # V5 (EasyAnimateV5-12b-zh): the Bert and mT5-XL towers (freed before
    # the denoise), a DDIM request on both streams, then LoRA steps with
    # text_t5; the 12B's tensors are shared, V5's own ones added
    v5_embeds = phase_v5_text(args.seed + 90)
    v5_model = v5_variant(model, args.seed + 91)
    pipe = EasyAnimatePipeline(v5_model, vae, scheduler=DDIMConfig())
    (bert_pos, bert_neg), (t5_pos, t5_neg) = v5_embeds
    expect_v5 = dict(serve, K1=48 * steps)
    path_run("v5", lambda: request(
        "v5", pipe, args.seed + 92, steps, COUNTERS,
        embeds=(bert_pos, bert_neg),
        embeds_from="v5_text phase (Bert; mT5 as prompt_embeds_t5)",
        prompt_embeds_t5=t5_pos, negative_prompt_embeds_t5=t5_neg),
        expect_v5)
    del pipe, v5_embeds, bert_pos, bert_neg, t5_pos, t5_neg
    torch.cuda.empty_cache()
    emit({"phase": "v5_after_norm", **after_norm_ms(v5_model.cfg),
          "note": "fp32_layer_norm (PyTorch ops, no kernel of ours) at the "
                  "v5 request's CFG-batch shapes, CUDA events"})
    expect_lora_v5 = {k: LORA_V5_STEPS * n for k, n in lora_dense.items()}
    path_run("lora_v5", lambda: phase_lora(
        "lora_v5", v5_model, args.seed + 93, lora_dense, steps=LORA_V5_STEPS),
        expect_lora_v5)
    del v5_model
    torch.cuda.empty_cache()
    # the driver's loop on the dense 12B: LoRA steps from a manifest, a
    # checkpoint, a resume; its temporary directory is removed after it
    with tempfile.TemporaryDirectory() as root:
        expect_driver = path_run("train_driver", lambda: phase_train_driver(
            model, vae, args.seed + 60, root))
    # LCM distillation, then reward backprop (DRTune off, on) with the
    # CLIP-H scorer, and MPS and the aesthetic score on its frames
    expect_lcm = {k: LCM_STEPS * n for k, n in LCM_LAUNCHES.items()}
    path_run("lcm", lambda: phase_lcm(model, args.seed + 80), expect_lcm)
    expect_reward = {k: 2 * n for k, n in REWARD_LAUNCHES.items()}
    path_run("reward", lambda: phase_reward(model, vae, args.seed + 81),
             expect_reward)
    del model, vae
    torch.cuda.empty_cache()
    path_run("sft", lambda: phase_sft(args.seed + 6))
    # the multi-GPU path at world size 1: ring hops, Ulysses head slices,
    # the driver with --distributed and --distributed --fsdp
    with tempfile.TemporaryDirectory() as root:
        expect_parallel = path_run("parallel",
                                   lambda: phase_parallel(args.seed + 120, root))
    # the MagViT's GAN training: no attention kernel of ours (the mid
    # block's attention is plain)
    path_run("vae_train", lambda: phase_vae_train(args.seed + 82),
             dict.fromkeys(COUNTERS, 0))
    torch.cuda.empty_cache()
    # V4 (EasyAnimateV4): the HunyuanDiT at full width and depth, K1 on its
    # d 88 TMA + wgmma kernel; a T2V request, then an I2V one on the InP
    # variant with the CLIP branch
    v4_model, v4_vae = v4_models(args.seed + 94)
    pipe = EasyAnimatePipeline(v4_model, v4_vae, scheduler=DDIMConfig())
    expect_v4_t2v = dict(serve, K1=V4_K1_T2V * new_steps)
    sm90_before_v4 = totals_sm90["K1"]
    path_run("v4_t2v", lambda: v4_request("v4_t2v", pipe, args.seed + 95,
                                          new_steps), expect_v4_t2v)
    pipe = EasyAnimateInpaintPipeline(
        v4_inpaint_variant(v4_model, args.seed + 96), v4_vae,
        scheduler=DDIMConfig())
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed + 97)
    image = torch.randint(0, 256, (V4_H, V4_W, 3), generator=gen,
                          device=DEVICE, dtype=torch.uint8).cpu().numpy()
    video, mask = get_image_to_video_latent(image, None, V4_FRAMES,
                                            (V4_H, V4_W))
    v4_i2v = dict(video=video, mask_video=mask,
                  clip_encoder_hidden_states=torch.randn(
                      1, V4_CLIP_N, V4_CLIP_DIM, generator=gen, device=DEVICE),
                  clip_apply_ratio=V4_CLIP_RATIO)
    expect_v4_i2v = dict(serve, K1=V4_K1_I2V * new_steps)
    path_run("v4_i2v", lambda: v4_request("v4_i2v", pipe, args.seed + 98,
                                          new_steps, **v4_i2v), expect_v4_i2v)
    v4_sm90 = totals_sm90["K1"] - sm90_before_v4
    del pipe, v4_model, v4_vae, v4_i2v, video, mask
    torch.cuda.empty_cache()
    v4_k1 = expect_v4_t2v["K1"] + expect_v4_i2v["K1"]
    # V1-V3 (EasyAnimateV1-V3) and PixArt: the Transformer3D at full width
    # and depth from each yaml's fields, DDIM; K1 at d 72 (its persistent
    # walk past 64 q rows, the short-head kernel for V3's temporal passes)
    # and d 144 (V1's and V2's motion modules, the short-head kernel)
    expect_legacy, legacy_sm90 = {}, 0
    for i, edition in enumerate(("v3", "v2", "v1", "pixart")):
        model_l, vae_l = legacy_models(edition, args.seed + 110 + 2 * i)
        pipe = (PixArtMagvitPipeline if edition == "pixart"
                else EasyAnimatePipeline)(model_l, vae_l,
                                          scheduler=DDIMConfig())
        per_eval, short = LEGACY_K1[edition]
        dims = {d: n * new_steps for d, n in per_eval.items()}
        expect_legacy[edition] = dict(serve, K1=sum(dims.values()))
        phase = "pixart" if edition == "pixart" else f"{edition}_t2v"
        sm90_before = totals_sm90["K1"]
        path_run(phase, lambda: legacy_request(
            phase, pipe, args.seed + 111 + 2 * i, new_steps,
            LEGACY_FRAMES[edition]), expect_legacy[edition], k1_dims=dims,
            k1_short={d: n * new_steps for d, n in short.items()})
        legacy_sm90 += totals_sm90["K1"] - sm90_before
        del pipe, model_l, vae_l
        torch.cuda.empty_cache()
    legacy_k1 = sum(e["K1"] for e in expect_legacy.values())
    n_sft = sum(steps for _, _, steps in SFT_VARIANTS)
    expect_train = {k: n * (lora_dense[k] + lora_swa[k])
                    + n_sft * SFT_LAUNCHES[k] + expect_driver[k]
                    + expect_lcm[k] + expect_reward[k] for k in COUNTERS}
    expect_serve = {"K1": 4 * 48 * steps, "K2": 47 * steps}
    # three requests and two latent-only ones (int8, w4a8)
    expect_loader = {k: 5 * n for k, n in LOADER_LAUNCHES.items()}
    want = {k: expect_train.get(k, 0) + expect_serve.get(k, 0)
            + expect_loader.get(k, 0) + expect_fused[k]
            + expect_requests.get(k, 0) + expect_control[k]
            + expect_samplers[k] + expect_quant[k] + expect_v5[k]
            + expect_lora_v5[k] + expect_v4_t2v[k] + expect_v4_i2v[k]
            + sum(e[k] for e in expect_legacy.values()) + expect_parallel[k]
            for k in COUNTERS}
    if totals != want or not all(totals.values()):
        raise AssertionError(f"path launches {totals} != {want}")
    loader_cfg = dataclasses.replace(PRESETS["v5.1-12b"], num_layers=2)
    want_q = {k: expect_quant_q[k] + sum(
        quant_launches(loader_cfg, mode, LOADER_STEPS)[k]
        for mode in ("int8", "w4a8")) for k in QCOUNTERS}
    if totals_q != want_q or not all(totals_q.values()):
        raise AssertionError(f"path Q launches {totals_q} != {want_q}")

    bounds = kernel_bounds()
    library = {"K1": stats["K1"]["sdpa_ms"], "K2": stats["K2"]["library_ms"],
               "K3": stats["K3"]["sdpa_bwd_ms"], "K4": stats["K4"]["sdpa_bwd_ms"],
               "K5": None, "K6": stats["K6"]["library_bwd_ms"],
               "K7": stats["K7"]["library_bwd_ms"]}

    def row(key, name, src, replaces):
        st = stats[key]
        out = {"name": f"{key} {name}", "route": "cuda",
               "source": f"easyanimate_tpu_torch/csrc/{src}",
               "replaces": replaces, "launches": totals[key],
               "max_abs_err": st["max_abs_err"], "ms": st["ms"],
               "plain_ms": st["plain_ms"], "bound_ms": bounds[key][0],
               "bound_by": bounds[key][1], "library_ms": library[key]}
        if "max_rel_err" in st:
            out["max_rel_err"] = st["max_rel_err"]
        return out

    def sm90_row(out, key, sources, flops, cross_library=None):
        """`out`, a TMA + wgmma kernel's row, with its path launches on that
        kernel, rate (`flops`: the operations of the timed call) and share
        of the bound at the flagship (and at the SWA cross pass, for the
        dense kernels), ptxas and SASS."""
        ptxas, st = build[key]["ptxas"], stats[key]
        out.update(
            sources=[f"easyanimate_tpu_torch/csrc/{f}"
                     for f in (*sources, "hopper.cuh")],
            kernel=sm90_counters[key][1], launches_sm90=totals_sm90[key],
            tflops=flops / out["ms"] / 1e9,
            share_of_bound=bounds[key][0] / out["ms"],
            registers=ptxas.get("registers"),
            spill_bytes=(ptxas.get("spill_store_bytes", 0)
                         + ptxas.get("spill_load_bytes", 0)),
            sass=build[key]["sass"])
        if cross_library is not None:
            out.update(
                cross_ms=st["cross_ms"], cross_plain_ms=st["cross_plain_ms"],
                cross_bound_ms=bounds[key + " cross"][0],
                cross_bound_by=bounds[key + " cross"][1],
                cross_library_ms=st[cross_library],
                cross_share_of_bound=bounds[key + " cross"][0] / st["cross_ms"])
        return out

    def q_row(key, name, replaces):
        """A quantized linear's pass: it replaces no TPU kernel (`replaces`
        names the XLA ops of the JAX package it stands for); no single
        PyTorch call computes it (library_ms null); the bf16 F.linear at
        the 12B's widths is its yardstick."""
        st = qstats[key]
        return {"name": f"{key} {name}", "route": "cuda",
                "source": "easyanimate_tpu_torch/csrc/quant.cu",
                "replaces": replaces, "replaces_kind": "XLA ops, no pallas_call",
                "launches": totals_q[key], "max_abs_err": st["max_abs_err"],
                "ms": st["ms"], "plain_ms": st["plain_ms"],
                "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
                "library_ms": None, "shape": st["shape"],
                "share_of_bound": st["bound_ms"] / st["ms"],
                "cases": [{k: c[k] for k in ("case", "ms", "plain_ms",
                                             "bound_ms", "max_abs_err")}
                          for c in st["cases"]],
                "linear_ms_at_12b_widths": qstats["linears"]}

    dense = 2 * BH * S_DENSE ** 2 * HEAD_DIM     # one dense product
    band = 2 * BH * band_columns(S_VID, WINDOW) * HEAD_DIM
    glob = 2 * BH * S_VID * S_GLOBAL * HEAD_DIM  # one global-pass product

    # K1 at d 88 (V4): its own row, its own TMA + wgmma kernel; K1's row
    # keeps its d 64 launches
    k1_row = sm90_row(row("K1", "flash_attention_fwd", "flash_fwd.cu",
                          "easyanimate_tpu/ops/flash_attention.py:92"),
                      "K1", ("flash_fwd.cu", "fwd_sm90.cuh"), 2 * dense,
                      "cross_sdpa_ms")
    k1_row["launches"] -= v4_k1 + legacy_k1
    k1_row["launches_sm90"] -= v4_sm90 + legacy_sm90
    self88, ptxas88 = v4_stats["shapes"]["self"], build["K1@88"]["ptxas"]
    k1_88_row = {
        "name": "K1@88 flash_attention_fwd (d 88, V4)", "route": "cuda",
        "source": "easyanimate_tpu_torch/csrc/flash_fwd.cu",
        "sources": ["easyanimate_tpu_torch/csrc/flash_fwd.cu",
                    "easyanimate_tpu_torch/csrc/fwd_split_sm90.cuh",
                    "easyanimate_tpu_torch/csrc/hopper.cuh"],
        "replaces": "easyanimate_tpu/ops/flash_attention.py:92",
        "launches": v4_k1, "launches_sm90": v4_sm90, "kernel": K1_D88_SM90,
        "max_abs_err": v4_stats["max_abs_err"],
        "max_rel_err": v4_stats["max_rel_err"], "ms": self88["ms"],
        "plain_ms": self88["plain_ms"], "bound_ms": self88["bound_ms"],
        "bound_by": self88["bound_by"], "library_ms": self88["sdpa_ms"],
        "shape": self88["shape"], "tflops": self88["tflops"],
        "share_of_bound": self88["share_of_bound"],
        "shapes": v4_stats["shapes"],
        "registers": ptxas88.get("registers"),
        "spill_bytes": (ptxas88.get("spill_store_bytes", 0)
                        + ptxas88.get("spill_load_bytes", 0)),
        "sass": build["K1@88"]["sass"]}

    def legacy_row(d, case, kernel, sources, main_key):
        """K1 at the V1-V3 head dim d: its path launches (all on TMA +
        wgmma kernels, `launches_short` of them on the short-head one),
        ms, plain, SDPA and bound at `case`'s shape, every shape's in
        `shapes` (with the kernel each ran); registers and spills of
        `main_key`'s kernel (the one `case` ran) and of the short-head
        kernel at d."""
        st, main_case = legacy_stats[d], legacy_stats[d]["shapes"][case]
        ptxas = build[main_key]["ptxas"]
        short = build[f"K1 short@{d}"]["ptxas"]
        n, sm90 = totals_by_dim.get(d, 0), sm90_by_dim.get(d, 0)
        return {
            "name": f"K1@{d} flash_attention_fwd (d {d}, V1-V3)",
            "route": "cuda",
            "source": "easyanimate_tpu_torch/csrc/flash_fwd.cu",
            "sources": [f"easyanimate_tpu_torch/csrc/{f}" for f in sources],
            "replaces": "easyanimate_tpu/ops/flash_attention.py:92",
            "launches": n, "launches_sm90": sm90,
            "launches_short": short_by_dim.get(d, 0),
            "launches_mma_sync": n - sm90,
            "kernel": kernel, "max_abs_err": st["max_abs_err"],
            "max_rel_err": st["max_rel_err"], "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["sdpa_ms"], "shape": main_case["shape"],
            "share_of_bound": main_case["share_of_bound"],
            "shapes": st["shapes"], "registers": ptxas.get("registers"),
            "spill_bytes": (ptxas.get("spill_store_bytes", 0)
                            + ptxas.get("spill_load_bytes", 0)),
            "short_kernel": {
                "kernel": K1_SHORT[d],
                "registers": short["registers"],
                "spill_bytes": sum(short.get(k, 0) for k in (
                    "spill_store_bytes", "spill_load_bytes"))}}

    k1_72_row = legacy_row(
        72, "K1@72 Global_Self",
        f"{K1_D72_SM90} (+ flash_fwd_short_sm90<72>)",
        ("flash_fwd.cu", "fwd_split_sm90.cuh", "fwd_short_sm90.cuh",
         "hopper.cuh"), "K1@72")
    k1_72_row["big_bh_ms"] = legacy_stats[72]["big_bh_ms"]
    k1_144_row = legacy_row(
        144, "K1@144 V2 temporal", "flash_fwd_short_sm90<144>",
        ("flash_fwd.cu", "fwd_short_sm90.cuh", "hopper.cuh"),
        "K1 short@144")
    for r in (k1_row, k1_88_row, k1_72_row, k1_144_row):
        if r["launches"] != r["launches_sm90"]:
            raise AssertionError(f"{r['name']} launches {r['launches']} != "
                                 f"sm90 {r['launches_sm90']}")
    if (totals_by_dim.get(64, 0) != k1_row["launches"]
            or totals_by_dim.get(88, 0) != k1_88_row["launches"]
            or k1_72_row["launches"] + k1_144_row["launches"] != legacy_k1
            or legacy_sm90 != legacy_k1
            or not k1_72_row["launches_short"]
            or k1_144_row["launches_short"] != k1_144_row["launches"]
            or not k1_144_row["launches"]):
        raise AssertionError(f"K1 launches by head dim {totals_by_dim}, on "
                             f"the short-head kernel {short_by_dim}")

    emit({"kernels": [
        k1_row | {"v5_ms": stats["K1"]["v5_ms"],
                  "v5_shape": stats["K1"]["v5_shape"]},
        k1_88_row, k1_72_row, k1_144_row,
        sm90_row(row("K2", "sliding_window_fwd", "swa_fwd.cu",
                     "easyanimate_tpu/ops/swa.py:32"),
                 "K2", ("swa_fwd.cu", "fwd_sm90.cuh"), 2 * band),
        sm90_row(row("K3", "flash_attention_bwd (dq)", "flash_bwd.cu",
                     "easyanimate_tpu/ops/flash_attention.py:228"),
                 "K3", ("flash_bwd.cu", "bwd_sm90.cuh"), 3 * dense,
                 "cross_sdpa_bwd_ms"),
        sm90_row(row("K4", "flash_attention_bwd (dk, dv)", "flash_bwd.cu",
                     "easyanimate_tpu/ops/flash_attention.py:267"),
                 "K4", ("flash_bwd.cu", "bwd_sm90.cuh"), 4 * dense,
                 "cross_sdpa_bwd_ms"),
        sm90_row(row("K5", "swa_local_global_fwd", "swa_fused_fwd.cu",
                     "easyanimate_tpu/ops/swa.py:159"),
                 "K5", ("swa_fused_fwd.cu", "fwd_sm90.cuh"),
                 2 * band + 2 * glob)
        | {"unfused_pair_ms": stats["K5"]["unfused_pair_ms"]},
        sm90_row(row("K6", "sliding_window_bwd (dq)", "swa_bwd.cu",
                     "easyanimate_tpu/ops/swa.py:393"),
                 "K6", ("swa_bwd.cu", "bwd_sm90.cuh"), 3 * band),
        sm90_row(row("K7", "sliding_window_bwd (dk, dv)", "swa_bwd.cu",
                     "easyanimate_tpu/ops/swa.py:429"),
                 "K7", ("swa_bwd.cu", "bwd_sm90.cuh"), 4 * band),
        q_row("Q1", "quantize_rows", "easyanimate_tpu/ops/quant.py:35"),
        q_row("Q2", "dequantize_rows", "easyanimate_tpu/ops/quant.py:42"),
        q_row("Q3", "unpack_int4_weight", "easyanimate_tpu/ops/quant.py:102"),
    ], "note": "max_abs_err: max |kernel - plain| over the cases (o for "
               "K1/K2/K5, dq/dk/dv for K3-K7, do ~ N(0, 1)); max_rel_err: "
               "over max |plain|, the bound's measure. K1, K3, K4: ms at "
               "the dense flagship, cross_* at the SWA cross pass (13360 x "
               "1027), v5_ms at the V5 12B's joint length (13437), library "
               "= SDPA (its backward for K3/K4); K2's, "
               "K5's, K6's and K7's tflops count the band's visible pairs; "
               "every path launch of K1-K7 at d 64 ran their TMA + wgmma "
               "kernels (launches_sm90); K1@88 (V4's head dim, its own TMA + "
               "wgmma kernel): ms, plain_ms, library_ms (SDPA) and bound at "
               "V4's self attention [32, 36864, 88], shapes[] also at its "
               "text (333) and CLIP (16) cross passes. K1@72 (V1-V3's head "
               "dim; its persistent walk past 64 q rows, the short-head "
               "kernel for the temporal passes over 36 frames): ms, plain, "
               "SDPA and bound at V3's Global_Self [32, 36864, 72], shapes[] "
               "also at the spatial, text and temporal passes, each with "
               "the kernel it ran (route); big_bh_ms at b*h 73728. K1@144 "
               "(V1's and V2's motion modules, the short-head kernel): at "
               "V2's temporal pass [16384, 36, 144], shapes[] also at V1's "
               "grid [4096, 64, 144]. K3/K4 and K6/K7 "
               "plain_ms and library_ms: one plain pass, and one SDPA "
               "backward (K6/K7: with the boolean band mask), compute both "
               "kernels' gradients. K2 library_ms: SDPA with the band mask. "
               "K5: no single PyTorch call computes it (library_ms null); "
               "unfused_pair_ms, K2 + the K1 cross pass on the same "
               "inputs, is its yardstick. Q1-Q3 (csrc/quant.cu) replace no "
               "TPU kernel: the passes around the quantized linears' "
               "library products; ms at the first case's shape, bound by "
               "bytes; linear_ms_at_12b_widths: each mode's whole linear "
               "and F.linear in bf16 (yardstick) over 26,208 tokens"})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
