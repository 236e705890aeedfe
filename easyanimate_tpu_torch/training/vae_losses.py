"""VAE training losses: LPIPS + KL + patch-GAN with an adaptive weight.

Parity: easyanimate_tpu/training/vae_losses.py (reference
vae/ldm/modules/losses/contperceptual.py: L1 + L2 reconstruction, the
perceptual term, KL with the posterior-outlier penalty, the adaptive GAN
weight from last-layer gradient norms, disc_start gating; and
vaemodules/discriminator.py's PatchGAN Discriminator2D / 3D).

Channels-first throughout: videos (B, C, T, H, W), frames (N, C, H, W);
the JAX package is channels-last, so the outlier penalty's spatial axes
are (3, 4) here. Kept from the Flax modules: GroupNorm eps 1e-6, the
population std, and the VGG feature taps after conv layers 1, 4, 8 and 12
(the JAX tap list's 16 is past the 13th conv and never read), so LPIPS
has four linear heads. With random weights the losses are still defined
(lin heads start at 1, as the JAX init does).
"""
import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models.vae import gaussian_kl

_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512)
_FEATURE_TAPS = (1, 4, 8, 12, 16)  # conv indices after which features are read
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_GN_EPS = 1e-6
_TV_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _n_convs() -> int:
    return sum(1 for c in _VGG_CFG if c != "M")


def _tap_channels():
    chans = [c for c in _VGG_CFG if c != "M"]
    return [chans[i] for i in _FEATURE_TAPS if i < len(chans)]


class VGG16Features(nn.Module):
    """VGG16's conv stack (3 x 3, pad 1, ReLU; 2 x 2 max-pools); returns the
    activations at the taps."""

    def __init__(self, **fk):
        super().__init__()
        cin = 3
        for i, c in enumerate(c for c in _VGG_CFG if c != "M"):
            setattr(self, f"conv{i}", nn.Conv2d(cin, c, 3, padding=1, **fk))
            cin = c

    def forward(self, x):
        feats, conv_i = [], 0
        for c in _VGG_CFG:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"conv{conv_i}")(x))
            if conv_i in _FEATURE_TAPS:
                feats.append(x)
            conv_i += 1
        return feats


class _Lin(nn.Module):
    def __init__(self, channels: int, **fk):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, **fk))


class LPIPS(nn.Module):
    """Perceptual distance; inputs (N, 3, H, W) in [-1, 1] -> (N,)."""

    def __init__(self, device=None):
        super().__init__()
        fk = dict(device=resolve_device(device))
        self.vgg = VGG16Features(**fk)
        self.lins = nn.ModuleList([_Lin(c, **fk) for c in _tap_channels()])

    def forward(self, x, y):
        shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
        fx = self.vgg((x - shift) / scale)
        fy = self.vgg((y - shift) / scale)
        total = 0.0
        for lin, a, b in zip(self.lins, fx, fy):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True),
                                min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True),
                                min=1e-10)
            d = (a - b).square() * lin.weight.abs().view(1, -1, 1, 1)
            total = total + d.sum(dim=1, keepdim=True).mean(dim=(1, 2, 3))
        return total


def _f32(v) -> torch.Tensor:
    v = v if isinstance(v, torch.Tensor) else np.array(v)
    return torch.as_tensor(v, dtype=torch.float32).contiguous()


def convert_lpips_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """torch `lpips.LPIPS(net='vgg')` / torchvision vgg16 weights
    (`net.features.N.*` or `features.N.*`, `lin{i}.model.1.weight` or
    `lins.{i}.model.1.weight`) -> LPIPS's state dict; what is missing keeps
    the module's own values (load with strict=False)."""
    out = {}
    for ci, ti in enumerate(_TV_CONV_INDEX[:_n_convs()]):
        for cand in (f"net.features.{ti}.weight", f"features.{ti}.weight"):
            if cand in sd:
                out[f"vgg.conv{ci}.weight"] = _f32(sd[cand])
                out[f"vgg.conv{ci}.bias"] = _f32(sd[cand[:-len("weight")]
                                                    + "bias"])
    for i in range(len(_tap_channels())):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if cand in sd:
                out[f"lins.{i}.weight"] = _f32(sd[cand])[0, :, 0, 0]
    return out


def _conv_kernel(a: np.ndarray) -> np.ndarray:
    """Flax HWIO / DHWIO -> torch OIHW / OIDHW."""
    return a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax tree of LPIPS or a discriminator ({"params": ...} or its inner
    dict) -> the port module's state dict: conv kernels transposed,
    GroupNorm scale -> weight, LPIPS's `lin{i}` -> `lins.{i}.weight`."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            a = np.array(v, np.float32)
            name = path + (k,)
            if k == "kernel":
                a, name = _conv_kernel(a), path + ("weight",)
            elif k == "scale":
                name = path + ("weight",)
            elif not path and k.startswith("lin"):
                name = ("lins", k[len("lin"):], "weight")
            out[".".join(name)] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params.get("params", params), ())
    return out


class _PatchGAN(nn.Module):
    """conv_in (+ bias) -> leaky ReLU; num_layers x [conv (no bias) ->
    GroupNorm(min(32, ch), eps 1e-6) -> leaky ReLU], stride 2 but the last;
    conv_out to one channel."""

    def __init__(self, conv, kernel, stride2, stride1, padding,
                 base_channels: int, num_layers: int, device=None):
        super().__init__()
        fk = dict(device=resolve_device(device))
        self.conv_in = conv(3, base_channels, kernel, stride=stride2,
                            padding=padding, **fk)
        ch = base_channels
        for i in range(1, num_layers + 1):
            out = min(base_channels * 2 ** i, 512)
            setattr(self, f"conv{i}", conv(
                ch, out, kernel, stride=stride2 if i < num_layers else stride1,
                padding=padding, bias=False, **fk))
            setattr(self, f"norm{i}", nn.GroupNorm(min(32, out), out,
                                                   eps=_GN_EPS, **fk))
            ch = out
        self.num_layers = num_layers
        self.conv_out = conv(ch, 1, kernel, stride=stride1, padding=padding,
                             **fk)

    def forward(self, x):
        x = F.leaky_relu(self.conv_in(x), 0.2)
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x))
            x = F.leaky_relu(x, 0.2)
        return self.conv_out(x)


class Discriminator2D(_PatchGAN):
    """PatchGAN over frames: (N, C, H, W) -> logits map."""

    def __init__(self, base_channels: int = 64, num_layers: int = 3,
                 device=None):
        super().__init__(nn.Conv2d, 4, 2, 1, 1, base_channels, num_layers,
                         device)


class Discriminator3D(_PatchGAN):
    """PatchGAN over clips: (B, C, T, H, W) -> logits map."""

    def __init__(self, base_channels: int = 64, num_layers: int = 3,
                 device=None):
        super().__init__(nn.Conv3d, (3, 4, 4), (1, 2, 2), 1, 1,
                         base_channels, num_layers, device)


def hinge_d_loss(real_logits, fake_logits):
    return 0.5 * (torch.mean(F.relu(1.0 - real_logits))
                  + torch.mean(F.relu(1.0 + fake_logits)))


def hinge_g_loss(fake_logits):
    return -torch.mean(fake_logits)


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    kl_weight: float = 1e-6
    l1_weight: float = 1.0
    l2_weight: float = 0.1
    perceptual_weight: float = 1.0
    disc_weight: float = 0.5
    disc_start: int = 50001
    outlier_penalty: float = 1e5  # weight (contperceptual.py:13)
    outlier_penalty_r: float = 3.0  # std multiples before the penalty


def _frames(video: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B * T, C, H, W)."""
    b, c, t, h, w = video.shape
    return video.transpose(1, 2).reshape(b * t, c, h, w)


def reconstruction_loss(cfg: VAELossConfig, inputs, recon,
                        lpips_fn: Optional[Callable] = None
                        ) -> Tuple[torch.Tensor, dict]:
    """inputs / recon: (B, C, T, H, W) in [-1, 1] -> (loss, aux)."""
    diff = inputs.float() - recon.float()
    l1, l2 = diff.abs(), diff.square()
    rec = cfg.l1_weight * l1 + cfg.l2_weight * l2
    aux = {"l1": l1.mean(), "l2": l2.mean()}
    if lpips_fn is not None and cfg.perceptual_weight > 0:
        p = lpips_fn(_frames(inputs), _frames(recon))
        rec = rec + cfg.perceptual_weight * p.mean()
        aux["perceptual"] = p.mean()
    return rec.mean(), aux


def outlier_penalty_loss(x: torch.Tensor, r: float) -> torch.Tensor:
    """Posterior-mode outlier penalty (contperceptual.py:56-66): per-frame
    spatial mean and population std; |x - mean| beyond r stds, summed over
    the frame and averaged. x: (B, C, T, H, W)."""
    x = x.float()
    std, mean = torch.std_mean(x, dim=(3, 4), keepdim=True, correction=0)
    penalty = F.relu((x - mean).abs() - r * std)
    return torch.mean(penalty.sum(dim=(3, 4)) / (x.shape[3] * x.shape[4]))


def kl_and_outlier_loss(cfg: VAELossConfig, moments) -> torch.Tensor:
    """KL against N(0, I) plus the posterior-outlier penalty on the mode
    (contperceptual.py:56-66, :104); moments (B, 2C, T, H, W)."""
    moments = moments.float()
    outlier = outlier_penalty_loss(moments.chunk(2, dim=1)[0],
                                   cfg.outlier_penalty_r)
    return (cfg.kl_weight * gaussian_kl(moments).mean()
            + cfg.outlier_penalty * outlier)


def adaptive_gan_weight(nll_grad_norm, gan_grad_norm,
                        disc_weight: float) -> torch.Tensor:
    """d_weight = |grad nll| / (|grad gan| + 1e-4), clipped to [0, 1e4],
    times disc_weight (contperceptual.py:43-54)."""
    w = nll_grad_norm / (gan_grad_norm + 1e-4)
    return torch.clamp(w, 0.0, 1e4) * disc_weight
