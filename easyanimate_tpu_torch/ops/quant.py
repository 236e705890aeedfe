"""Quantized block linears: W8A8 int8, W4A16 and W4A8 packed int4.

Parity: easyanimate_tpu/ops/quant.py, with its function names, in the
port's [out, in] weight layout: an int8 weight is [out, in] with a float32
scale [out]; a packed int4 weight is [out, in // 2] (in-features 2k and
2k + 1 are the low and high nibble of byte k, JAX's packed [in // 2, out]
transposed) with a float32 scale [out, groups] (JAX's [groups, out]
transposed).

  "int8"  W8A8: per-out-channel int8 weights, per-token dynamic int8
          activations, an int8 x int8 -> int32 product, dequantized in
          float32 as acc * (ax / 127) * w_scale + bias (JAX's order).
  "int4"  W4A16: group-128 packed int4 weights, dequantized to the compute
          dtype for a float product.
  "w4a8"  the same packed int4 parameters, regridded per call onto one
          per-channel int8 grid (s8 = max(max_g s_g, 1e-12) * 8/127,
          q8 = round(q4 * s_g / s8)), then the W8A8 product.

Three hand-written CUDA kernels (csrc/quant.cu) do the passes around the
products; they replace no TPU kernel (JAX leaves these passes to XLA):
  Q1 quantize_rows       bf16 [M, K] -> int8 [M, K] + float32 absmax [M, 1]
  Q2 dequantize_rows     int32 [M, N] -> bf16 [M, N]
  Q3 unpack_int4_weight  packed [N, K/2] + scale [N, groups] -> bf16 [N, K],
                         or int8 [N, K] + s8 [N] (the W4A8 regrid)
Each has its plain PyTorch version beside it, which a CPU tensor takes; a
CUDA tensor launches the kernel or raises. `<wrapper>.launches` counts the
kernel's launches. The products themselves stay library calls, as the JAX
package left them to XLA's dot_general: torch._int_mm for int8 x int8 ->
int32 (on the card: M > 16, K and N multiples of 8, its second operand
column-major, which `weight.t()` of the row-major [out, in] weight is; a
shape it refuses raises) and F.linear on the dequantized weight for W4A16.

Divisions by a constant go through a 0-dim tensor on the operand's device
(`_const`): PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, which can differ from JAX's division in the last bit.
"""
import dataclasses
import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import _build

QUANT_MODES = ("int8", "int4", "w4a8")
GROUP_INT4 = 128

# the block linears JAX routes through ops/quant.py (its _QUANT_PARENTS,
# easyanimate_tpu/ops/quant.py:174-182), by the port's module path: both
# streams' q, k, v and out projections and both FFN linears of every block
BLOCK_LINEARS = (r"transformer_blocks\.\d+\.(attn1|attn2)\.(to_[qkv]|to_out\.0)$"
                 r"|transformer_blocks\.\d+\.(txt_ff|ff)\.net\.(0\.proj|2)$")

Pair = Tuple[torch.Tensor, torch.Tensor]


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _int4_groups(fan_in: int) -> int:
    return fan_in // GROUP_INT4 if fan_in % GROUP_INT4 == 0 else 1


# --- weight quantizers (once, at load) --------------------------------------


def quantize_weight_int8(w: torch.Tensor) -> Pair:
    """[..., out, in] float -> (int8 [..., out, in], float32 scale
    [..., out]): symmetric per-out-channel absmax / 127, floored at 1e-12."""
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=-1) / _const(w, 127.0), 1e-12)
    wq = torch.round(w / scale[..., None]).to(torch.int8)
    return wq, scale


quantize_weight = quantize_weight_int8


def quantize_weight_int4(w: torch.Tensor) -> Pair:
    """[..., out, in] float -> (int8 packed [..., out, in // 2], two nibbles
    a byte, float32 scale [..., out, groups]): symmetric per-(out channel,
    group of 128 in-features) absmax / 7, one group when in is not a
    multiple of 128; in-features 2k / 2k + 1 are the low / high nibble of
    byte k."""
    w = w.float()
    *lead, out, fan_in = w.shape
    if fan_in % 2:
        raise ValueError(f"int4 packing needs even fan_in, got {fan_in}")
    groups = _int4_groups(fan_in)
    wg = w.reshape(*lead, out, groups, fan_in // groups)
    scale = torch.clamp_min(wg.abs().amax(dim=-1) / _const(w, 7.0), 1e-12)
    q = torch.clamp(torch.round(wg / scale[..., None]), -8, 7)
    q = q.reshape(*lead, out, fan_in // 2, 2).to(torch.int8)
    packed = (q[..., 0] & 0xF) | (q[..., 1] << 4)
    return packed, scale


def unpack_int4(packed: torch.Tensor, fan_in: int) -> torch.Tensor:
    """int8 packed [..., out, in // 2] -> int8 [..., out, in] in [-8, 7]
    (arithmetic shifts sign-extend each nibble)."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], fan_in)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 packed [..., out, in // 2] + float32 scale [..., out, groups] ->
    float32 [..., out, in]: the one inverse of the nibble and group layout
    (the products and the LoRA merge use it alike)."""
    fan_in = packed.shape[-1] * 2
    groups = scale.shape[-1]
    q = unpack_int4(packed, fan_in)
    qg = q.reshape(*q.shape[:-1], groups, fan_in // groups)
    return (qg * scale[..., None]).reshape(q.shape)


# --- Q1: per-token activation quantize --------------------------------------


def quantize_rows_plain(x: torch.Tensor) -> Pair:
    """Q1's plain version: x [M, K] -> (int8 round(x * (127 / ax)), ax
    float32 [M, 1]) with ax = max(max_k |x|, 1e-12), all in float32."""
    xf = x.float()
    ax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-12)
    xq = torch.round(xf * (_const(ax, 127.0) / ax)).to(torch.int8)
    return xq, ax


def _check_cuda(x: torch.Tensor, dtype: torch.dtype, ndim: int,
                what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what} on {x.device}, expected CUDA")
    if x.dtype != dtype:
        raise TypeError(f"{what} dtype {x.dtype}, expected {dtype}")
    if x.dim() != ndim or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} {tuple(x.shape)}: expected a contiguous, "
                         f"16-byte aligned {ndim}-D tensor")


def quantize_rows(x: torch.Tensor) -> Pair:
    """Per-token dynamic int8 quantization of x [M, K]: a CPU tensor takes
    quantize_rows_plain; a CUDA tensor (bf16, contiguous, K a multiple of
    8) launches Q1, bit for bit the plain version, or raises."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    _check_cuda(x, torch.bfloat16, 2, "quantize_rows input")
    m, k = x.shape
    if k % 8:
        raise ValueError(f"quantize_rows: K {k} is not a multiple of 8")
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    ax = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    _build.launch("ea_quantize_rows_bf16", x.device, x.data_ptr(),
                  xq.data_ptr(), ax.data_ptr(), m, k)
    quantize_rows.launches += 1
    return xq, ax


quantize_rows.launches = 0


# --- Q2: dequantize the int32 accumulator -----------------------------------


def dequantize_rows_plain(acc: torch.Tensor, ax: torch.Tensor,
                          w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Q2's plain version: float(acc) * (ax / 127) * w_scale (+ bias) in
    float32, in JAX's order, cast last. acc [M, N] int32, ax [M, 1],
    w_scale [N]."""
    out = acc.float() * (ax / _const(ax, 127.0)) * w_scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def dequantize_rows(acc: torch.Tensor, ax: torch.Tensor,
                    w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The W8A8 epilogue: a CPU tensor takes dequantize_rows_plain; a CUDA
    tensor launches Q2 (int32 acc [M, N] with N a multiple of 4, float32
    ax [M, 1], w_scale [N] and bias [N] or None, bf16 out) or raises."""
    if acc.device.type == "cpu":
        return dequantize_rows_plain(acc, ax, w_scale, bias, out_dtype)
    _check_cuda(acc, torch.int32, 2, "dequantize_rows acc")
    m, n = acc.shape
    _check_cuda(ax, torch.float32, 2, "dequantize_rows ax")
    _check_cuda(w_scale, torch.float32, 1, "dequantize_rows w_scale")
    if bias is not None:
        _check_cuda(bias, torch.float32, 1, "dequantize_rows bias")
    if (tuple(ax.shape) != (m, 1) or w_scale.shape[0] != n
            or (bias is not None and bias.shape[0] != n)):
        raise ValueError(f"dequantize_rows: acc {tuple(acc.shape)}, ax "
                         f"{tuple(ax.shape)}, w_scale {tuple(w_scale.shape)}")
    if out_dtype != torch.bfloat16 or n % 4:
        raise ValueError(f"dequantize_rows: out {out_dtype}, N {n}; the "
                         "kernel writes bf16 with N a multiple of 4")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=acc.device)
    _build.launch("ea_dequantize_rows_bf16", acc.device, acc.data_ptr(),
                  ax.data_ptr(), w_scale.data_ptr(),
                  0 if bias is None else bias.data_ptr(), y.data_ptr(), m, n)
    dequantize_rows.launches += 1
    return y


dequantize_rows.launches = 0


# --- Q3: unpack a packed int4 weight ----------------------------------------


def regrid_int4_plain(packed: torch.Tensor, scale: torch.Tensor) -> Pair:
    """The W4A8 regrid (JAX int4_matmul_a8): (int8 q8 [N, K], float32 s8
    [N]) with s8 = max(max_g s_g, 1e-12) * 8/127 and
    q8 = round(q4 * (s_g / s8))."""
    n, fan_in = packed.shape[0], packed.shape[1] * 2
    groups = scale.shape[-1]
    q4 = unpack_int4(packed, fan_in).reshape(n, groups, fan_in // groups)
    s8 = torch.clamp_min(scale.amax(dim=-1), 1e-12) * (8.0 / 127.0)
    q8 = torch.round(q4 * (scale / s8[:, None])[..., None])
    return q8.to(torch.int8).reshape(n, fan_in), s8


def unpack_int4_weight_plain(packed: torch.Tensor, scale: torch.Tensor,
                             out="int8"):
    """Q3's plain version: out="int8" gives regrid_int4_plain's (q8, s8);
    a float dtype gives dequantize_int4 cast to it."""
    if out == "int8":
        return regrid_int4_plain(packed, scale)
    return dequantize_int4(packed, scale).to(out)


def unpack_int4_weight(packed: torch.Tensor, scale: torch.Tensor, out="int8"):
    """A packed int4 weight [N, K/2] + scale [N, groups] -> (q8, s8) for
    out="int8" (W4A8), else the dequantized weight [N, K] in dtype `out`
    (W4A16). A CPU tensor takes unpack_int4_weight_plain; a CUDA tensor
    launches Q3 (int8 out, or bf16; K a multiple of 32) or raises."""
    if packed.device.type == "cpu":
        return unpack_int4_weight_plain(packed, scale, out)
    _check_cuda(packed, torch.int8, 2, "unpack_int4_weight packed")
    _check_cuda(scale, torch.float32, 2, "unpack_int4_weight scale")
    n, half = packed.shape
    groups = scale.shape[1]
    if (scale.shape[0] != n or (2 * half) % groups
            or (2 * half // groups) % 32):
        raise ValueError(f"unpack_int4_weight: packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}; the kernel takes "
                         "groups of a multiple of 32 in-features")
    if out == "int8":
        w = torch.empty((n, 2 * half), dtype=torch.int8, device=packed.device)
        s8 = torch.empty((n,), dtype=torch.float32, device=packed.device)
    elif out == torch.bfloat16:
        w = torch.empty((n, 2 * half), dtype=torch.bfloat16,
                        device=packed.device)
        s8 = None
    else:
        raise ValueError(f"unpack_int4_weight: out {out}; the kernel writes "
                         "int8 or bf16")
    _build.launch("ea_unpack_int4", packed.device, packed.data_ptr(),
                  scale.data_ptr(), w.data_ptr(),
                  0 if s8 is None else s8.data_ptr(), n, 2 * half, groups,
                  int(s8 is not None))
    unpack_int4_weight.launches += 1
    return (w, s8) if s8 is not None else w


unpack_int4_weight.launches = 0


# --- the products --------------------------------------------------------------


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 xq [M, K] x int8 weight [N, K] -> exact int32 [M, N] (the
    library product: torch._int_mm, the weight passed column-major)."""
    return torch._int_mm(xq, wq.t())


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16,
                xq: Optional[Pair] = None) -> torch.Tensor:
    """x [..., in] float; w_q int8 [out, in]; w_scale float32 [out]. Per-
    token dynamic activation quantization (Q1, or `xq` = quantize_rows of
    the same x, shared by the linears that read it), the int32 product,
    the dequantize (Q2)."""
    lead, fan_in = x.shape[:-1], x.shape[-1]
    if xq is None:
        xq = quantize_rows(x.reshape(-1, fan_in).contiguous())
    acc = int_mm(xq[0], w_q)
    return dequantize_rows(acc, xq[1], w_scale, bias, out_dtype).reshape(
        *lead, w_q.shape[0])


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """W4A16: x [..., in]; w_packed int8 [out, in // 2]; w_scale float32
    [out, groups]. The weight is dequantized (Q3) to out_dtype for the
    product."""
    w = unpack_int4_weight(w_packed, w_scale, out_dtype)
    return F.linear(x.to(out_dtype), w,
                    None if bias is None else bias.to(out_dtype))


def int4_matmul_a8(x: torch.Tensor, w_packed: torch.Tensor,
                   w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.bfloat16,
                   xq: Optional[Pair] = None) -> torch.Tensor:
    """W4A8: the int4 parameters of int4_matmul, regridded (Q3) onto one
    per-channel int8 grid, then int8_matmul."""
    q8, s8 = unpack_int4_weight(w_packed, w_scale, "int8")
    return int8_matmul(x, q8, s8, bias, out_dtype, xq)


# --- the module ---------------------------------------------------------------


class QuantLinear(nn.Module):
    """A block linear held quantized (JAX PermutedDense's quant branches,
    easyanimate_tpu/models/blocks.py:54-130; its output permutation is a
    TPU layout trick the reference-order weights here need none of).

    Buffers: `weight` int8 ([out, in] for "int8", packed [out, in // 2]
    for "int4" and "w4a8") and `scale` float32 ([out], or [out, groups]);
    parameter `bias` float32 [out] (JAX's loader keeps 1-D tensors float32
    too). The output is in `compute_dtype`. A float [out, in] `weight`
    handed to load_state_dict without a `scale` is quantized as it is
    loaded (on the buffer's device, or on the tensor's when assigning; on
    meta only its shape is checked), so a reference checkpoint fills a
    quantized model tensor by tensor."""

    def __init__(self, in_features: int, out_features: int, mode: str,
                 bias: bool = True, *, device=None, dtype=None):
        super().__init__()
        if mode not in QUANT_MODES:
            raise ValueError(f"quant mode {mode!r} not in {QUANT_MODES}")
        if mode != "int8" and in_features % 2:
            raise ValueError(f"int4 packing needs even fan_in, got "
                             f"{in_features}")
        self.in_features, self.out_features, self.mode = (
            in_features, out_features, mode)
        self.compute_dtype = dtype or torch.get_default_dtype()
        if mode == "int8":
            wshape, sshape = (out_features, in_features), (out_features,)
        else:
            wshape = (out_features, in_features // 2)
            sshape = (out_features, _int4_groups(in_features))
        self.register_buffer("weight", torch.zeros(wshape, dtype=torch.int8,
                                                   device=device))
        self.register_buffer("scale", torch.ones(sshape, dtype=torch.float32,
                                                 device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, mode={self.mode!r}, "
                f"bias={self.bias is not None}")

    def quantize(self, w: torch.Tensor) -> Pair:
        """Float [out, in] -> (weight, scale) for this module's mode."""
        if self.mode == "int8":
            return quantize_weight_int8(w)
        return quantize_weight_int4(w)

    def dequantized_weight(self) -> torch.Tensor:
        """float32 [out, in]: the weight this module multiplies by (for
        "w4a8", before its per-call regrid)."""
        if self.mode == "int8":
            return self.weight.float() * self.scale[:, None]
        return dequantize_int4(self.weight, self.scale)

    @torch.no_grad()
    def set_weight_(self, w: torch.Tensor) -> None:
        """Requantize from a float [out, in] weight, with fresh scales."""
        q, s = self.quantize(w.to(self.weight.device))
        self.weight.copy_(q)
        self.scale.copy_(s)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        w = state_dict.get(prefix + "weight")
        assign = local_metadata.get("assign_to_params_buffers", False)
        if w is not None and w.is_floating_point() \
                and prefix + "scale" not in state_dict:
            if self.weight.is_meta and not assign:
                w = w.to("meta")  # the shape check only
            elif not self.weight.is_meta:
                w = w.to(self.weight.device)
            if tuple(w.shape) == (self.out_features, self.in_features):
                q, s = self.quantize(w)
                state_dict = {**state_dict, prefix + "weight": q,
                              prefix + "scale": s}
        b = state_dict.get(prefix + "bias")
        if b is not None and b.dtype != torch.float32:
            state_dict = {**state_dict, prefix + "bias": b.float()}
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)

    def quantize_input(self, x: torch.Tensor) -> Optional[Pair]:
        """Q1 of x for the int8 products ("int8", "w4a8"), which the
        linears reading the same x may share; None for "int4"."""
        if self.mode == "int4":
            return None
        return quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())

    def forward(self, x: torch.Tensor, xq: Optional[Pair] = None):
        if self.mode == "int8":
            return int8_matmul(x, self.weight, self.scale, self.bias,
                               self.compute_dtype, xq)
        if self.mode == "w4a8":
            return int4_matmul_a8(x, self.weight, self.scale, self.bias,
                                  self.compute_dtype, xq)
        return int4_matmul(x, self.weight, self.scale, self.bias,
                           self.compute_dtype)


def make_linear(in_features: int, out_features: int,
                quant: Optional[str] = None, **fk) -> nn.Module:
    """nn.Linear, or its QuantLinear when `quant` names a mode."""
    if quant is None:
        return nn.Linear(in_features, out_features, **fk)
    return QuantLinear(in_features, out_features, quant, **fk)


@torch.no_grad()
def _quantize_module(module: nn.Module, mode: str) -> nn.Module:
    """Replace every float block linear (BLOCK_LINEARS) of `module` in place
    by its QuantLinear, quantized on the weight's device; a module with a
    `cfg` dataclass carrying `linear_quant` gets it set to `mode`."""
    for path, lin in list(module.named_modules()):
        if not (type(lin) is nn.Linear and re.search(BLOCK_LINEARS, path)):
            continue
        q = QuantLinear(lin.in_features, lin.out_features, mode,
                        bias=lin.bias is not None, device="meta",
                        dtype=getattr(lin, "compute_dtype", lin.weight.dtype))
        wq, scale = q.quantize(lin.weight)
        q.weight, q.scale = wq, scale
        if lin.bias is not None:
            q.bias = nn.Parameter(lin.bias.float())
        module.set_submodule(path, q)
    cfg = getattr(module, "cfg", None)
    if dataclasses.is_dataclass(cfg) and hasattr(cfg, "linear_quant"):
        module.cfg = dataclasses.replace(cfg, linear_quant=mode)
    return module


def quantize_module_int8_(module: nn.Module) -> nn.Module:
    """The port of quantize_params_int8 (easyanimate_tpu/ops/quant.py:185):
    the block linears become W8A8 QuantLinears; every other module (the
    adaLN norm1 / norm2 linears, everything outside the blocks) stays."""
    return _quantize_module(module, "int8")


def quantize_module_int4_(module: nn.Module, mode: str = "w4a8") -> nn.Module:
    """The port of quantize_params_int4 (easyanimate_tpu/ops/quant.py:160):
    the block linears become packed int4 QuantLinears computing as `mode`,
    "w4a8" (the int8 product) or "int4" (W4A16)."""
    if mode not in ("int4", "w4a8"):
        raise ValueError(f"int4 compute mode {mode!r}: int4 or w4a8")
    return _quantize_module(module, mode)
