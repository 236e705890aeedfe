"""Weight-only fp8 storage (reference utils/fp8_optimization.py).

Parity: easyanimate_tpu/utils/fp8.py (quantize_params_fp8 :25,
dequantize_params :32) and the fp8 cast of easyanimate_tpu/loader.py:305-318.
Every floating weight of 2 or more dimensions is held as float8_e4m3fn (1
byte a parameter) and upcast to the compute dtype inside its module's
forward, as the reference's wrapper does; 1-D tensors (norms, biases) keep
their dtype. nn.Linear and nn.Conv* cannot take an fp8 weight, so each such
module's forward is given the upcast. A quantized block linear
(ops/quant.py::QuantLinear) is left as it is: its int8 weight and float32
scale are buffers, not floating parameters, as JAX keeps the int kernels
and the scales out of the fp8 cast (easyanimate_tpu/loader.py:305-318).
"""
import types

import torch
import torch.nn.functional as F
from torch import nn

FP8 = torch.float8_e4m3fn


def _linear_forward(self, x):
    return F.linear(x, self.weight.to(self.compute_dtype), self.bias)


def _conv_forward(self, x, weight, bias):
    return type(self)._conv_forward(self, x, weight.to(self.compute_dtype),
                                    bias)


@torch.no_grad()
def quantize_module_fp8_(module: nn.Module,
                         compute_dtype: torch.dtype) -> nn.Module:
    """Cast every >= 2-D floating weight of `module` (on any device, meta
    included) to fp8 in place and give its owner the upcast to
    `compute_dtype`. A cast from float32 rounds once, as JAX's astype does.
    Raises for a >= 2-D weight outside a Linear or a Conv."""
    for name, mod in module.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            if p.dim() < 2 or not p.is_floating_point() or p.dtype == FP8:
                continue
            if pname != "weight" or not isinstance(
                    mod, (nn.Linear, nn.modules.conv._ConvNd)):
                raise TypeError(f"{name}.{pname}: no fp8 upcast for "
                                f"{type(mod).__name__}")
            mod.weight = nn.Parameter(p.to(FP8), requires_grad=False)
            mod.compute_dtype = compute_dtype
            if isinstance(mod, nn.Linear):
                mod.forward = types.MethodType(_linear_forward, mod)
            else:
                mod._conv_forward = types.MethodType(_conv_forward, mod)
    return module


def fp8_byte_share(module: nn.Module) -> float:
    """Share of the module's parameter bytes held in fp8."""
    total = fp8 = 0
    for p in module.parameters():
        n = p.numel() * p.element_size()
        total += n
        fp8 += n if p.dtype == FP8 else 0
    return fp8 / max(total, 1)
