"""NN building blocks (counterpart of ``radnerf_tpu/models/modules.py``).

Weights are stored in PyTorch's layout: a linear weight is ``[out, in]``
(the JAX package keeps ``[in, out]``; ``convert.py`` transposes), a conv1d
weight ``[c_out, c_in, k]`` in both. Initialisation is PyTorch's default,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases, drawn from the
caller's ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(shape, bound: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class Linear(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, bias: bool = True, generator=None):
        super().__init__()
        b = 1.0 / math.sqrt(dim_in)
        self.weight = _uniform((dim_out, dim_in), b, generator)
        self.bias = _uniform((dim_out,), b, generator) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv1d(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding: int = 0, generator=None):
        super().__init__()
        b = 1.0 / math.sqrt(c_in * kernel)
        self.weight = _uniform((c_out, c_in, kernel), b, generator)
        self.bias = _uniform((c_out,), b, generator)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        """x: [B, C_in, L] -> [B, C_out, L_out]. cuDNN would run an fp32
        convolution in TF32 on the card; it is pinned off here."""
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(x, self.weight, self.bias, self.stride, self.padding)


def leaky_relu(x, negative_slope: float = 0.02):
    return F.leaky_relu(x, negative_slope)


class MLP(nn.Module):
    """Bias-free Linear stack with ReLU between (reference network.py:69-88);
    ``forward(x, dtype)`` computes every layer in ``dtype`` (JAX
    ``mlp_apply``'s ``compute_dtype``: input and float32 weight cast to it,
    the product in it)."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int, num_layers: int,
                 generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Linear(dim_in if l == 0 else dim_hidden,
                   dim_out if l == num_layers - 1 else dim_hidden,
                   bias=False, generator=generator)
            for l in range(num_layers))

    def forward(self, x, dtype=None):
        for l, layer in enumerate(self.layers):
            x = layer(x) if dtype is None else F.linear(x.to(dtype), layer.weight.to(dtype))
            if l != len(self.layers) - 1:
                x = F.relu(x)
        return x
