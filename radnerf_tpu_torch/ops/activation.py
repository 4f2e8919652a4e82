"""Density activation: truncated exponential.

Counterpart of ``radnerf_tpu/ops/activation.py``: fp32 ``exp`` forward; the
backward uses ``exp(clamp(x, -15, 15))`` so gradients cannot explode.
"""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.float()
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
