"""NeRF frequency encoding (counterpart of ``radnerf_tpu/ops/freq_encode.py``).

Layout: [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...], each block
spanning all D input dims; output dim D + 2*D*degree.
"""

from __future__ import annotations

import torch


def freq_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    parts = [x]
    for f in range(degree):
        scaled = x * (2.0**f)
        parts.append(torch.sin(scaled))
        parts.append(torch.cos(scaled))
    return torch.cat(parts, dim=-1)


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim + 2 * input_dim * degree
