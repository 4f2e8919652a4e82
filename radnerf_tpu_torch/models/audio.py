"""Audio conditioning nets (counterpart of ``radnerf_tpu/models/audio.py``).

AudioNet: the centre 16 of the feature window, 4x Conv1d stride 2
(in->32->32->64->64, length 16->8->4->2->1) with LeakyReLU(0.02), then
Linear(64,64) + LeakyReLU + Linear(64, dim_aud).

AudioAttNet: over ``seq_len`` per-frame codes [1, seq_len, dim_aud]: 5x
Conv1d(k3, s1, p1) 64->16->8->4->2->1 with LeakyReLU(0.02), Linear(seq_len,
seq_len), softmax over the sequence, weighted sum -> [1, dim_aud].
"""

from __future__ import annotations

import torch
from torch import nn

from .modules import Conv1d, Linear, leaky_relu


class AudioNet(nn.Module):
    def __init__(self, dim_in: int, dim_aud: int = 64, win_size: int = 16,
                 generator=None):
        super().__init__()
        self.win_size = win_size
        self.conv = nn.ModuleList(
            Conv1d(ci, co, 3, stride=2, padding=1, generator=generator)
            for ci, co in ((dim_in, 32), (32, 32), (32, 64), (64, 64)))
        self.fc = nn.ModuleList([Linear(64, 64, generator=generator),
                                 Linear(64, dim_aud, generator=generator)])

    def forward(self, x):
        """x: [B, dim_in, W] -> [B, dim_aud]."""
        half_w = self.win_size // 2
        x = x[:, :, 8 - half_w: 8 + half_w]
        for conv in self.conv:
            x = leaky_relu(conv(x))
        x = leaky_relu(self.fc[0](x[..., 0]))
        return self.fc[1](x)


class AudioAttNet(nn.Module):
    def __init__(self, dim_aud: int = 64, seq_len: int = 8, generator=None):
        super().__init__()
        self.conv = nn.ModuleList(
            Conv1d(ci, co, 3, stride=1, padding=1, generator=generator)
            for ci, co in ((dim_aud, 16), (16, 8), (8, 4), (4, 2), (2, 1)))
        self.fc = Linear(seq_len, seq_len, generator=generator)

    def forward(self, x):
        """x: [1, seq_len, dim_aud] -> [1, dim_aud]."""
        seq_len = x.shape[1]
        y = x.permute(0, 2, 1)
        for conv in self.conv:
            y = leaky_relu(conv(y))
        y = self.fc(y.reshape(1, seq_len))
        y = torch.softmax(y, dim=1).reshape(1, seq_len, 1)
        return (y * x).sum(dim=1)
