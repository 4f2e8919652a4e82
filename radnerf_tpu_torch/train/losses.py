"""Training losses (counterpart of ``radnerf_tpu/train/losses.py``;
reference Trainer.train_step, nerf/utils.py:718-808). The head stage: per-ray
MSE on the composited image, a 1e-4 binary-entropy term on the head's
opacity, and the ambient sparsity outside the face rect ramped from 0 to
lambda_amb over training; in the lips finetune and patch training an LPIPS
term on the batch reshaped to images (0.01 on the lips rect [1, h, w, 3],
0.001 on the patches [B, p, p, 3]). The torso stage: MSE of the
torso-over-background colour against the torso plate and a 1e-4
binary-entropy term on the torso's alpha."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def binary_entropy(alphas: torch.Tensor) -> torch.Tensor:
    a = torch.clamp(alphas, 1e-5, 1 - 1e-5)
    return -a * torch.log2(a) - (1 - a) * torch.log2(1 - a)


def head_loss(results: dict, rgb_gt: torch.Tensor, face_mask: torch.Tensor,
              global_step: int, iters: int, lambda_amb: float, lpips=None,
              lpips_shape=None, lpips_weight: float = 0.01,
              parts: Optional[dict] = None) -> torch.Tensor:
    """results: ``render_rays(training=True)``'s image [N, 3], weights_sum
    [N] and ambient [N]; rgb_gt [N, 3]; face_mask [N] bool. With ``lpips``
    (a module taking two [B, h, w, 3] images to [B] distances) and
    ``lpips_shape`` (h, w), the batch is row-major h x w images and their
    mean distance, times ``lpips_weight``, joins the loss; ``parts``, when
    given, receives that term as "lpips"."""
    pred = results["image"]
    loss = torch.mean((pred - rgb_gt) ** 2)
    if lpips is not None and lpips_shape is not None:
        h, w = lpips_shape
        term = lpips_weight * torch.mean(lpips(pred.reshape(-1, h, w, 3),
                                               rgb_gt.reshape(-1, h, w, 3)))
        if parts is not None:
            parts["lpips"] = term
        loss = loss + term
    loss = loss + 1e-4 * torch.mean(binary_entropy(results["weights_sum"]))
    # the ramp in float32, as the JAX step computes it
    lambda_t = float(np.minimum(np.float32(global_step) / np.float32(iters), np.float32(1.0))
                     * np.float32(lambda_amb))
    loss_amb = torch.mean(results["ambient"] * (~face_mask))
    return loss + lambda_t * loss_amb


def torso_loss(results: dict, rgb_gt: torch.Tensor) -> torch.Tensor:
    """results: ``render_rays(training=True)``'s torso_color [N, 3] and
    torso_alpha [N, 1]; rgb_gt [N, 3], the torso plate over the background."""
    loss = torch.mean((results["torso_color"] - rgb_gt) ** 2)
    return loss + 1e-4 * torch.mean(binary_entropy(results["torso_alpha"]))
