"""Training losses (counterpart of ``radnerf_tpu/train/losses.py``;
reference Trainer.train_step, nerf/utils.py:718-808). The head stage: per-ray
MSE on the composited image, a 1e-4 binary-entropy term on the head's
opacity, and the ambient sparsity outside the face rect ramped from 0 to
lambda_amb over training. The torso stage: MSE of the torso-over-background
colour against the torso plate and a 1e-4 binary-entropy term on the torso's
alpha. The LPIPS term (lips finetune, patch training) is not ported."""

from __future__ import annotations

import numpy as np
import torch


def binary_entropy(alphas: torch.Tensor) -> torch.Tensor:
    a = torch.clamp(alphas, 1e-5, 1 - 1e-5)
    return -a * torch.log2(a) - (1 - a) * torch.log2(1 - a)


def head_loss(results: dict, rgb_gt: torch.Tensor, face_mask: torch.Tensor,
              global_step: int, iters: int, lambda_amb: float) -> torch.Tensor:
    """results: ``render_rays(training=True)``'s image [N, 3], weights_sum
    [N] and ambient [N]; rgb_gt [N, 3]; face_mask [N] bool."""
    loss = torch.mean((results["image"] - rgb_gt) ** 2)
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
