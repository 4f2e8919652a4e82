"""Evaluation metrics: PSNR, LPIPS (the alex architecture in PyTorch), LMD
(counterpart of ``radnerf_tpu/train/metrics.py``; reference
nerf/utils.py:402-567).

``LPIPS`` is the LPIPS-alex network (AlexNet conv stack, unit-normalised
feature taps, 1x1 calibration weights, spatial mean) as an ``nn.Module`` of
``F.conv2d`` / ``F.max_pool2d`` on its device. Calibrated weights load from
the official checkpoints (``load_torch_weights``, ``load_weights_file``);
without them the filters are drawn from a seeded ``torch.Generator``, a
valid relative distance for tracking training, and the report names that
backend ("uncalibrated-torch"; the JAX package's seeded draw is another).
LMD needs a face-landmark model and is gated on ``face_alignment``, or takes
an injected predictor. Each meter's ``write(writer, global_step, prefix)``
adds its measure to a tensorboard writer under the JAX package's tag.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


class PSNRMeter:
    """PSNR over full frames (utils.py:402-436)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.V = 0.0
        self.N = 0

    def update(self, preds: np.ndarray, truths: np.ndarray):
        preds = np.asarray(preds, np.float32)
        truths = np.asarray(truths, np.float32)
        mse = float(np.mean((preds - truths) ** 2))
        self.V += -10.0 * math.log10(max(mse, 1e-12))
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(f"{prefix}/PSNR", self.measure(), global_step)

    def report(self) -> str:
        return f"PSNR = {self.measure():.6f}"


# (out_ch, kernel, stride, pad, pool_after)
_ALEX_CFG = ((64, 11, 4, 2, True), (192, 5, 1, 2, True), (384, 3, 1, 1, False),
             (256, 3, 1, 1, False), (256, 3, 1, 1, True))
# LPIPS's ImageNet scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_ALEX_CONV_IDS = (0, 3, 6, 8, 10)  # torchvision alexnet.features indices


class LPIPS(nn.Module):
    """LPIPS-alex perceptual distance; ``forward(a, b)`` takes [B, H, W, 3]
    in [0, 1] and returns [B] distances, differentiable."""

    def __init__(self, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        c_in = 3
        for c_out, k, *_ in _ALEX_CFG:
            w = torch.randn((c_out, c_in, k, k), generator=gen) * math.sqrt(2.0 / (c_in * k * k))
            self.weights.append(nn.Parameter(w, requires_grad=False))
            self.biases.append(nn.Parameter(torch.zeros(c_out), requires_grad=False))
            c_in = c_out
        self.lins = nn.ParameterList(nn.Parameter(torch.ones(c) / c, requires_grad=False)
                                     for c, *_ in _ALEX_CFG)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))
        self.calibrated = False
        self.to(dev)

    @torch.no_grad()
    def load_torch_weights(self, alexnet_state: dict, lpips_state: dict):
        """Official weights: torchvision alexnet ``features`` convs and the
        lpips ``lin{0..4}.model.1.weight`` calibration."""
        for i, cid in enumerate(_ALEX_CONV_IDS):
            self.weights[i].copy_(torch.from_numpy(
                np.array(alexnet_state[f"features.{cid}.weight"], np.float32)))
            self.biases[i].copy_(torch.from_numpy(
                np.array(alexnet_state[f"features.{cid}.bias"], np.float32)))
            self.lins[i].copy_(torch.from_numpy(
                np.array(lpips_state[f"lin{i}.model.1.weight"], np.float32).reshape(-1)))
        self.calibrated = True

    def load_weights_file(self, path: str):
        """Calibration weights from one file: ``.npz`` with keys
        ``features.{0,3,6,8,10}.{weight,bias}`` and ``lin{0..4}.model.1.weight``,
        or a torch file holding ``{"alexnet": sd, "lpips": sd}`` or one flat
        dict with both key families."""
        if path.endswith(".npz"):
            with np.load(path) as z:
                blob = {k: z[k] for k in z.files}
        else:
            blob = torch.load(path, map_location="cpu", weights_only=False)
            if "alexnet" in blob and "lpips" in blob:
                blob = {**blob["alexnet"], **blob["lpips"]}
        alex = {k: v for k, v in blob.items() if k.startswith("features.")}
        lin = {k: v for k, v in blob.items() if k.startswith("lin")}
        if not alex or not lin:
            raise ValueError(f"{path}: expected alexnet 'features.*' and lpips 'lin*' keys, "
                             f"got {sorted(blob)[:6]}...")
        self.load_torch_weights(alex, lin)

    def features(self, x: torch.Tensor) -> list:
        """[B, H, W, 3] in [0, 1] -> the 5 ReLU taps [B, c, h, w]."""
        x = ((2.0 * x - 1.0).permute(0, 3, 1, 2) - self.shift) / self.scale
        feats = []
        for i, (w, b, (_, _, stride, pad, pool)) in enumerate(
                zip(self.weights, self.biases, _ALEX_CFG)):
            x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
            feats.append(x)
            # the pool after the last tap feeds nothing (and on a 32-px
            # input would have no output: PyTorch raises where JAX returns
            # an empty window)
            if pool and i < len(_ALEX_CFG) - 1:
                x = F.max_pool2d(x, 3, 2)
        return feats

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for xa, xb, lin in zip(self.features(a), self.features(b), self.lins):
            na = xa / torch.sqrt((xa * xa).sum(dim=1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt((xb * xb).sum(dim=1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2
            total = total + (d * lin[None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
        return total


class LPIPSMeter:
    """LPIPS over full frames (utils.py:438-472), on ``device``."""

    def __init__(self, seed: int = 0, weights_path: str = "", device="cuda"):
        self.lpips = LPIPS(seed, device)
        if weights_path:
            self.lpips.load_weights_file(weights_path)
        self.clear()

    def clear(self):
        self.V = 0.0
        self.N = 0

    @torch.no_grad()
    def update(self, preds: np.ndarray, truths: np.ndarray):
        dev = self.lpips.shift.device
        a = torch.as_tensor(np.asarray(preds, np.float32), device=dev)
        b = torch.as_tensor(np.asarray(truths, np.float32), device=dev)
        self.V += float(self.lpips(a.reshape(1, *a.shape[-3:]), b.reshape(1, *b.shape[-3:]))[0])
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(f"{prefix}/LPIPS{self._tag()}", self.measure(), global_step)

    def _tag(self) -> str:
        return " (alex)" if self.lpips.calibrated else " (uncalibrated-torch)"

    def report(self) -> str:
        return f"LPIPS{self._tag()} = {self.measure():.6f}"


class LMDMeter:
    """Mouth-landmark distance (utils.py:475-567). Needs ``face_alignment``
    (backend "fan") unless a predictor is injected: any object with
    ``get_landmarks(uint8 image) -> [68, 2] array(s)``. Raises ImportError
    without one."""

    def __init__(self, backend: str = "fan", region: str = "mouth", predictor=None):
        self.backend = backend
        self.region = region
        if predictor is not None:
            self.predictor = predictor
        elif backend == "dlib":
            import dlib  # noqa: F401  (gated)

            raise ImportError("dlib backend requires a local predictor .dat file")
        else:
            import face_alignment  # gated

            # the reference's LandmarksType._2D, renamed TWO_D in
            # face_alignment >= 1.4
            lm_type = getattr(face_alignment.LandmarksType, "TWO_D",
                              getattr(face_alignment.LandmarksType, "_2D", None))
            if lm_type is None:
                raise ImportError("face_alignment.LandmarksType exposes neither TWO_D nor "
                                  "_2D; unsupported face_alignment version for LMDMeter")
            self.predictor = face_alignment.FaceAlignment(lm_type, flip_input=False)
        self.clear()

    def get_landmarks(self, img: np.ndarray) -> np.ndarray:
        lms = self.predictor.get_landmarks(np.asarray(img * 255.0, np.uint8))[-1]
        return lms.astype(np.float32)

    def clear(self):
        self.V = 0.0
        self.N = 0

    def update(self, preds: np.ndarray, truths: np.ndarray):
        lms_pred = self.get_landmarks(np.asarray(preds))
        lms_true = self.get_landmarks(np.asarray(truths))
        # centred (utils.py:537-541); the mouth is points 48:68
        lms_pred = lms_pred - lms_pred.mean(0)
        lms_true = lms_true - lms_true.mean(0)
        if self.region == "mouth":
            lms_pred, lms_true = lms_pred[48:68], lms_true[48:68]
        self.V += float(np.linalg.norm(lms_pred - lms_true, axis=-1).mean())
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(f"{prefix}/LMD ({self.backend})", self.measure(), global_step)

    def report(self) -> str:
        return f"LMD ({self.backend}) = {self.measure():.6f}"
