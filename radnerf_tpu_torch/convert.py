"""Carry weights and renderer state across from numpy.

``network_from_jax`` takes the JAX parameter pytree as numpy arrays (the
``init_params`` layout, or what the JAX package's torch-checkpoint import
returns) and loads it into a ``NeRFNetwork``. ``state_from_numpy`` builds a
``RendererState`` from numpy grids, deriving the sigma bytes and the
occupied bbox and sphere in the port itself. Both default to the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .models.network import NeRFNetwork, NetworkConfig
from .models.renderer import RenderConfig, RendererState, make_state


def _linear(prefix: str, p: dict, out: dict):
    # JAX keeps a linear weight as [in, out]; PyTorch as [out, in]
    out[f"{prefix}.weight"] = np.asarray(p["w"]).T
    if "b" in p:
        out[f"{prefix}.bias"] = np.asarray(p["b"])


def _conv(prefix: str, p: dict, out: dict):
    out[f"{prefix}.weight"] = np.asarray(p["w"])  # [c_out, c_in, k] in both
    out[f"{prefix}.bias"] = np.asarray(p["b"])


def _mlp(prefix: str, p: dict, out: dict):
    for j, layer in enumerate(p["layers"]):
        _linear(f"{prefix}.layers.{j}", layer, out)


def _state_dict_from_jax(np_params: dict) -> dict:
    """Flatten the JAX pytree into ``NeRFNetwork`` state_dict names. The
    ``_packed_*`` tables (TPU corner-packed caches) are skipped."""
    sd = {}
    for key, p in np_params.items():
        if key.startswith("_packed_"):
            continue
        if key in ("audio_net", "audio_att_net"):
            for j, conv in enumerate(p["conv"]):
                _conv(f"{key}.conv.{j}", conv, sd)
            fcs = p["fc"] if isinstance(p["fc"], (list, tuple)) else [p["fc"]]
            names = [f"{key}.fc.{j}" for j in range(len(fcs))] \
                if key == "audio_net" else [f"{key}.fc"]
            for name, fc in zip(names, fcs):
                _linear(name, fc, sd)
        elif isinstance(p, dict):
            _mlp(key, p, sd)
        else:
            sd[key] = np.asarray(p)
    return sd


def network_from_jax(np_params: dict, cfg: NetworkConfig, device="cuda") -> NeRFNetwork:
    """A ``NeRFNetwork`` holding the JAX parameters; every parameter of the
    network must be given and every given one must be used."""
    device = resolve_device(device)
    net = NeRFNetwork(cfg, device="cpu")
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
          for k, v in _state_dict_from_jax(np_params).items()}
    net.load_state_dict(sd, strict=True)
    return net.to(device)


def state_from_numpy(cfg: RenderConfig, density_grid: np.ndarray,
                     density_grid_torso: np.ndarray, mean_density: float,
                     mean_density_torso: float, thresh: Optional[float] = None,
                     density_bitfield: Optional[np.ndarray] = None,
                     audio_dim: int = 64, device="cuda") -> RendererState:
    """``RendererState`` from numpy: density grid [cascade, H^3] (Morton
    order), torso grid [H^2], their means, optionally the occupancy
    threshold (default min(mean_density, density_thresh)) and a bitfield."""
    dev = resolve_device(device)
    grid = torch.as_tensor(np.asarray(density_grid, np.float32)).to(dev)
    torso = torch.as_tensor(np.asarray(density_grid_torso, np.float32)).to(dev)
    bits = (None if density_bitfield is None
            else torch.as_tensor(np.asarray(density_bitfield, np.uint8)).to(dev))
    return make_state(cfg, grid, torso, mean_density, mean_density_torso, thresh,
                      bits, audio_dim)
