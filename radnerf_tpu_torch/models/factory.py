"""The one place the port builds a field: ``build_network`` gives RAD-NeRF's
``NeRFNetwork`` or ER-NeRF's ``TriplaneNetwork`` as ``NetworkConfig.arch``
names, and ``param_groups`` each one's learning-rate groups."""

from __future__ import annotations

from . import network
from .network_triplane import TriplaneNetwork, triplane_param_groups


def build_network(cfg: network.NetworkConfig, device="cuda", generator=None):
    """The field ``cfg.arch`` names, its parameters drawn from ``generator``
    (a CPU ``torch.Generator``; the default generator if None) on
    ``device``."""
    cls = TriplaneNetwork if cfg.arch == "ernerf" else network.NeRFNetwork
    return cls(cfg, device=device, generator=generator)


def param_groups(cfg: network.NetworkConfig) -> dict:
    """Learning-rate group of each top-level parameter name of the field
    ``cfg.arch`` names (``network.param_groups`` for RAD-NeRF's)."""
    return triplane_param_groups(cfg) if cfg.arch == "ernerf" else network.param_groups(cfg)
