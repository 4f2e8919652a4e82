"""Carry weights and renderer state across from numpy.

``network_from_jax`` takes the JAX parameter pytree as numpy arrays (the
``init_params`` layout, or what the JAX package's torch-checkpoint import
returns) and loads it into a new ``NeRFNetwork``; ``load_jax_params`` loads
such a pytree, or part of one, into an existing network in place;
``network_to_jax`` gives the pytree back. ``state_from_numpy`` builds a
``RendererState`` from numpy grids, deriving the sigma bytes and the
occupied bbox and sphere in the port itself. The constructors default to
the card.
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


def jax_from_state_dict(sd: dict) -> dict:
    """The inverse of ``_state_dict_from_jax``: ``NeRFNetwork`` state_dict
    names (numpy values) -> the JAX pytree, linear weights as [in, out]."""
    def linear(prefix):
        p = {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
        if f"{prefix}.bias" in sd:
            p["b"] = sd[f"{prefix}.bias"]
        return p

    def count(prefix):
        return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})

    tree = {}
    for key in dict.fromkeys(k.split(".")[0] for k in sd):
        if key in ("audio_net", "audio_att_net"):
            conv = [{"w": sd[f"{key}.conv.{j}.weight"], "b": sd[f"{key}.conv.{j}.bias"]}
                    for j in range(count(f"{key}.conv."))]
            fc = ([linear(f"{key}.fc.{j}") for j in range(count(f"{key}.fc."))]
                  if key == "audio_net" else linear(f"{key}.fc"))
            tree[key] = {"conv": conv, "fc": fc}
        elif f"{key}.layers.0.weight" in sd:
            tree[key] = {"layers": [linear(f"{key}.layers.{j}")
                                    for j in range(count(f"{key}.layers."))]}
        else:
            tree[key] = sd[key]
    return tree


def network_to_jax(net: NeRFNetwork) -> dict:
    """The network's parameters as the JAX pytree of numpy arrays (what
    ``init_params`` builds and the JAX checkpoints hold)."""
    return jax_from_state_dict({k: v.detach().cpu().numpy()
                                for k, v in net.state_dict().items()})


@torch.no_grad()
def load_jax_params(net: NeRFNetwork, np_params: dict) -> list:
    """Copy a JAX pytree (numpy), or the part of one a checkpoint holds, into
    the network's parameters in place: an optimizer that holds them keeps
    them, and parameters the pytree lacks keep their values. Raises
    ValueError on a shape mismatch; returns the names the network does not
    have."""
    own = dict(net.named_parameters())
    unknown = []
    for name, value in _state_dict_from_jax(np_params).items():
        if name not in own:
            unknown.append(name)
        elif tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)}, "
                             f"network {tuple(own[name].shape)}")
        else:
            own[name].copy_(torch.from_numpy(np.array(value, np.float32)))
    return unknown


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


def bisenet_from_jax(params: dict, device="cuda"):
    """An eval-mode ``preprocess.face_parsing.BiSeNet`` holding the JAX
    face-parsing pytree (``bisenet_init`` / ``load_torch_weights`` layout,
    numpy leaves). The JAX output head's bias must be zero: the reference's
    head has none. The auxiliary heads, which JAX does not keep, stay as
    initialised."""
    from .preprocess.face_parsing import BiSeNet

    dev = resolve_device(device)
    net = BiSeNet(np.asarray(params["conv_out"]["out_w"]).shape[0])
    sd = {}

    def bn(prefix, p):
        for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                             ("running_var", "var")):
            sd[f"{prefix}.{ours}"] = p[theirs]

    def cbr(prefix, p):
        sd[f"{prefix}.conv.weight"] = p["w"]
        bn(f"{prefix}.bn", p["bn"])

    res = params["resnet"]
    sd["cp.resnet.conv1.weight"] = res["conv1"]
    bn("cp.resnet.bn1", res["bn1"])
    for i in range(1, 5):
        for j, blk in enumerate(res[f"layer{i}"]):
            prefix = f"cp.resnet.layer{i}.{j}"
            sd[f"{prefix}.conv1.weight"], sd[f"{prefix}.conv2.weight"] = blk["conv1"], blk["conv2"]
            bn(f"{prefix}.bn1", blk["bn1"])
            bn(f"{prefix}.bn2", blk["bn2"])
            if "down_w" in blk:
                sd[f"{prefix}.downsample.0.weight"] = blk["down_w"]
                bn(f"{prefix}.downsample.1", blk["down_bn"])
    for arm in ("arm16", "arm32"):
        cbr(f"cp.{arm}.conv", params[arm]["conv"])
        sd[f"cp.{arm}.conv_atten.weight"] = params[arm]["atten_w"]
        bn(f"cp.{arm}.bn_atten", params[arm]["atten_bn"])
    for name in ("conv_head32", "conv_head16", "conv_avg"):
        cbr(f"cp.{name}", params[name])
    cbr("ffm.convblk", params["ffm_convblk"])
    sd["ffm.conv1.weight"], sd["ffm.conv2.weight"] = params["ffm_conv1"], params["ffm_conv2"]
    cbr("conv_out.conv", params["conv_out"]["conv"])
    sd["conv_out.conv_out.weight"] = params["conv_out"]["out_w"]
    if np.any(np.asarray(params["conv_out"]["out_b"]) != 0):
        raise ValueError("the output head's bias is not zero; the reference's head has none")
    missing, unexpected = net.load_state_dict(
        {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}, strict=False)
    left = [k for k in missing if not k.startswith(("conv_out16.", "conv_out32."))
            and not k.endswith("num_batches_tracked")]
    if left or unexpected:
        raise ValueError(f"BiSeNet keys not carried: missing {left}, unexpected {unexpected}")
    return net.to(dev).eval()
