"""Checkpoint files (counterpart of ``radnerf_tpu/train/checkpoint.py``, in
numpy and torch only; reference Trainer.save_checkpoint / load_checkpoint,
nerf/utils.py:1302-1427).

The format is the JAX package's flat ``.npz`` (no pickle): ``model/<path>``
holds the parameters as the JAX pytree (``convert.network_to_jax``: list
entries numbered, linear weights [in, out]), ``state/<name>`` the renderer's
grids and acceleration arrays, ``ema/<path>`` the EMA, ``__meta__`` a JSON
string. So a checkpoint moves between the two packages both ways. The port's
own Adam state goes under ``opt_torch/``, which the JAX loader ignores; a
JAX checkpoint's optax state (``opt/``) is skipped here with a warning.
``import_torch_checkpoint`` reads the reference's ``.pth`` into the same
pytree.
"""

from __future__ import annotations

import glob
import json
import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

# renderer state arrays a checkpoint holds (JAX save_checkpoint; its best
# checkpoints leave out the density grid, which the loaders allow)
STATE_KEYS = ("density_bitfield", "mean_density", "density_grid_torso", "mean_density_torso",
              "sigma_bytes", "occ_bbox", "occ_sphere", "density_grid")


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def save_checkpoint(path: str, params: dict, renderer_state=None,
                    opt_torch: Optional[dict] = None, ema_params: Optional[dict] = None,
                    meta: Optional[dict] = None):
    """Write a flat-npz checkpoint. ``params`` and ``ema_params`` are JAX
    pytrees of numpy arrays ('_'-prefixed top-level keys are skipped, as the
    JAX writer skips its derived caches); ``renderer_state`` a
    ``RendererState``; ``opt_torch`` a flat dict of numpy arrays;
    ``meta`` is stored as a JSON string."""
    flat = {}
    _flatten({k: v for k, v in params.items() if not k.startswith("_")}, "model/", flat)
    if renderer_state is not None:
        _flatten({k: getattr(renderer_state, k).detach().cpu().numpy() for k in STATE_KEYS},
                 "state/", flat)
    if opt_torch is not None:
        _flatten(opt_torch, "opt_torch/", flat)
    if ema_params is not None:
        _flatten(ema_params, "ema/", flat)
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_checkpoint(path: str):
    """Read back (params, state_arrays, ema_params, opt_torch_flat, meta);
    a group the file lacks is None."""
    groups: dict = {"model": {}, "state": {}, "ema": {}, "opt_torch": {}}
    meta = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if key == "__meta__":
                meta = json.loads(bytes(z[key]).decode())
                continue
            head, _, rest = key.partition("/")
            if rest.startswith("_"):
                # derived caches of older JAX checkpoints (TPU packed tables)
                continue
            groups.setdefault(head, {})[rest] = z[key]
    if groups.pop("opt", None):
        warnings.warn(f"{path}: the optax optimizer state (opt/) is not restored into "
                      "torch Adam; Adam starts afresh")
    params = _unflatten(groups["model"]) if groups["model"] else None
    ema = _unflatten(groups["ema"]) if groups["ema"] else None
    return params, groups["state"] or None, ema, groups["opt_torch"] or None, meta


def latest_checkpoint(ckpt_dir: str, name: str = "ngp") -> Optional[str]:
    """The newest epoch checkpoint by file name (utils.py:1364-1369)."""
    lst = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.npz")))
    return lst[-1] if lst else None


def merge_imported(params: dict, imported: dict) -> Tuple[dict, list]:
    """strict=False merge of top-level groups: overwrite the imported ones,
    keep the rest (utils.py:1381-1386, main.py:146-151). Returns (params,
    loaded_keys)."""
    out = dict(params)
    out.update(imported)
    return out, list(imported)


# ------------------------------------------------------- torch .pth import
def _t(x):
    return np.asarray(x, dtype=np.float32)


def _map_mlp(sd: dict, prefix: str, n_layers: int):
    return {"layers": [{"w": _t(sd[f"{prefix}.net.{l}.weight"]).T} for l in range(n_layers)]}


def _map_conv_stack(sd: dict, prefix: str, ids):
    return [{"w": _t(sd[f"{prefix}.{i}.weight"]), "b": _t(sd[f"{prefix}.{i}.bias"])}
            for i in ids]


def import_torch_checkpoint(path: str) -> Tuple[dict, dict, dict]:
    """Import a reference RAD-NeRF torch checkpoint.

    Returns (params as the JAX pytree of numpy arrays, state_arrays, meta);
    state_arrays may lack 'density_grid' (the reference's best checkpoints
    drop it, utils.py:1353-1355). Key layout: the reference's network.py:91-167
    module names and renderer.py:88-127 buffers.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}

    params: dict = {
        "audio_net": {
            "conv": _map_conv_stack(sd, "audio_net.encoder_conv", (0, 2, 4, 6)),
            "fc": [
                {"w": _t(sd["audio_net.encoder_fc1.0.weight"]).T,
                 "b": _t(sd["audio_net.encoder_fc1.0.bias"])},
                {"w": _t(sd["audio_net.encoder_fc1.2.weight"]).T,
                 "b": _t(sd["audio_net.encoder_fc1.2.bias"])},
            ],
        },
        "encoder": _t(sd["encoder.embeddings"]),
        "encoder_ambient": _t(sd["encoder_ambient.embeddings"]),
        "ambient_net": _map_mlp(sd, "ambient_net", 3),
        "sigma_net": _map_mlp(sd, "sigma_net", 3),
        "color_net": _map_mlp(sd, "color_net", 2),
    }
    if "audio_att_net.attentionConvNet.0.weight" in sd:
        params["audio_att_net"] = {
            "conv": _map_conv_stack(sd, "audio_att_net.attentionConvNet", (0, 2, 4, 6, 8)),
            "fc": {"w": _t(sd["audio_att_net.attentionNet.0.weight"]).T,
                   "b": _t(sd["audio_att_net.attentionNet.0.bias"])},
        }
    if "individual_codes" in sd:
        params["individual_codes"] = _t(sd["individual_codes"])
    if "embedding.weight" in sd:
        params["embedding"] = _t(sd["embedding.weight"])
    if "torso_encoder.embeddings" in sd:
        params["torso_encoder"] = _t(sd["torso_encoder.embeddings"])
        params["torso_deform_net"] = _map_mlp(sd, "torso_deform_net", 3)
        params["torso_net"] = _map_mlp(sd, "torso_net", 3)
    if "individual_codes_torso" in sd:
        params["individual_codes_torso"] = _t(sd["individual_codes_torso"])
    if "camera_dR" in sd:
        params["camera_dR"] = _t(sd["camera_dR"])
        params["camera_dT"] = _t(sd["camera_dT"])

    state: dict = {}
    if "density_grid" in sd:
        state["density_grid"] = _t(sd["density_grid"])
    if "density_bitfield" in sd:
        state["density_bitfield"] = np.asarray(sd["density_bitfield"], np.uint8)
    if "density_grid_torso" in sd:
        state["density_grid_torso"] = _t(sd["density_grid_torso"])

    meta = {
        "epoch": int(ckpt.get("epoch", 0)),
        "global_step": int(ckpt.get("global_step", 0)),
        "mean_density": float(ckpt.get("mean_density", 0.0)),
        "mean_density_torso": float(ckpt.get("mean_density_torso", 0.0)),
    }
    return params, state, meta
