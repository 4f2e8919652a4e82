"""Checkpoint files (counterpart of ``radnerf_tpu/train/checkpoint.py``, in
numpy and torch only; reference Trainer.save_checkpoint / load_checkpoint,
nerf/utils.py:1302-1427).

The format is the JAX package's flat ``.npz`` (no pickle): ``model/<path>``
holds the parameters as the JAX pytree (``convert.network_to_jax``: list
entries numbered, linear weights [in, out]), ``state/<name>`` the renderer's
grids and acceleration arrays, ``ema/<path>`` the EMA, ``__meta__`` a JSON
string. So a checkpoint moves between the two packages both ways. The port's
own Adam state goes under ``opt_torch/``, which the JAX loader ignores; a
JAX checkpoint's optax state (``opt/``) is read into the same per-parameter
layout (``restore_opt_state``). ``import_torch_checkpoint`` reads the
reference's ``.pth`` into the same pytree.
"""

from __future__ import annotations

import glob
import json
import os
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
                    meta: Optional[dict] = None, include_grid: bool = True):
    """Write a flat-npz checkpoint. ``params`` and ``ema_params`` are JAX
    pytrees of numpy arrays ('_'-prefixed top-level keys are skipped, as the
    JAX writer skips its derived caches); ``renderer_state`` a
    ``RendererState``, without its density grid unless ``include_grid`` (the
    best checkpoint leaves it out, utils.py:1353-1355); ``opt_torch`` a flat
    dict of numpy arrays; ``meta`` is stored as a JSON string."""
    flat = {}
    _flatten({k: v for k, v in params.items() if not k.startswith("_")}, "model/", flat)
    if renderer_state is not None:
        keys = STATE_KEYS if include_grid else [k for k in STATE_KEYS if k != "density_grid"]
        _flatten({k: getattr(renderer_state, k).detach().cpu().numpy() for k in keys},
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
    a group the file lacks is None. The optimizer state is the port's
    ``opt_torch/`` group, else the JAX package's ``opt/`` group in the same
    layout (``restore_opt_state``)."""
    groups: dict = {"model": {}, "state": {}, "ema": {}, "opt_torch": {}, "opt": {}}
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
    params = _unflatten(groups["model"]) if groups["model"] else None
    ema = _unflatten(groups["ema"]) if groups["ema"] else None
    opt = groups["opt_torch"] or (restore_opt_state(groups["opt"]) if groups["opt"] else None)
    return params, groups["state"] or None, ema, opt, meta


def restore_opt_state(opt_flat: dict) -> dict:
    """A JAX checkpoint's optax state (the ``opt/`` group, without its
    prefix) in the port's per-parameter Adam layout (the ``opt_torch/``
    group): ``<name>/exp_avg``, ``<name>/exp_avg_sq``, ``<name>/step`` per
    ``NeRFNetwork`` parameter and ``scheduler_step`` (JAX
    ``restore_opt_state``, checkpoint.py:232).

    The JAX optimizer is optax's ``multi_transform`` of one
    ``chain(scale_by_adam, scale_by_schedule, scale)`` per learning-rate
    group (``set_to_zero`` for "frozen", which has no state); flattened, a
    group's Adam is ``0/<group>/0/0/{0: count, 1: mu, 2: nu}`` and its
    schedule ``0/<group>/0/1/0``. ``mu`` and ``nu`` are parameter pytrees:
    they take the parameters' names, linear weights transposed to [out, in]
    as ``convert`` transposes the weights. The trainer keeps a parameter's
    fresh state where this lacks it or holds another shape."""
    from ..convert import _state_dict_from_jax

    groups, sched = {}, []
    for key, value in opt_flat.items():
        parts = key.split("/")
        if len(parts) < 5 or parts[0] != "0" or parts[2] != "0":
            continue
        g = groups.setdefault(parts[1], {"count": 0, "1": {}, "2": {}})
        if parts[3:5] == ["0", "0"]:
            g["count"] = int(value)
        elif parts[3] == "0" and parts[4] in ("1", "2"):
            g[parts[4]]["/".join(parts[5:])] = value
        elif parts[3:5] == ["1", "0"]:
            sched.append(int(value))
    flat = {"scheduler_step": np.asarray(max(sched, default=0))}
    for g in groups.values():
        if not g["1"]:
            continue
        mu, nu = (_state_dict_from_jax(_unflatten(g[i])) for i in ("1", "2"))
        for name, v in mu.items():
            flat[f"{name}/exp_avg"] = np.ascontiguousarray(v, np.float32)
            flat[f"{name}/exp_avg_sq"] = np.ascontiguousarray(nu[name], np.float32)
            # Adam keeps its step as a float32 host scalar
            flat[f"{name}/step"] = np.asarray(g["count"], np.float32)
    return flat


def check_arch(path: str, meta: dict, arch: str):
    """Raise ValueError unless the checkpoint's field is ``arch``: its
    ``arch`` record (the port's checkpoints since the architecture switch;
    older ones, JAX's and the reference's ``.pth`` hold RAD-NeRF's field)."""
    saved = meta.get("arch", "radnerf")
    if saved != arch:
        raise ValueError(f"checkpoint {path} holds a {saved!r} field, but this trainer builds "
                         f"{arch!r} (--arch {arch}); load it with --arch {saved}")


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
