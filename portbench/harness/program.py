"""How the benchmark touches the program beyond its entry points: building
its options from a cell's files, handing it the parameters the benchmark
drew, and recording, in a traced run only, the inputs of its grid encodes
and the samples each render marched (at the port's op entry points, so the
count follows the work, whatever kernel does it)."""

from __future__ import annotations

import contextlib
import dataclasses

from .common import Refused

# the configuration file's sections, and the program's config class that
# takes a section's keys that ``Options`` lacks
SECTIONS = {"model": "NetworkConfig", "render": "RenderConfig", "train": None}


def configs(cfg: dict, traffic: dict, **given):
    """The program's ``Options``, ``NetworkConfig`` and ``RenderConfig`` for a
    configuration file and a traffic mix, every key by name: a key of the
    configuration's ``model``, ``render`` and ``train`` sections sets the
    ``Options`` field of its name, or else the field of the section's config
    class; then the mix's ``options`` and ``given`` (the files the generator
    wrote, the seed) set ``Options`` fields. ``precision`` ``bfloat16`` is
    the ``-O`` bundle. A key that names no field is refused."""
    from radnerf_tpu_torch import models
    from radnerf_tpu_torch.config import Options

    opt_fields = {f.name for f in dataclasses.fields(Options)}
    opt_kw, extra = {}, {"NetworkConfig": {}, "RenderConfig": {}}
    for section, cls in SECTIONS.items():
        cls_fields = ({f.name for f in dataclasses.fields(getattr(models, cls))}
                      if cls else set())
        for k, v in cfg[section].items():
            if k in opt_fields:
                opt_kw[k] = v
            elif k in cls_fields:
                extra[cls][k] = v
            else:
                raise Refused(f"configuration key {section}.{k} names no field of Options"
                              + (f" or {cls}" if cls else ""))
    for k, v in {**traffic.get("options", {}), **given}.items():
        if k not in opt_fields:
            raise Refused(f"traffic option {k} names no field of Options")
        opt_kw[k] = v
    opt = Options(**opt_kw)
    if cfg["precision"] == "bfloat16":
        opt.apply_O()
    elif cfg["precision"] != "float32":
        raise Refused(f"precision {cfg['precision']!r}: float32 or bfloat16")
    net_cfg = dataclasses.replace(models.NetworkConfig.from_options(opt),
                                  **extra["NetworkConfig"])
    render_cfg = dataclasses.replace(models.RenderConfig.from_options(opt),
                                     **extra["RenderConfig"])
    return opt, net_cfg, render_cfg


def load_params(net, params: dict):
    """Copy the drawn parameters into the program's network, name by name;
    the two sets of names and shapes have to agree."""
    import torch

    mine = dict(net.named_parameters())
    if set(mine) != set(params):
        raise RuntimeError(f"parameter names differ: program only {sorted(set(mine) - set(params))}"
                           f", benchmark only {sorted(set(params) - set(mine))}")
    with torch.no_grad():
        for k, v in params.items():
            if tuple(mine[k].shape) != tuple(v.shape):
                raise RuntimeError(f"{k}: program {tuple(mine[k].shape)}, benchmark "
                                   f"{tuple(v.shape)}")
            mine[k].copy_(v)


@contextlib.contextmanager
def record_calls(out: dict):
    """While the block runs, ``out["encodes"]`` gets each grid encode's
    points (detached), spec, bound, whether its table is bf16, whether x and
    the table take a gradient; ``out["samples"]`` each render's marched
    samples (read back afterwards), rays and lattice width S."""
    import torch

    import radnerf_tpu_torch.models.network as netmod
    import radnerf_tpu_torch.train.trainer as trmod

    enc0, rr0 = netmod.grid_encode, trmod.render_rays
    out["encodes"], out["samples"] = [], []

    def encode(x, table, spec, *args, **kw):
        bound = args[0] if args else kw.get("bound", 1.0)
        out["encodes"].append({
            "x": x.detach(), "spec": spec, "bound": bound,
            "bf16": kw.get("table_dtype") is not None or table.dtype == torch.bfloat16,
            "need_x": bool(x.requires_grad),
            "grad": bool(torch.is_grad_enabled() and table.requires_grad)})
        return enc0(x, table, spec, *args, **kw)

    def render(net, cfg, state, rays_o, *args, **kw):
        res, state = rr0(net, cfg, state, rays_o, *args, **kw)
        out["samples"].append((res["n_samples_needed"], rays_o.shape[0],
                               cfg.march_config().n_sample_slots))
        return res, state

    netmod.grid_encode, trmod.render_rays = encode, render
    try:
        yield
    finally:
        netmod.grid_encode, trmod.render_rays = enc0, rr0
        out["samples"] = [(int(s), n, S) for s, n, S in out["samples"]]
