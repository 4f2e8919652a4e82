"""The audio-conditioned field of RAD-NeRF in plain PyTorch, as functions of
a flat dict of parameters under the program's names, and the draw of those
parameters from a seed on the device.

A frozen copy of ``radnerf_tpu_torch/models/network.py``, ``modules.py``
and ``audio.py`` at commit 2a619bf24d8171cdad65a8fd4e01bbb8c7f3f0f8
(``NetworkConfig``'s grids, ``NeRFNetwork.field_forward`` /
``field_density`` / ``forward_torso`` / ``encode_audio``, ``MLP``,
``AudioNet``, ``AudioAttNet``), written over a parameter dict instead of
modules. The precision policy is a rounding ``q`` (``None``: float32;
bf16 for the ``-O`` policy; fp8 for its control): each MLP rounds its
input and weights by it and its product once, each encode rounds as
``ops.grid_encode`` says, and the field's outputs are rounded where the
program's bf16 policy rounds them. It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .ops import GridSpec, freq_encode, grid_encode, sh_encode4, trunc_exp


class _Round(torch.autograd.Function):
    """Round to a lower float type and back to float32; the gradient is
    rounded the same way (autodiff's view of a cast there and back), to bf16
    where the type is fp8 (fp8 training keeps its gradients wider: e4m3
    would flush them to zero)."""

    @staticmethod
    def forward(ctx, v, dtype, lim):
        ctx.dtype, ctx.lim = dtype, lim
        return _round(v, dtype, lim)

    @staticmethod
    def backward(ctx, g):
        if ctx.lim is not None:
            return _round(g, torch.bfloat16, None), None, None
        return _round(g, ctx.dtype, ctx.lim), None, None


def _round(v, dtype, lim):
    if lim is not None:  # fp8 e4m3 has no infinity: saturate first
        v = v.clamp(-lim, lim)
    return v.to(dtype).to(torch.float32)


def rounding(name: str):
    """The rounding of a precision: None for float32 (and TF32, which is a
    flag of the GEMMs), else a function."""
    if name in ("float32", "tf32"):
        return None
    if name == "bfloat16":
        return lambda v: _Round.apply(v, torch.bfloat16, None)
    if name == "fp8":
        return lambda v: _Round.apply(v, torch.float8_e4m3fn, 448.0)
    raise ValueError(f"unknown precision {name!r}")


@contextlib.contextmanager
def lower_precision(name: str):
    """TF32 GEMMs and convolutions while the block runs, for the ``tf32``
    control; nothing for a rounding control (``rounding`` does it)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if name == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class Arch:
    """The widths of ``NetworkConfig`` at RAD-NeRF's defaults, from a
    configuration file's ``model`` block."""

    def __init__(self, m: dict, torso: bool):
        self.audio_in_dim, self.audio_dim = m["audio_in_dim"], m["audio_dim"]
        self.hidden, self.geo_feat = m["hidden_dim"], m["geo_feat_dim"]
        self.num_layers, self.num_layers_color = m["num_layers"], m["num_layers_color"]
        self.hidden_color = m["hidden_dim_color"]
        self.num_layers_ambient, self.hidden_ambient = m["num_layers_ambient"], m["hidden_dim_ambient"]
        self.ambient_dim, self.ind_dim, self.ind_num = m["ambient_dim"], m["ind_dim"], m["ind_num"]
        self.ind_dim_torso, self.torso_shrink = m["ind_dim_torso"], m["torso_shrink"]
        self.bound, self.exp_eye, self.torso = m["bound"], m["exp_eye"], torso
        L, C, base = m["grid_levels"], m["grid_ch"], m["grid_base"]
        self.grid = GridSpec.create(3, L, C, base, 16, 2048 * self.bound)
        self.ambient = GridSpec.create(self.ambient_dim, L, C, base, 16, 2048)
        self.torso_grid = GridSpec.create(2, L, C, base, 16, 2048)

    def params(self) -> list:
        """(name, shape, kind) of every parameter, the program's names;
        kind: table, code, weight (fan_in = prod(shape[1:])), bias (its
        weight's fan_in)."""
        out = []

        def linear(name, i, o, bias):
            out.append((f"{name}.weight", (o, i), "weight"))
            if bias:
                out.append((f"{name}.bias", (o,), ("bias", i)))

        def conv(name, i, o):
            out.append((f"{name}.weight", (o, i, 3), "weight"))
            out.append((f"{name}.bias", (o,), ("bias", 3 * i)))

        def mlp(name, i, o, h, n):
            for l in range(n):
                linear(f"{name}.layers.{l}", i if l == 0 else h, o if l == n - 1 else h, False)

        for k, (ci, co) in enumerate(((self.audio_in_dim, 32), (32, 32), (32, 64), (64, 64))):
            conv(f"audio_net.conv.{k}", ci, co)
        linear("audio_net.fc.0", 64, 64, True)
        linear("audio_net.fc.1", 64, self.audio_dim, True)
        out.append(("encoder", (self.grid.n_embeddings, self.grid.level_dim), "table"))
        out.append(("encoder_ambient", (self.ambient.n_embeddings, self.ambient.level_dim),
                    "table"))
        mlp("ambient_net", self.grid.output_dim + self.audio_dim, self.ambient_dim,
            self.hidden_ambient, self.num_layers_ambient)
        mlp("sigma_net", self.grid.output_dim + self.ambient.output_dim + int(self.exp_eye),
            1 + self.geo_feat, self.hidden, self.num_layers)
        mlp("color_net", 16 + self.geo_feat + self.ind_dim, 3, self.hidden_color,
            self.num_layers_color)
        for k, (ci, co) in enumerate(((self.audio_dim, 16), (16, 8), (8, 4), (4, 2), (2, 1))):
            conv(f"audio_att_net.conv.{k}", ci, co)
        linear("audio_att_net.fc", 8, 8, True)
        out.append(("individual_codes", (self.ind_num, self.ind_dim), "code"))
        if self.torso:
            mlp("torso_deform_net", 42 + 54 + self.ind_dim_torso, 2, 64, 3)
            out.append(("torso_encoder", (self.torso_grid.n_embeddings,
                                          self.torso_grid.level_dim), "table"))
            mlp("torso_net", self.torso_grid.output_dim + 42 + 54 + self.ind_dim_torso, 4, 32, 3)
            out.append(("individual_codes_torso", (self.ind_num, self.ind_dim_torso), "code"))
        return out


@torch.no_grad()
def draw_params(arch: Arch, recipe: str, seed: int, device) -> dict:
    """Every parameter from ``seed`` on ``device``, in two draws (one uniform
    for all but the codes, one normal for the codes):

    - ``avatar``: the bench scene's recipe (``scene.random_weights``): grid
      tables U(-4, 4), He-uniform U(+-sqrt(6 / fan_in)) weights, biases
      U(+-1 / sqrt(fan_in)), codes N(0, 0.1);
    - ``fresh``: the program's initial draw of a new identity: tables
      U(-1e-4, 1e-4), weights and biases U(+-1 / sqrt(fan_in)), codes
      N(0, 0.1)."""
    spec = arch.params()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(s) for _, s, k in spec if k != "code"]
    uni = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    codes = [s for _, s, k in spec if k == "code"]
    nrm = torch.randn(sum(math.prod(s) for s in codes), generator=gen, device=device)
    params, iu, inn = {}, 0, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind == "code":
            params[name] = (nrm[inn:inn + n] * 0.1).reshape(shape).clone()
            inn += n
            continue
        u = uni[iu:iu + n].reshape(shape)
        iu += n
        if kind == "table":
            b = 4.0 if recipe == "avatar" else 1e-4
        elif kind == "weight":
            fan = math.prod(shape[1:])
            b = math.sqrt(6.0 / fan) if recipe == "avatar" else 1.0 / math.sqrt(fan)
        else:
            b = 1.0 / math.sqrt(kind[1])
        params[name] = (u * b).clone()
    return params


def _mlp(p, name, x, n, q):
    for l in range(n):
        w = p[f"{name}.layers.{l}.weight"]
        if q is None:
            x = F.linear(x, w)
        else:
            x = q(F.linear(q(x), q(w)))
        if l != n - 1:
            x = F.relu(x)
    return x


def _conv(p, name, x, stride):
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=torch.backends.cudnn.allow_tf32):
        return F.conv1d(x, p[f"{name}.weight"], p[f"{name}.bias"], stride, 1)


def _leaky(x):
    return F.leaky_relu(x, 0.02)


def encode_audio(p, arch: Arch, a: torch.Tensor) -> torch.Tensor:
    """Audio window [8, audio_in_dim, 16] -> [1, audio_dim]."""
    x = a[:, :, 0:16]
    for k in range(4):
        x = _leaky(_conv(p, f"audio_net.conv.{k}", x, 2))
    x = _leaky(F.linear(x[..., 0], p["audio_net.fc.0.weight"], p["audio_net.fc.0.bias"]))
    enc = F.linear(x, p["audio_net.fc.1.weight"], p["audio_net.fc.1.bias"])[None]
    seq = enc.shape[1]
    y = enc.permute(0, 2, 1)
    for k in range(5):
        y = _leaky(_conv(p, f"audio_att_net.conv.{k}", y, 1))
    y = F.linear(y.reshape(1, seq), p["audio_att_net.fc.weight"], p["audio_att_net.fc.bias"])
    y = torch.softmax(y, dim=1).reshape(1, seq, 1)
    return (y * enc).sum(dim=1)


def _trunk(p, arch: Arch, x, enc_a, q):
    enc_x = grid_encode(x, p["encoder"], arch.grid, arch.bound, q)
    a = enc_a.expand(*x.shape[:-1], enc_a.shape[-1])
    h = torch.cat([enc_x, a if q is None else q(a)], dim=-1)
    ambient = torch.tanh(_mlp(p, "ambient_net", h, arch.num_layers_ambient, q))
    enc_w = grid_encode(ambient, p["encoder_ambient"], arch.ambient, 1.0, q)
    return enc_x, enc_w, ambient


def _sigma_head(p, arch: Arch, enc_x, enc_w, eye, q):
    parts = [enc_x, enc_w]
    if eye is not None:
        e = eye.reshape(-1)[-1].expand(*enc_x.shape[:-1], 1)
        parts.append(e if q is None else q(e))
    h = _mlp(p, "sigma_net", torch.cat(parts, dim=-1), arch.num_layers, q)
    return trunc_exp(h[..., 0]), h[..., 1:]


def field_forward(p, arch: Arch, x, d, enc_a, code, eye, q=None):
    """(sigma [...], color [..., 3], ambient [..., amb]) at positions x."""
    enc_x, enc_w, ambient = _trunk(p, arch, x, enc_a, q)
    sigma, geo = _sigma_head(p, arch, enc_x, enc_w, eye, q)
    sh = sh_encode4(d)
    parts = [sh if q is None else q(sh), geo]
    if code is not None:
        c = code.expand(*x.shape[:-1], code.shape[-1])
        parts.append(c if q is None else q(c))
    color = torch.sigmoid(_mlp(p, "color_net", torch.cat(parts, dim=-1),
                               arch.num_layers_color, q))
    return sigma, color, ambient


def field_density(p, arch: Arch, x, enc_a, eye, q=None):
    enc_x, enc_w, _ = _trunk(p, arch, x, enc_a, q)
    return _sigma_head(p, arch, enc_x, enc_w, eye, q)[0]


def forward_torso(p, arch: Arch, x, pose6, code, q=None):
    """The 2-D torso layer: (alpha [..., 1], color [..., 3])."""
    x = x * arch.torso_shrink
    enc_pose = freq_encode(pose6, 4)
    parts = [freq_encode(x, 10), enc_pose[0].expand(*x.shape[:-1], enc_pose.shape[-1])]
    if code is not None:
        parts.append(code.expand(*x.shape[:-1], code.shape[-1]))
    h = torch.cat(parts, dim=-1)
    hq = h if q is None else q(h)
    dx = _mlp(p, "torso_deform_net", hq, 3, q)
    xp = torch.clamp(x + dx, -1.0, 1.0)
    enc_t = grid_encode(xp, p["torso_encoder"], arch.torso_grid, 1.0, q)
    h2 = _mlp(p, "torso_net", torch.cat([enc_t, hq], dim=-1), 3, q)
    return torch.sigmoid(h2[..., :1]), torch.sigmoid(h2[..., 1:])
