"""ER-NeRF's field in plain PyTorch, as functions of a flat dict of
parameters under the program's names, and the draw of those parameters from
a seed on the device.

ER-NeRF: Li et al., "Efficient Region-Aware Neural Radiance Fields for
High-Fidelity Talking Portrait Synthesis", ICCV 2023, arXiv 2307.09323;
https://github.com/Fictionarry/ER-NeRF ``nerf_triplane/network.py``. The
equations, as that file reads:

- Tri-plane hash encoding. A point x in [-bound, bound]^3 is projected onto
  the planes (x, y), (y, z) and (x, z); each plane has its own 2-D hash grid
  of 12 levels of 1 channel, base resolution 64, finest 512 x bound
  (per_level_scale 8^(1/11)), 2^14 entries a level, linear interpolation,
  not aligned. f = [f_xy, f_yz, f_xz], 36 features.
- Region attention. a = AudioAttNet(AudioNet(window)), RAD-NeRF's audio path
  at audio_dim 32 on DeepSpeech features (29 channels); v = MLP_att(f),
  36 -> 64 -> 32 (2 layers, ReLU, no biases); a_w = a * v.
- Eye attention. e' = e * sigmoid(MLP_eye(f)), 36 -> 16 -> 1.
- Density. h = MLP_sigma([f, a_w, e']), 69 -> 64 -> 64 -> 65; sigma =
  exp(h_0) (``trunc_exp``'s forward); geo = h_1..64.
- Colour. rgb = sigmoid(MLP_c([SH4(d), geo, code])) * 1.002 - 0.001,
  84 -> 64 -> 3; the code of ind_dim 4 of 10,000.
- Composited ambient. |v|_2 (ER-NeRF's ``ambient_aud``).
- Uncertainty. u = softplus(MLP_u(f)), 36 -> 32 -> 1; no image or depth
  depends on it.
- Torso with adaptive pose encoding. Anchors A [3, 4], initially
  [[0.01, 0.01, 0.1, 1], [-0.1, -0.1, 0.1, 1], [0.1, -0.1, 0.1, 1]]; W =
  A (P^T)^-1 for the frame's 4x4 pose P; p_k = W_k[:2] / W_k[3] / W_k[2]
  (6 numbers); x' = 0.8 x; h = [Freq8(x') (34), Freq3(p) (42), torso code
  (8)]; dx = MLP_def(h), 84 -> 32 -> 32 -> 2; t = TorsoGrid(clamp(x' + dx,
  -1, 1)) (RAD-NeRF's: tiled, 2-D, 16 x 2, base 16, finest 2048); o =
  MLP_t([t, h]), 116 -> 32 -> 32 -> 4; alpha and colour sigmoid(o) * 1.002
  - 0.001.

Departures, none in what a frame computes: the parameters are a flat dict
under the program's names (``radnerf_tpu_torch/models/network_triplane.py``)
rather than ER-NeRF's modules; the inverse is ``torch.linalg.inv``, where the
program forms the adjugate over the determinant (rounding differs in the last
bits); the precision is float32 alone (``rounding`` is None), TF32 off but
under the ``tf32`` control (``field.lower_precision``). The hash grid and
the tiled torso grid follow ``ops.grid_encode``'s arithmetic (a hashed
level: the XOR of ``coord_d * prime_d`` in uint32, as the reference CUDA
grid encoder). It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import field as fld
from .ops import (GridSpec, corner_rows, freq_encode, gather_rows, grid_encode, sh_encode4,
                  trunc_exp)

_U32_MASK = (1 << 32) - 1
# the spatial hash's primes of dims 0 and 1
_PRIMES = (1, 2654435761)
ANCHORS = ((0.01, 0.01, 0.1, 1.0), (-0.1, -0.1, 0.1, 1.0), (0.1, -0.1, 0.1, 1.0))
MARGIN = 0.001
PLANES = ((0, 1), (1, 2), (0, 2))


class Arch:
    """ER-NeRF's widths from a configuration file's ``model`` block."""

    def __init__(self, m: dict, torso: bool):
        self.audio_in_dim, self.audio_dim, self.att = m["audio_in_dim"], m["audio_dim"], m["att"]
        self.hidden, self.geo_feat = m["hidden_dim"], m["geo_feat_dim"]
        self.num_layers, self.num_layers_color = m["num_layers"], m["num_layers_color"]
        self.hidden_color = m["hidden_dim_color"]
        self.ind_dim, self.ind_num, self.ind_dim_torso = m["ind_dim"], m["ind_num"], m["ind_dim_torso"]
        self.bound, self.exp_eye, self.torso_shrink = m["bound"], m["exp_eye"], m["torso_shrink"]
        self.torso = torso
        self.plane = GridSpec.create(2, 12, 1, 64, 14, 512 * self.bound)
        self.torso_grid = GridSpec.create(2, 16, 2, 16, 16, 2048)

    @property
    def f_dim(self) -> int:
        return 3 * self.plane.output_dim

    def mlps(self) -> dict:
        """name -> (in, out, hidden, layers) of every MLP a frame runs."""
        out = {"aud_ch_att_net": (self.f_dim, self.audio_dim, 64, 2),
               "sigma_net": (self.f_dim + self.audio_dim + int(self.exp_eye), 1 + self.geo_feat,
                             self.hidden, self.num_layers),
               "color_net": (16 + self.geo_feat + self.ind_dim, 3, self.hidden_color,
                             self.num_layers_color)}
        if self.exp_eye:
            out["eye_att_net"] = (self.f_dim, 1, 16, 2)
        if self.torso:
            h = 34 + 42 + self.ind_dim_torso
            out["torso_deform_net"] = (h, 2, 32, 3)
            out["torso_net"] = (self.torso_grid.output_dim + h, 4, 32, 3)
        return out

    def params(self) -> list:
        """(name, shape, kind) of every parameter, the program's names;
        kinds as ``field.Arch.params``, and ``anchors``."""
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
        if self.att > 0:
            for k, (ci, co) in enumerate(((self.audio_dim, 16), (16, 8), (8, 4), (4, 2),
                                          (2, 1))):
                conv(f"audio_att_net.conv.{k}", ci, co)
            linear("audio_att_net.fc", 8, 8, True)
        for plane in ("xy", "yz", "xz"):
            out.append((f"encoder_{plane}", (self.plane.n_embeddings, 1), "table"))
        mlps = self.mlps()
        for name in ("aud_ch_att_net", "eye_att_net", "sigma_net", "color_net"):
            if name in mlps:
                mlp(name, *mlps[name])
        mlp("unc_net", self.f_dim, 1, 32, 2)
        out.append(("individual_codes", (self.ind_num, self.ind_dim), "code"))
        if self.torso:
            out.append(("anchor_points", (3, 4), "anchors"))
            mlp("torso_deform_net", *mlps["torso_deform_net"])
            out.append(("torso_encoder", (self.torso_grid.n_embeddings, 2), "table"))
            mlp("torso_net", *mlps["torso_net"])
            out.append(("individual_codes_torso", (self.ind_num, self.ind_dim_torso), "code"))
        return out


@torch.no_grad()
def draw_params(arch: Arch, recipe: str, seed: int, device) -> dict:
    """Every parameter from ``seed`` on ``device``, as ``field.draw_params``
    draws RAD-NeRF's (one uniform draw for tables, weights and biases, one
    normal draw for the codes; ``avatar``: tables U(-4, 4), He-uniform
    weights, so the head is visible), the anchors at their initial value."""
    spec = arch.params()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    drawn = [(n, s, k) for n, s, k in spec if k not in ("code", "anchors")]
    uni = torch.rand(sum(math.prod(s) for _, s, _ in drawn), generator=gen,
                     device=device) * 2.0 - 1.0
    nrm = torch.randn(sum(math.prod(s) for _, s, k in spec if k == "code"), generator=gen,
                      device=device)
    params, iu, inn = {}, 0, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind == "anchors":
            params[name] = torch.tensor(ANCHORS, device=device)
        elif kind == "code":
            params[name] = (nrm[inn:inn + n] * 0.1).reshape(shape).clone()
            inn += n
        else:
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


def _hashed(spec: GridSpec, level: int) -> bool:
    n = int(np.ceil(spec.level_scale(level))) + 2
    return n ** spec.input_dim > spec.level_size(level)


def plane_rows(spec: GridSpec, level: int, corner_grid: torch.Tensor) -> torch.Tensor:
    """Flat table row of integer corner coords [..., 2] of a hash grid: the
    dense index where the level's n^2 cells fit its table, else the hash."""
    if not _hashed(spec, level):
        return corner_rows(spec, level, corner_grid)
    index = torch.zeros(corner_grid.shape[:-1], dtype=torch.int64, device=corner_grid.device)
    for d in range(spec.input_dim):
        index = index ^ ((corner_grid[..., d] * _PRIMES[d]) & _U32_MASK)
    return index % spec.level_size(level) + spec.offsets[level]


def plane_corners(x01: torch.Tensor, spec: GridSpec, level: int):
    """[(rows, weight)] of the 4 corners of each point's cell at a level."""
    pos = x01 * spec.level_scale(level) + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    pg = pos_grid.to(torch.int64)
    out = []
    for corner in range(4):
        bits = [corner & 1, (corner >> 1) & 1]
        w = (frac[..., 0] if bits[0] else 1.0 - frac[..., 0]) * \
            (frac[..., 1] if bits[1] else 1.0 - frac[..., 1])
        cg = pg + torch.tensor(bits, dtype=torch.int64, device=x01.device)
        out.append((plane_rows(spec, level, cg), w))
    return out


def plane_encode(x: torch.Tensor, table: torch.Tensor, spec: GridSpec, bound: float):
    """A 2-D hash grid's encode of points [..., 2] in [-bound, bound]: [..., L C]
    float32, 0 outside the square; corners summed in order."""
    x01 = (x.float() + bound) / (2.0 * bound)
    inb = 1.0 - ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1).float()
    outs = []
    for level in range(spec.num_levels):
        out = None
        for rows, w in plane_corners(x01, spec, level):
            term = (inb * w)[..., None] * gather_rows(table, rows)
            out = term if out is None else out + term
        outs.append(out)
    return torch.cat(outs, dim=-1)


def triplane(p, arch: Arch, x):
    """f = [f_xy, f_yz, f_xz] at positions x [..., 3]."""
    return torch.cat([plane_encode(x[..., list(dims)], p[f"encoder_{name}"], arch.plane,
                                   arch.bound)
                      for dims, name in zip(PLANES, ("xy", "yz", "xz"))], dim=-1)


def _mlp(p, name, x, n):
    for l in range(n):
        x = F.linear(x, p[f"{name}.layers.{l}.weight"])
        if l != n - 1:
            x = F.relu(x)
    return x


def _margined(v):
    return torch.sigmoid(v) * (1 + 2 * MARGIN) - MARGIN


def density(p, arch: Arch, f, enc_a, eye):
    """(sigma [...], geo [..., 64], v [..., audio_dim]) from the features."""
    v = _mlp(p, "aud_ch_att_net", f, 2)
    parts = [f, enc_a * v]
    if arch.exp_eye:
        parts.append(eye.reshape(-1)[-1] * torch.sigmoid(_mlp(p, "eye_att_net", f, 2)))
    h = _mlp(p, "sigma_net", torch.cat(parts, dim=-1), arch.num_layers)
    return trunc_exp(h[..., 0]), h[..., 1:], v


def field_forward(p, arch: Arch, x, d, enc_a, code, eye):
    """(sigma [...], color [..., 3], ambient [..., 1]) at positions x."""
    sigma, geo, v = density(p, arch, triplane(p, arch, x), enc_a, eye)
    c = code.expand(*x.shape[:-1], code.shape[-1])
    color = _margined(_mlp(p, "color_net", torch.cat([sh_encode4(d), geo, c], dim=-1),
                           arch.num_layers_color))
    return sigma, color, v.norm(dim=-1, keepdim=True)


def field_density(p, arch: Arch, x, enc_a, eye):
    return density(p, arch, triplane(p, arch, x), enc_a, eye)[0]


def field_uncertainty(p, arch: Arch, x):
    return F.softplus(_mlp(p, "unc_net", triplane(p, arch, x), 2))


def anchor_features(p, pose):
    """APE's [B, 6] from poses [B, 4, 4]: W = A (P^T)^-1, W_k[:2] / W_k[3] /
    W_k[2] for each anchor."""
    w = p["anchor_points"] @ torch.linalg.inv(pose.transpose(-1, -2))
    return (w[..., :2] / w[..., 3:4] / w[..., 2:3]).reshape(pose.shape[0], -1)


def forward_torso(p, arch: Arch, x, pose, code):
    """The torso layer: (alpha [..., 1], color [..., 3])."""
    x = x * arch.torso_shrink
    enc_pose = freq_encode(anchor_features(p, pose), 3)
    parts = [freq_encode(x, 8), enc_pose[0].expand(*x.shape[:-1], enc_pose.shape[-1]),
             code.expand(*x.shape[:-1], code.shape[-1])]
    h = torch.cat(parts, dim=-1)
    dx = _mlp(p, "torso_deform_net", h, 3)
    enc_t = grid_encode(torch.clamp(x + dx, -1.0, 1.0), p["torso_encoder"], arch.torso_grid, 1.0)
    o = _mlp(p, "torso_net", torch.cat([enc_t, h], dim=-1), 3)
    return _margined(o[..., :1]), _margined(o[..., 1:])


encode_audio = fld.encode_audio
lower_precision = fld.lower_precision
