"""ER-NeRF's field: the tri-plane hash encoding, region attention and the
torso's adaptive pose encoding (Li et al., "Efficient Region-Aware Neural
Radiance Fields for High-Fidelity Talking Portrait Synthesis", ICCV 2023,
arXiv 2307.09323; https://github.com/Fictionarry/ER-NeRF
``nerf_triplane/network.py``).

``TriplaneNetwork`` has ``NeRFNetwork``'s interface (``encode_audio``,
``field_forward``, ``field_density``, ``torso_deform`` / ``torso_encode`` /
``torso_head``, ``forward_torso``), so the renderer, the captured frame and
the trainer's render path drive either; ``models.build_network`` builds the
one ``NetworkConfig.arch`` names. Its equations:

- f = [f_xy, f_yz, f_xz]: a point's three plane projections, each through
  its own 2-D hash grid (``triplane_spec``: 12 levels of 1 channel, base 64,
  finest 512 x bound, 2^14 entries a level, linear, not aligned), in one
  launch of kernel A-tri (``ops.triplane_encode``), 36 features;
- the audio code a (RAD-NeRF's ``AudioNet`` + ``AudioAttNet`` at audio_dim
  32), weighted by the region attention v = MLP_att(f) (36 -> 64 -> 32):
  a_w = a * v; the eye value weighted by e' = e * sigmoid(MLP_eye(f))
  (36 -> 16 -> 1);
- h = MLP_sigma([f, a_w, e']) (69 -> 64 -> 64 -> 65), sigma = trunc_exp(h_0),
  geo = h_1..64;
- rgb = sigmoid(MLP_c([SH4(d), geo, code])) * 1.002 - 0.001 (84 -> 64 -> 3);
- the per-sample ambient the compositor sums: |v|_2 (ER-NeRF's
  ``ambient_aud``);
- the uncertainty u = softplus(MLP_u(f)) (36 -> 32 -> 1), a training output
  (``field_uncertainty``) no image or depth depends on;
- the torso: anchors A [3, 4], W = A (P^T)^-1 for the frame's 4x4 pose P
  (``poses_matrix``), each anchor's p_k = W_k[:2] / W_k[3] / W_k[2]; x' =
  shrink * x; h = [Freq8(x') (34), Freq3(p) (42), torso code (8)]; dx =
  MLP_def(h) (84 -> 32 -> 32 -> 2); t = the torso grid at clamp(x' + dx, -1,
  1) (RAD-NeRF's: tiled, 2-D, 16 x 2); o = MLP_t([t, h]) (116 -> 32 -> 32 ->
  4); alpha and colour sigmoid(o) * 1.002 - 0.001.

The MLPs are ``MLP``s (bias-free, ReLU between). Compute is float32; the
bf16 policy (``-O``) is refused. Training this field waits for its losses
(ER-NeRF's uncertainty-weighted photometric term and its attention
regularisers, ROADMAP.md "ER-NeRF training"): the trainer refuses a train
step, and kernel A-tri has no backward. Parameter names follow ER-NeRF's
modules: ``encoder_xy``, ``encoder_yz``, ``encoder_xz``, ``aud_ch_att_net``,
``eye_att_net``, ``sigma_net``, ``color_net``, ``unc_net``,
``anchor_points``, ``torso_deform_net``, ``torso_encoder``, ``torso_net``,
and the audio nets and codes as in ``NeRFNetwork``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import GridSpec, freq_encode, freq_output_dim, sh_encode, triplane_encode, trunc_exp
from ..utils.tracing import span
from .audio import AudioAttNet, AudioNet
from .modules import MLP
from .network import NeRFNetwork, NetworkConfig, _codes, _grid_table

# the anchors' initial value (ER-NeRF network.py)
ANCHORS = ((0.01, 0.01, 0.1, 1.0), (-0.1, -0.1, 0.1, 1.0), (0.1, -0.1, 0.1, 1.0))
# the 0.001 margins of ER-NeRF's sigmoid outputs: sigmoid(o) * (1 + 2 m) - m
MARGIN = 0.001
TRAINING_REFUSED = ("training ER-NeRF's field is not implemented yet: its losses (the "
                    "uncertainty-weighted photometric term and the attention regularisers) "
                    "wait for a source in the repository (ROADMAP.md, ER-NeRF training); "
                    "--arch ernerf renders a trained avatar (--test, infer)")


def triplane_spec(bound: float) -> GridSpec:
    """Each plane's 2-D hash grid (ER-NeRF's ``encoder_xy`` and its twins)."""
    return GridSpec.create(input_dim=2, num_levels=12, level_dim=1, base_resolution=64,
                           log2_hashmap_size=14, desired_resolution=512 * bound,
                           gridtype="hash")


def _margined(v: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(v) * (1 + 2 * MARGIN) - MARGIN


_MINORS: dict = {}


def _minor_index(device: torch.device):
    """Row and column indices of the 16 3x3 minors of a 4x4 matrix and their
    cofactor signs, on ``device`` (made once, outside any capture: the
    frame's first, eager render makes them)."""
    if device not in _MINORS:
        ij = [(i, j) for i in range(4) for j in range(4)]
        rows = torch.tensor([[r for r in range(4) if r != i] for i, _ in ij], device=device)
        cols = torch.tensor([[c for c in range(4) if c != j] for _, j in ij], device=device)
        sign = torch.tensor([(-1.0) ** (i + j) for i, j in ij], device=device)
        _MINORS[device] = (rows[:, :, None], cols[:, None, :], sign)
    return _MINORS[device]


def inverse4(m: torch.Tensor) -> torch.Tensor:
    """The inverse of 4x4 matrices [..., 4, 4] as the adjugate over the
    determinant, in a fixed number of elementwise ops: no host sync and no
    solver, so it runs inside a captured frame."""
    rows, cols, sign = _minor_index(m.device)
    s = m[..., rows, cols]  # [..., 16, 3, 3]
    det3 = (s[..., 0, 0] * (s[..., 1, 1] * s[..., 2, 2] - s[..., 1, 2] * s[..., 2, 1])
            - s[..., 0, 1] * (s[..., 1, 0] * s[..., 2, 2] - s[..., 1, 2] * s[..., 2, 0])
            + s[..., 0, 2] * (s[..., 1, 0] * s[..., 2, 1] - s[..., 1, 1] * s[..., 2, 0]))
    cof = (det3 * sign).unflatten(-1, (4, 4))
    det = (m[..., 0, :] * cof[..., 0, :]).sum(dim=-1)
    return cof.transpose(-1, -2) / det[..., None, None]


class TriplaneNetwork(nn.Module):
    """ER-NeRF's field (module docstring) under ``NeRFNetwork``'s interface.

    Args:
      cfg: the architecture (``arch="ernerf"``; float32).
      device: where the parameters live; "cuda" by default.
      generator: CPU ``torch.Generator`` for the initial draw.
    """

    # the pose the torso takes: the frame's 4x4 matrix (the batch's
    # ``poses_matrix``), not RAD-NeRF's 6 numbers
    torso_pose = "poses_matrix"
    # the width of the per-sample ambient the compositor sums: |v|_2
    ambient_out_dim = 1
    encode_audio = NeRFNetwork.encode_audio
    _encode = NeRFNetwork._encode
    torso_encode = NeRFNetwork.torso_encode

    def __init__(self, cfg: NetworkConfig, device="cuda", generator=None):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise ValueError("--arch ernerf renders in float32; the bf16 policy (-O) is not "
                             "implemented for ER-NeRF's field")
        device = resolve_device(device)
        self.cfg = cfg
        g = generator
        spec = self.plane_spec
        f_dim = 3 * spec.output_dim  # 36
        self.audio_net = AudioNet(cfg.audio_in_dim, cfg.audio_dim, generator=g)
        self.audio_att_net = AudioAttNet(cfg.audio_dim, generator=g) if cfg.att > 0 else None
        self.embedding = (nn.Parameter(torch.randn(cfg.audio_in_dim, cfg.audio_in_dim,
                                                   generator=g))
                          if cfg.emb else None)
        self.encoder_xy = _grid_table(spec, g)
        self.encoder_yz = _grid_table(spec, g)
        self.encoder_xz = _grid_table(spec, g)
        self.aud_ch_att_net = MLP(f_dim, cfg.audio_dim, 64, 2, g)
        self.eye_att_net = MLP(f_dim, 1, 16, 2, g) if cfg.exp_eye else None
        self.sigma_net = MLP(f_dim + cfg.audio_dim + cfg.eye_dim, 1 + cfg.geo_feat_dim,
                             cfg.hidden_dim, cfg.num_layers, g)
        self.color_net = MLP(16 + cfg.geo_feat_dim + cfg.ind_dim, 3, cfg.hidden_dim_color,
                             cfg.num_layers_color, g)
        self.unc_net = MLP(f_dim, 1, 32, 2, g)
        self.individual_codes = _codes(cfg.ind_num, cfg.ind_dim, g) if cfg.ind_dim > 0 else None
        if cfg.torso:
            deform_in = freq_output_dim(2, 8)  # 34
            pose_in = freq_output_dim(6, 3)  # 42
            self.anchor_points = nn.Parameter(torch.tensor(ANCHORS))
            self.torso_deform_net = MLP(deform_in + pose_in + cfg.ind_dim_torso, 2, 32, 3, g)
            self.torso_encoder = _grid_table(cfg.torso_spec, g)
            self.torso_net = MLP(cfg.torso_spec.output_dim + deform_in + pose_in
                                 + cfg.ind_dim_torso, 4, 32, 3, g)
            self.individual_codes_torso = (_codes(cfg.ind_num, cfg.ind_dim_torso, g)
                                           if cfg.ind_dim_torso > 0 else None)
        self.to(device)

    @functools.cached_property
    def plane_spec(self) -> GridSpec:
        return triplane_spec(self.cfg.bound)

    def encode_x(self, x: torch.Tensor) -> torch.Tensor:
        """f: the three plane encodes of positions [..., 3], [..., 36]."""
        with span("render.field.triplane"):
            return triplane_encode(x, (self.encoder_xy, self.encoder_yz, self.encoder_xz),
                                   self.plane_spec, self.cfg.bound)

    def _density(self, enc_x, enc_a, e):
        """(sigma, geo_feat, the region attention v) from the features: the
        attention MLPs and the density head."""
        with span("render.field.attention"):
            att = self.aud_ch_att_net(enc_x)
            enc_w = torch.zeros_like(att) if enc_a is None else enc_a * att
            parts = [enc_x, enc_w]
            if self.eye_att_net is not None and e is not None:
                parts.append(e.reshape(-1)[-1] * torch.sigmoid(self.eye_att_net(enc_x)))
            h = self.sigma_net(torch.cat(parts, dim=-1))
            return trunc_exp(h[..., 0]), h[..., 1:], att

    def field_forward(self, x, d, enc_a, c=None, e=None):
        """Full field query, as ``NeRFNetwork.field_forward``: x [..., 3]
        positions, d [..., 3] unit directions, enc_a [1, audio_dim] or None,
        c the individual code or None, e the eye tensor or None. Returns
        (sigma [...], color [..., 3], ambient [..., 1] = |v|_2)."""
        batch = x.shape[:-1]
        sigma, geo_feat, att = self._density(self.encode_x(x), enc_a, e)
        parts = [sh_encode(d, degree=4), geo_feat]
        if c is not None:
            parts.append(c.expand(*batch, c.shape[-1]))
        color = _margined(self.color_net(torch.cat(parts, dim=-1)))
        return sigma, color, att.norm(dim=-1, keepdim=True)

    def field_density(self, x, enc_a, e=None):
        """Density-only query for the grid's upkeep: {"sigma", "geo_feat"}."""
        sigma, geo_feat, _ = self._density(self.encode_x(x), enc_a, e)
        return {"sigma": sigma, "geo_feat": geo_feat}

    def field_uncertainty(self, x):
        """u = softplus(MLP_u(f)) [..., 1] at positions x (a training
        output; the frame does not compute it)."""
        return F.softplus(self.unc_net(self.encode_x(x)))

    def anchor_features(self, pose: torch.Tensor) -> torch.Tensor:
        """APE's pose input [B, 6] from poses [B, 4, 4]: W = A (P^T)^-1, each
        anchor's W_k[:2] / W_k[3] / W_k[2]."""
        w = self.anchor_points @ inverse4(pose.transpose(-1, -2))  # [B, 3, 4]
        return (w[..., :2] / w[..., 3:4] / w[..., 2:3]).reshape(pose.shape[0], -1)

    def forward_torso(self, x, pose, c=None):
        """The torso layer, as ``NeRFNetwork.forward_torso`` with the 4x4
        pose [1, 4, 4]: (alpha [..., 1], color [..., 3], dx [..., 2])."""
        x, h, dx = self.torso_deform(x, pose, c)
        return (*self.torso_head(self.torso_encode(x, dx), h), dx)

    def torso_deform(self, x, pose, c=None):
        """The shrunk coords, their features h ([Freq8(x'), Freq3(p), code])
        and the deform net's offsets dx."""
        if pose is None or tuple(pose.shape[-2:]) != (4, 4):
            raise ValueError("ER-NeRF's torso takes the frame's 4x4 pose (the batch's "
                             f"poses_matrix), got {None if pose is None else tuple(pose.shape)}")
        batch = x.shape[:-1]
        x = x * self.cfg.torso_shrink
        enc_pose = freq_encode(self.anchor_features(pose), 3)  # [1, 42]
        parts = [freq_encode(x, 8), enc_pose[0].expand(*batch, enc_pose.shape[-1])]
        if c is not None:
            parts.append(c.expand(*batch, c.shape[-1]))
        h = torch.cat(parts, dim=-1)
        return x, h, self.torso_deform_net(h)

    def torso_head(self, enc_t, h):
        """The torso MLP on the encode and the features: (alpha, color)."""
        o = self.torso_net(torch.cat([enc_t, h], dim=-1))
        return _margined(o[..., :1]), _margined(o[..., 1:])


def triplane_param_groups(cfg: NetworkConfig) -> dict:
    """Learning-rate group of each top-level parameter name of
    ``TriplaneNetwork`` (as ``network.param_groups``): the tables 'grid', the
    audio attention 'att', the rest 'net'; the torso stage freezes the
    head."""
    head = ("audio_net", "audio_att_net", "encoder_xy", "encoder_yz", "encoder_xz",
            "aud_ch_att_net", "eye_att_net", "sigma_net", "color_net", "unc_net",
            "individual_codes", "embedding")
    if cfg.torso:
        return {**{k: "frozen" for k in head}, "torso_encoder": "grid"}
    groups = {k: "grid" for k in ("encoder_xy", "encoder_yz", "encoder_xz", "embedding")}
    groups["audio_att_net"] = "att"
    return groups
