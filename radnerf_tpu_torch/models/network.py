"""The audio-conditioned NeRF field (counterpart of
``radnerf_tpu/models/network.py``).

``NeRFNetwork`` holds every parameter of the JAX ``init_params`` pytree under
the same names: ``audio_net``, ``audio_att_net``, ``encoder``,
``encoder_ambient``, ``ambient_net``, ``sigma_net``, ``color_net``,
``individual_codes`` and, with the torso, ``torso_deform_net``,
``torso_encoder``, ``torso_net``, ``individual_codes_torso``. The three grid
encodes of a frame go through kernel A (``ops.grid_encode``), and their
gradients through kernel A'; the MLPs, encoders and activations around them
are plain PyTorch. ``param_groups`` names each parameter's learning-rate
group.

Compute is float32, or under the bf16 policy (``-O``,
``compute_dtype="bfloat16"``) what the JAX package computes in bf16: every
MLP in bf16 (input and weight cast, the float32 master weights kept), the
grid encodes on bf16 tables with a bf16 lerp (kernels A-bf16 and A'-bf16),
the ``cat``s of bf16 parts; the ambient MLP's output, the density
(``trunc_exp``), the colour's sigmoid and the torso's outputs back in
float32 where JAX casts them back. Where no gradient reaches a grid table
(evaluation, the upkeep, the frozen head of the torso stage) its bf16 copy
and, on the card, that copy's corner-packed rows (what kernel A-bf16 reads)
are made once per parameter value (``table_copy``, ``packed_copy``), as
JAX's ``precompute_packed_tables``; a train step casts and packs the master
table inside its encode. The copies are never parameters, and no
checkpoint holds them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import (
    GridSpec, freq_encode, freq_output_dim, grid_encode, pack_table, sh_encode, trunc_exp,
)
from .audio import AudioAttNet, AudioNet
from .modules import MLP


# the fields the port builds (``models.build_network``): RAD-NeRF's
# ``NeRFNetwork`` and ER-NeRF's ``TriplaneNetwork``
ARCHS = ("radnerf", "ernerf")
# ER-NeRF's audio code width (its network.py fixes it; RAD-NeRF's is 64)
ERNERF_AUDIO_DIM = 32


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Static architecture description (the JAX ``NetworkConfig``, and
    ``arch``, which field the port builds)."""

    audio_in_dim: int = 44
    audio_dim: int = 64
    att: int = 2
    emb: bool = False
    bound: float = 1.0
    exp_eye: bool = True
    ind_dim: int = 4
    ind_num: int = 10_000
    ind_dim_torso: int = 8
    torso: bool = False
    torso_shrink: float = 0.8
    train_camera: bool = False
    num_layers: int = 3
    hidden_dim: int = 64
    geo_feat_dim: int = 64
    num_layers_color: int = 2
    hidden_dim_color: int = 64
    num_layers_ambient: int = 3
    hidden_dim_ambient: int = 64
    ambient_dim: int = 2
    compute_dtype: str = "float32"
    grid_levels: int = 16
    grid_ch: int = 2
    grid_base: int = 16
    amb_grid_levels: Optional[int] = None
    amb_grid_ch: Optional[int] = None
    amb_grid_base: Optional[int] = None
    arch: str = "radnerf"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}: float32 or bfloat16")
        if self.arch not in ARCHS:
            raise ValueError(f"arch={self.arch!r}: one of {ARCHS}")

    @property
    def dtype(self) -> torch.dtype:
        """The MLPs' compute type."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def table_dtype(self):
        """The grid tables' type in the encodes: bf16 under the bf16 policy
        (the reference's AMP runs its grid encoders in half precision too,
        main.py:111-113), else None (the float32 tables as they are)."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None

    @property
    def amb_levels(self) -> int:
        return self.amb_grid_levels or self.grid_levels

    @property
    def amb_ch(self) -> int:
        return self.amb_grid_ch or self.grid_ch

    @property
    def amb_base(self) -> int:
        return self.amb_grid_base or self.grid_base

    # the specs are built once per config: the frame reads them on every
    # grid encode
    @functools.cached_property
    def grid_spec(self) -> GridSpec:
        return GridSpec.create(
            input_dim=3, num_levels=self.grid_levels, level_dim=self.grid_ch,
            base_resolution=self.grid_base, log2_hashmap_size=16,
            desired_resolution=2048 * self.bound)

    @functools.cached_property
    def ambient_spec(self) -> GridSpec:
        return GridSpec.create(
            input_dim=self.ambient_dim, num_levels=self.amb_levels,
            level_dim=self.amb_ch, base_resolution=self.amb_base,
            log2_hashmap_size=16, desired_resolution=2048)

    @functools.cached_property
    def torso_spec(self) -> GridSpec:
        return GridSpec.create(
            input_dim=2, num_levels=self.amb_levels, level_dim=self.amb_ch,
            base_resolution=self.amb_base, log2_hashmap_size=16,
            desired_resolution=2048)

    @property
    def eye_dim(self) -> int:
        return 1 if self.exp_eye else 0

    @staticmethod
    def from_options(opt) -> "NetworkConfig":
        return NetworkConfig(
            audio_in_dim=opt.audio_in_dim, att=opt.att, emb=opt.emb, bound=opt.bound,
            exp_eye=opt.exp_eye, ind_dim=opt.ind_dim, ind_num=opt.ind_num,
            ind_dim_torso=opt.ind_dim_torso, torso=opt.torso,
            torso_shrink=opt.torso_shrink, train_camera=opt.train_camera,
            ambient_dim=opt.amb_dim,
            compute_dtype="bfloat16" if opt.fp16 else "float32",
            grid_levels=opt.grid_levels, grid_ch=opt.grid_ch, grid_base=opt.grid_base,
            amb_grid_levels=opt.amb_grid_levels, amb_grid_ch=opt.amb_grid_ch,
            amb_grid_base=opt.amb_grid_base, arch=opt.arch,
            **({"audio_dim": ERNERF_AUDIO_DIM} if opt.arch == "ernerf" else {}))


def param_groups(cfg: NetworkConfig) -> dict:
    """Learning-rate group of each top-level parameter name (reference
    network.py:329-362): 'grid' -> opt.lr, 'net' -> opt.lr_net, 'att' ->
    5 * lr_net, 'camera' -> 1e-5, 'frozen' -> not trained (the torso stage
    freezes the head, main.py:142-157). Unlisted names train as 'net'."""
    if cfg.torso:
        groups = {"torso_encoder": "grid", "torso_net": "net", "torso_deform_net": "net"}
        if cfg.ind_dim_torso > 0:
            groups["individual_codes_torso"] = "net"
        for k in ("audio_net", "audio_att_net", "encoder", "encoder_ambient",
                  "ambient_net", "sigma_net", "color_net", "individual_codes",
                  "embedding", "camera_dR", "camera_dT"):
            groups[k] = "frozen"
        return groups
    groups = {"audio_net": "net", "encoder": "grid", "encoder_ambient": "grid",
              "ambient_net": "net", "sigma_net": "net", "color_net": "net"}
    if cfg.att > 0:
        groups["audio_att_net"] = "att"
    if cfg.emb:
        groups["embedding"] = "grid"
    if cfg.ind_dim > 0:
        groups["individual_codes"] = "net"
    if cfg.train_camera:
        groups["camera_dR"] = "camera"
        groups["camera_dT"] = "camera"
    return groups


def _grid_table(spec: GridSpec, generator) -> nn.Parameter:
    """U(-1e-4, 1e-4) as the reference grid.py:138-140."""
    return nn.Parameter(torch.empty(spec.n_embeddings, spec.level_dim)
                        .uniform_(-1e-4, 1e-4, generator=generator))


def _codes(n: int, dim: int, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(n, dim, generator=generator) * 0.1)


class NeRFNetwork(nn.Module):
    """The field's parameters and apply functions.

    Args:
      cfg: the architecture.
      device: where the parameters live; "cuda" by default, which raises
        without a card.
      generator: CPU ``torch.Generator`` for the initial draw (the default
        generator if None).
    """

    # the pose the torso takes: the batch's 6 numbers (ER-NeRF's field takes
    # the 4x4 matrix, ``network_triplane.py``)
    torso_pose = "pose6"

    def __init__(self, cfg: NetworkConfig, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        g = generator
        sh_dim = 16  # SH degree 4
        self.audio_net = AudioNet(cfg.audio_in_dim, cfg.audio_dim, generator=g)
        self.encoder = _grid_table(cfg.grid_spec, g)
        self.encoder_ambient = _grid_table(cfg.ambient_spec, g)
        self.ambient_net = MLP(cfg.grid_spec.output_dim + cfg.audio_dim, cfg.ambient_dim,
                               cfg.hidden_dim_ambient, cfg.num_layers_ambient, g)
        self.sigma_net = MLP(
            cfg.grid_spec.output_dim + cfg.ambient_spec.output_dim + cfg.eye_dim,
            1 + cfg.geo_feat_dim, cfg.hidden_dim, cfg.num_layers, g)
        self.color_net = MLP(sh_dim + cfg.geo_feat_dim + cfg.ind_dim, 3,
                             cfg.hidden_dim_color, cfg.num_layers_color, g)
        self.audio_att_net = AudioAttNet(cfg.audio_dim, generator=g) if cfg.att > 0 else None
        self.embedding = (nn.Parameter(torch.randn(cfg.audio_in_dim, cfg.audio_in_dim,
                                                   generator=g))
                          if cfg.emb else None)
        self.individual_codes = _codes(cfg.ind_num, cfg.ind_dim, g) if cfg.ind_dim > 0 else None
        if cfg.torso:
            deform_in = freq_output_dim(2, 10)  # 42
            pose_in = freq_output_dim(6, 4)  # 54
            self.torso_deform_net = MLP(deform_in + pose_in + cfg.ind_dim_torso, 2, 64, 3, g)
            self.torso_encoder = _grid_table(cfg.torso_spec, g)
            self.torso_net = MLP(cfg.torso_spec.output_dim + deform_in + pose_in
                                 + cfg.ind_dim_torso, 4, 32, 3, g)
            self.individual_codes_torso = (_codes(cfg.ind_num, cfg.ind_dim_torso, g)
                                           if cfg.ind_dim_torso > 0 else None)
        if cfg.train_camera:
            self.camera_dR = nn.Parameter(torch.zeros(cfg.ind_num, 3))
            self.camera_dT = nn.Parameter(torch.zeros(cfg.ind_num, 3))
        # name -> ((storage, version), bf16 copy, its packed copy or None)
        self._table_copies = {}
        self.to(device)

    @property
    def ambient_out_dim(self) -> int:
        """The width of the per-sample ambient ``field_forward`` returns."""
        return self.cfg.ambient_dim

    def _copies(self, name: str) -> list:
        p = getattr(self, name)
        key = (p.data_ptr(), p._version)
        hit = self._table_copies.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = [key, p.detach().to(torch.bfloat16), None]
            self._table_copies[name] = hit
        return hit

    def table_copy(self, name: str) -> torch.Tensor:
        """The bf16 copy of grid table ``name``, made again only when the
        parameter's storage or version (bumped by every in-place update:
        optimizer steps, loads, the EMA swap) has changed."""
        return self._copies(name)[1]

    def packed_copy(self, name: str, spec) -> torch.Tensor:
        """``ops.pack_table`` of ``table_copy(name)`` (what kernel A-bf16
        reads), kept as long as that copy is."""
        hit = self._copies(name)
        if hit[2] is None:
            hit[2] = pack_table(hit[1], spec)
        return hit[2]

    def _encode(self, x, name: str, spec, bound: float):
        """Grid encode of x through table ``name`` under the policy: float32
        as it is; bf16 through the master table (cast in the encode) when a
        gradient reaches the table, else through its cached copy."""
        table = getattr(self, name)
        if self.cfg.table_dtype is None:
            return grid_encode(x, table, spec, bound)
        if torch.is_grad_enabled() and table.requires_grad:
            return grid_encode(x, table, spec, bound, table_dtype=torch.bfloat16)
        packed = self.packed_copy(name, spec) if x.device.type == "cuda" else None
        return grid_encode(x, self.table_copy(name), spec, bound, packed=packed)

    def encode_audio(self, a: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """[seq, audio_in_dim, 16] -> [1, audio_dim] (or [seq, audio_dim]
        without attention); None passes through."""
        if a is None:
            return None
        if self.cfg.emb:
            # label mode: a is [seq, 16] int -> [seq, audio_in_dim, 16]
            a = self.embedding[a].permute(0, 2, 1)
        enc = self.audio_net(a)
        if self.audio_att_net is not None:
            enc = self.audio_att_net(enc[None])
        return enc

    def spatial_and_ambient(self, x, enc_a):
        """Shared trunk: (enc_x, enc_w, ambient) for positions x [..., 3]."""
        cfg, dt = self.cfg, self.cfg.dtype
        enc_x = self._encode(x, "encoder", cfg.grid_spec, cfg.bound)
        if enc_a is None:
            ambient = x.new_zeros((*x.shape[:-1], cfg.ambient_dim))
        else:
            a = enc_a.expand(*x.shape[:-1], enc_a.shape[-1])
            h = torch.cat([enc_x.to(dt), a.to(dt)], dim=-1)
            ambient = torch.tanh(self.ambient_net(h, dt).float())
        enc_w = self._encode(ambient, "encoder_ambient", cfg.ambient_spec, 1.0)
        return enc_x, enc_w, ambient

    def _sigma_head(self, enc_x, enc_w, e, batch):
        """(sigma [...], geo_feat [..., geo_feat_dim]) from the encodes."""
        dt = self.cfg.dtype
        parts = [enc_x.to(dt), enc_w.to(dt)]
        if e is not None:
            parts.append(e.reshape(-1)[-1].expand(*batch, 1).to(dt))
        h = self.sigma_net(torch.cat(parts, dim=-1), dt)
        return trunc_exp(h[..., 0]), h[..., 1:]

    def field_forward(self, x, d, enc_a, c=None, e=None):
        """Full field query (reference network.py:222-283).

        Args:
          x: [..., 3] positions in [-bound, bound]; d: [..., 3] unit dirs.
          enc_a: [1, audio_dim] or None; c: [ind_dim] individual code or
            None; e: eye tensor or None (its last element is the scalar).

        Returns (sigma [...], color [..., 3], ambient [..., amb_dim]).
        """
        batch, dt = x.shape[:-1], self.cfg.dtype
        enc_x, enc_w, ambient = self.spatial_and_ambient(x, enc_a)
        sigma, geo_feat = self._sigma_head(enc_x, enc_w, e, batch)
        parts = [sh_encode(d, degree=4).to(dt), geo_feat]
        if c is not None:
            parts.append(c.expand(*batch, c.shape[-1]).to(dt))
        color = torch.sigmoid(self.color_net(torch.cat(parts, dim=-1), dt).float())
        return sigma, color, ambient

    def field_density(self, x, enc_a, e=None):
        """Density-only query for grid maintenance (reference
        network.py:286-325): {"sigma": [...], "geo_feat": [..., 64]}."""
        enc_x, enc_w, _ = self.spatial_and_ambient(x, enc_a)
        sigma, geo_feat = self._sigma_head(enc_x, enc_w, e, x.shape[:-1])
        return {"sigma": sigma, "geo_feat": geo_feat}

    def forward_torso(self, x, pose6, c=None):
        """2-D neural torso layer (reference network.py:188-219):
        ``torso_deform``, ``torso_encode`` and ``torso_head`` in turn.

        Args:
          x: [..., 2] pixel coords in [-1, 1]; pose6: [1, 6]; c:
            [ind_dim_torso] torso code or None.

        Returns (alpha [..., 1], color [..., 3], dx [..., 2]).
        """
        x, h, dx = self.torso_deform(x, pose6, c)
        return (*self.torso_head(self.torso_encode(x, dx), h), dx)

    def torso_deform(self, x, pose6, c=None):
        """The torso layer's first stage: the shrunk coords, their features
        h (the coords' and the pose's frequency encodings and the code) and
        the deform net's offsets dx."""
        cfg = self.cfg
        batch = x.shape[:-1]
        x = x * cfg.torso_shrink
        enc_pose = freq_encode(pose6, 4)  # [1, 54]
        parts = [freq_encode(x, 10), enc_pose[0].expand(*batch, enc_pose.shape[-1])]
        if c is not None:
            parts.append(c.expand(*batch, c.shape[-1]))
        h = torch.cat(parts, dim=-1)
        dx = self.torso_deform_net(h.to(cfg.dtype), cfg.dtype).float()
        return x, h, dx

    def torso_encode(self, x, dx):
        """The torso grid's encode at the deformed coords: [..., L*C],
        float32, or bf16 under the bf16 policy."""
        xp = torch.clamp(x + dx, -1.0, 1.0)
        return self._encode(xp, "torso_encoder", self.cfg.torso_spec, 1.0)

    def torso_head(self, enc_t, h):
        """The torso MLP on the encode and the features: (alpha, color)."""
        dt = self.cfg.dtype
        h2 = self.torso_net(torch.cat([enc_t.to(dt), h.to(dt)], dim=-1), dt).float()
        return torch.sigmoid(h2[..., :1]), torch.sigmoid(h2[..., 1:])
