"""The audio-conditioned NeRF field (counterpart of
``radnerf_tpu/models/network.py``).

``NeRFNetwork`` holds every parameter of the JAX ``init_params`` pytree under
the same names: ``audio_net``, ``audio_att_net``, ``encoder``,
``encoder_ambient``, ``ambient_net``, ``sigma_net``, ``color_net``,
``individual_codes`` and, with the torso, ``torso_deform_net``,
``torso_encoder``, ``torso_net``, ``individual_codes_torso``. The three grid
encodes of a frame go through kernel A (``ops.grid_encode``); the MLPs,
encoders and activations around them are plain PyTorch.

Compute is float32. The bf16 table/lerp policy of the JAX package is not
ported yet: ``compute_dtype="bfloat16"`` raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import GridSpec, freq_encode, freq_output_dim, grid_encode, sh_encode, trunc_exp
from .audio import AudioAttNet, AudioNet
from .modules import MLP


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Static architecture description (the JAX ``NetworkConfig``)."""

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

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r}: the port computes in float32 "
                "only; the bf16 table/lerp policy is not ported yet")

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
        self.to(device)

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
        cfg = self.cfg
        enc_x = grid_encode(x, self.encoder, cfg.grid_spec, cfg.bound)
        if enc_a is None:
            ambient = x.new_zeros((*x.shape[:-1], cfg.ambient_dim))
        else:
            a = enc_a.expand(*x.shape[:-1], enc_a.shape[-1])
            ambient = torch.tanh(self.ambient_net(torch.cat([enc_x, a], dim=-1)))
        enc_w = grid_encode(ambient, self.encoder_ambient, cfg.ambient_spec, 1.0)
        return enc_x, enc_w, ambient

    def field_forward(self, x, d, enc_a, c=None, e=None):
        """Full field query (reference network.py:222-283).

        Args:
          x: [..., 3] positions in [-bound, bound]; d: [..., 3] unit dirs.
          enc_a: [1, audio_dim] or None; c: [ind_dim] individual code or
            None; e: eye tensor or None (its last element is the scalar).

        Returns (sigma [...], color [..., 3], ambient [..., amb_dim]).
        """
        batch = x.shape[:-1]
        enc_x, enc_w, ambient = self.spatial_and_ambient(x, enc_a)
        parts = [enc_x, enc_w]
        if e is not None:
            parts.append(e.reshape(-1)[-1].expand(*batch, 1))
        h = self.sigma_net(torch.cat(parts, dim=-1))
        sigma = trunc_exp(h[..., 0])
        parts = [sh_encode(d, degree=4), h[..., 1:]]
        if c is not None:
            parts.append(c.expand(*batch, c.shape[-1]))
        color = torch.sigmoid(self.color_net(torch.cat(parts, dim=-1)))
        return sigma, color, ambient

    def forward_torso(self, x, pose6, c=None):
        """2-D neural torso layer (reference network.py:188-219).

        Args:
          x: [..., 2] pixel coords in [-1, 1]; pose6: [1, 6]; c:
            [ind_dim_torso] torso code or None.

        Returns (alpha [..., 1], color [..., 3], dx [..., 2]).
        """
        cfg = self.cfg
        batch = x.shape[:-1]
        x = x * cfg.torso_shrink
        enc_pose = freq_encode(pose6, 4)  # [1, 54]
        parts = [freq_encode(x, 10), enc_pose[0].expand(*batch, enc_pose.shape[-1])]
        if c is not None:
            parts.append(c.expand(*batch, c.shape[-1]))
        h = torch.cat(parts, dim=-1)
        dx = self.torso_deform_net(h)
        xp = torch.clamp(x + dx, -1.0, 1.0)
        enc_t = grid_encode(xp, self.torso_encoder, cfg.torso_spec, 1.0)
        h2 = self.torso_net(torch.cat([enc_t, h], dim=-1))
        return torch.sigmoid(h2[..., :1]), torch.sigmoid(h2[..., 1:]), dx
