"""Occupancy-grid ray marching and volume compositing.

Counterpart of ``radnerf_tpu/ops/marching.py``:

- ``MarchConfig``, ``build_sigma_bytes`` and ``dequant_sigma`` as there;
- ``march_rays``: the wrapper of kernel B (``csrc/march_rays.cu``), with
  the plain twin ``march_rays_plain``. It walks the affine orbit
  ``t_k = t0 + (k0 + k) * dt`` (``dt_min == dt_max``, the shipped config)
  through the sigma-byte field, restricted to a per-ray ``t_window``, with
  the transmittance-bound cull, and keeps the first S occupied points.
  Training perturbs each ray's orbit origin with ``noises``.
- ``composite_rays``: the wrapper of kernel C (``csrc/composite_rays.cu``),
  with the plain twin ``composite_rays_plain``: front-to-back alpha
  compositing with early termination at ``T_thresh``. Its gradient is kernel
  C' (``csrc/composite_rays_backward.cu``, ``composite_rays_backward``).

The non-affine orbit and ``cascade > 1`` are not ported and raise.

The twins run their running sums and products as explicit loops over the
lattice axis in float32, in the order the kernels run them: PyTorch's CPU
``cumsum``/``cumprod`` accumulate float32 in double, which would put a
sample on the other side of the cull threshold now and then.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ._kernels import KERNELS, refuse_grad, require_cuda_tensors
from .morton import morton3d

SQRT3 = 1.7320508075688772
# share of the lower-bound optical depth sigma_lo * dt the cull counts
# (kCullSafety in csrc/march_rays.cu)
CULL_SAFETY = 0.5


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Static marching configuration (see ``radnerf_tpu`` ``MarchConfig``).

    ``march_iters`` (K, the orbit length) and ``sample_slots`` (S, the width
    of the emitted lattice) truncate the march and are honoured exactly.
    """

    bound: float = 1.0
    cascade: int = 1
    grid_size: int = 128
    max_steps: int = 16
    dt_gamma: float = 0.0
    march_iters: int | None = None
    sample_slots: int | None = None

    @property
    def dt_max(self) -> float:
        return 2.0 * SQRT3 * (1 << (self.cascade - 1)) / self.grid_size

    @property
    def dt_min(self) -> float:
        return min(self.dt_max, 2.0 * SQRT3 / self.max_steps)

    @property
    def n_march_iters(self) -> int:
        if self.march_iters is not None:
            return self.march_iters
        return int(math.ceil(2.0 * SQRT3 * self.bound / self.dt_min)) + 1

    @property
    def n_sample_slots(self) -> int:
        if self.sample_slots is None:
            return self.max_steps
        return min(self.max_steps, self.sample_slots)

    @property
    def affine(self) -> bool:
        return self.dt_gamma == 0.0 or self.dt_min == self.dt_max


def build_sigma_bytes(density_grid: torch.Tensor, thresh) -> torch.Tensor:
    """One byte per Morton cell: bit 7 = occupied (grid > thresh), bits 0-6 =
    clip(floor(4*log2(sigma)) + 40, 1, 127); 0 for empty cells."""
    grid = density_grid.reshape(-1)
    occ = grid > thresh
    q = torch.clamp(torch.floor(4.0 * torch.log2(grid.clamp_min(1e-30))) + 40.0,
                    1.0, 127.0).to(torch.uint8)
    return torch.where(occ, q | 128, torch.zeros_like(q))


def dequant_sigma(q: torch.Tensor) -> torch.Tensor:
    """Lower-bound dequantisation of the 7-bit code (0 -> 0)."""
    s = torch.exp2((q.float() - 40.0) * 0.25)
    return torch.where(q > 0, s, torch.zeros_like(s))


def _check_march(cfg: MarchConfig):
    if not cfg.affine:
        raise NotImplementedError("only the affine orbit (dt_min == dt_max) is ported")
    if cfg.cascade != 1:
        raise NotImplementedError("only cascade == 1 is ported")


def _f32(v: float) -> float:
    """A Python float holding exactly the float32 value the JAX path uses for
    the weakly-typed constant ``v``."""
    return float(np.float32(v))


def march_rays_plain(rays_o, rays_d, nears, fars, sigma_bytes, cfg: MarchConfig,
                     t_window, cull_T: float = 0.0, noises=None):
    """Plain PyTorch marcher; the arguments and results of ``march_rays``."""
    _check_march(cfg)
    N, dev = rays_o.shape[0], rays_o.device
    S, K, H = cfg.n_sample_slots, cfg.n_march_iters, cfg.grid_size
    dt = _f32(cfg.dt_min)
    t0 = nears
    if noises is not None:
        # on the affine orbit the clamped step _clamp_dt(nears) is exactly dt
        t0 = t0 + torch.full_like(t0, dt) * noises
    t_lo, t_hi = t_window
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    k0 = torch.floor((t_lo - t0) / torch.full_like(t0, dt))
    k0 = torch.where(k0 < 0.0, torch.zeros_like(k0), k0)
    t_end = torch.minimum(fars, t_hi)
    k = k0[:, None] + torch.arange(K, dtype=torch.float32, device=dev)[None, :]
    ts = t0[:, None] + k * dt  # [N, K]
    xyz = torch.clamp(rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :],
                      -cfg.bound, cfg.bound)
    mip_bound = _f32(min(1.0, cfg.bound))
    cell = torch.clamp(torch.floor(0.5 * (xyz / mip_bound + 1.0) * H), 0.0, H - 1)
    # the int clamp only matters for NaN positions, which ts < t_end masks
    byte = sigma_bytes[morton3d(cell.to(torch.int64).clamp(0, H - 1))]
    occ = ((byte & 128) > 0) & (ts < t_end[:, None])
    if cull_T > 0.0:
        est = torch.where(occ, dequant_sigma(byte & 127) * dt * CULL_SAFETY,
                          torch.zeros_like(ts))
        log_cull = _f32(-math.log(cull_T))
        # the JAX path tests cumsum(est) - est; the running sum is float32,
        # added in orbit order
        incl = torch.zeros_like(t0)
        keep = torch.empty_like(occ)
        for j in range(K):
            incl = incl + est[:, j]
            keep[:, j] = (incl - est[:, j]) <= log_cull
        occ = occ & keep

    rank = torch.cumsum(occ.to(torch.int32), dim=1)
    slot = torch.where(occ & (rank <= S), rank - 1, torch.full_like(rank, S))
    # first S occupied points into slots 0..S-1; the rest go to column S,
    # which is dropped
    slot = slot.long()
    k_sel = torch.zeros((N, S + 1), dtype=torch.float32, device=dev)
    k_sel.scatter_(1, slot, k)
    valid = torch.zeros((N, S + 1), dtype=torch.bool, device=dev)
    valid.scatter_(1, slot, torch.ones_like(occ))
    k_sel, valid = k_sel[:, :S], valid[:, :S]
    t_out = t0[:, None] + k_sel * dt
    xyz_out = torch.clamp(rays_o[:, None, :] + t_out[..., None] * rays_d[:, None, :],
                          -cfg.bound, cfg.bound)
    zero = torch.zeros_like(t_out)
    return {
        "t": torch.where(valid, t_out, zero),
        "dt": torch.where(valid, torch.full_like(t_out, dt), zero),
        "valid": valid,
        "xyz": torch.where(valid[..., None], xyz_out, torch.zeros_like(xyz_out)),
        "count": occ.sum(dim=1, dtype=torch.int32),
    }


def march_rays(rays_o, rays_d, nears, fars, sigma_bytes, cfg: MarchConfig,
               t_window, cull_T: float = 0.0, noises=None):
    """Fixed-lattice marcher: kernel B on CUDA tensors, the plain twin on CPU
    tensors.

    Args:
      rays_o, rays_d: [N, 3] float32 (unit directions).
      nears, fars: [N] from ``near_far_from_aabb``.
      sigma_bytes: uint8 [H^3] from ``build_sigma_bytes`` (Morton order).
      t_window: ([N] t_lo, [N] t_hi): march only this interval (the
        renderer's ``march_window``); the orbit origin stays at ``nears`` so
        samples stay on the lattice.
      cull_T: drop occupied points once the running optical-depth bound
        ``sum(CULL_SAFETY * sigma_lo * dt)`` before them exceeds
        ``-ln(cull_T)`` (0 disables).
      noises: optional [N] float32 in [0, 1): the orbit origin moves to
        ``nears + dt * noises`` (training's perturbation); the window's
        first step is taken from the moved origin.

    Returns dict: t, dt [N, S] (0 where invalid), valid [N, S] bool,
      xyz [N, S, 3] (0 where invalid), count [N] int32 occupied points per
      ray before the S truncation (its max is the ``max_count`` telemetry).
    """
    if rays_o.device.type == "cpu":
        return march_rays_plain(rays_o, rays_d, nears, fars, sigma_bytes, cfg,
                                t_window, cull_T, noises)
    _check_march(cfg)
    N = rays_o.shape[0]
    S, K, H = cfg.n_sample_slots, cfg.n_march_iters, cfg.grid_size
    t_lo, t_hi = t_window
    refuse_grad("kernel B", rays_o=rays_o, rays_d=rays_d)
    ins = [v.contiguous() for v in (rays_o, rays_d, nears, fars, t_lo, t_hi)]
    if noises is not None:
        ins.append(noises.contiguous())
    shapes = [(N, 3), (N, 3)] + [(N,)] * (len(ins) - 2)
    if any(v.dtype != torch.float32 or v.shape != shape
           for v, shape in zip(ins, shapes)) \
            or sigma_bytes.dtype != torch.uint8 or sigma_bytes.numel() != H**3:
        raise ValueError("kernel B takes float32 rays [N, 3], intervals and noises "
                         "[N] and uint8 [H^3] bytes")
    require_cuda_tensors(*ins, sigma_bytes)
    dev = rays_o.device
    t = torch.empty((N, S), dtype=torch.float32, device=dev)
    dt = torch.empty_like(t)
    valid = torch.empty((N, S), dtype=torch.bool, device=dev)
    xyz = torch.empty((N, S, 3), dtype=torch.float32, device=dev)
    count = torch.empty((N,), dtype=torch.int32, device=dev)
    if N > 0:
        KERNELS["march_rays"].launch(
            "march_rays_fwd", dev, *[v.data_ptr() for v in ins[:6]],
            ins[6].data_ptr() if noises is not None else None, sigma_bytes.data_ptr(),
            t.data_ptr(), dt.data_ptr(), valid.data_ptr(), xyz.data_ptr(),
            count.data_ptr(), N, K, S, H, _f32(cfg.bound), _f32(min(1.0, cfg.bound)),
            _f32(cfg.dt_min), int(cull_T > 0.0),
            _f32(-math.log(cull_T)) if cull_T > 0.0 else 0.0)
    return {"t": t, "dt": dt, "valid": valid, "xyz": xyz, "count": count}


def composite_rays_plain(sigmas, rgbs, dts, ts, valid, ambient,
                         T_thresh: float = 1e-4):
    """Plain PyTorch compositor; the arguments and results of
    ``composite_rays``."""
    N, S = sigmas.shape
    zero = torch.zeros_like(sigmas[:, 0])
    T = torch.ones_like(zero)  # transmittance before the step
    processed = torch.ones_like(valid[:, 0])
    weights_sum, depth, amb = zero, zero, zero
    image = torch.zeros_like(rgbs[:, 0])
    for s in range(S):
        sig = torch.where(valid[:, s], sigmas[:, s], zero)
        alpha = 1.0 - torch.exp(-sig * dts[:, s])
        w = torch.where(processed, alpha * T, zero)
        weights_sum = weights_sum + w
        depth = depth + w * (ts[:, s] + dts[:, s])
        image = image + w[:, None] * rgbs[:, s]
        amb = amb + torch.where(processed & valid[:, s], ambient[:, s], zero)
        T = T * (1.0 - alpha)
        processed = processed & (T >= _f32(T_thresh))
    return {"image": image, "depth": depth, "weights_sum": weights_sum,
            "ambient_sum": amb}


def _composite_kernel(sigmas, rgbs, dts, ts, valid, ambient, T_thresh):
    """Kernel C on checked, contiguous CUDA inputs."""
    N, S = sigmas.shape
    dev = sigmas.device
    image = torch.empty((N, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((N,), dtype=torch.float32, device=dev)
    weights_sum = torch.empty_like(depth)
    ambient_sum = torch.empty_like(depth)
    if N > 0:
        KERNELS["composite_rays"].launch(
            "composite_rays_fwd", dev, sigmas.data_ptr(), rgbs.data_ptr(), dts.data_ptr(),
            ts.data_ptr(), valid.data_ptr(), ambient.data_ptr(),
            image.data_ptr(), depth.data_ptr(), weights_sum.data_ptr(),
            ambient_sum.data_ptr(), N, S, _f32(T_thresh))
    return image, depth, weights_sum, ambient_sum


def _check_composite(sigmas, rgbs, dts, ts, valid, ambient):
    N, S = sigmas.shape
    ins = [sigmas, rgbs, dts, ts, ambient]
    shapes = [(N, S), (N, S, 3), (N, S), (N, S), (N, S)]
    if any(v.dtype != torch.float32 or v.shape != shape
           for v, shape in zip(ins, shapes)) \
            or valid.dtype != torch.bool or valid.shape != (N, S):
        raise ValueError("kernel C takes float32 [N, S] samples, [N, S, 3] rgbs "
                         "and a bool mask")
    ins = [v.contiguous() for v in (*ins, valid)]
    require_cuda_tensors(*ins)
    return ins


def composite_rays_backward_plain(sigmas, rgbs, dts, ts, valid, ambient, grads,
                                  T_thresh: float = 1e-4):
    """Plain version of ``composite_rays_backward``: autograd through
    ``composite_rays_plain``."""
    sig, rgb, amb = (v.detach().requires_grad_(True) for v in (sigmas, rgbs, ambient))
    with torch.enable_grad():
        out = composite_rays_plain(sig, rgb, dts, ts, valid, amb, T_thresh)
        keys = ("image", "depth", "weights_sum", "ambient_sum")
        return torch.autograd.grad([out[k] for k in keys], [sig, rgb, amb],
                                   [grads[k] for k in keys])


def composite_rays_backward(sigmas, rgbs, dts, ts, valid, ambient, grads, outputs,
                            T_thresh: float = 1e-4):
    """Gradients of ``composite_rays`` (the semantics of JAX's autodiff of
    ``composite_rays``): ``grads`` holds d image [N, 3], d depth, d
    weights_sum and d ambient_sum [N]; ``outputs`` the forward's image,
    depth and weights_sum. Returns (d sigmas [N, S], d rgbs [N, S, 3],
    d ambient [N, S]); the processed mask carries no gradient and invalid
    steps get zero. Kernel C' on CUDA tensors, the plain version (which does
    not read ``outputs``) on CPU tensors."""
    if sigmas.device.type == "cpu":
        return composite_rays_backward_plain(sigmas, rgbs, dts, ts, valid, ambient, grads,
                                             T_thresh)
    sig, rgb, dt, t, _, ok = _check_composite(sigmas, rgbs, dts, ts, valid, ambient)
    N, S = sig.shape
    keys = ("image", "depth", "weights_sum", "ambient_sum")
    g = [grads[k].contiguous() for k in keys]
    o = [outputs[k].contiguous() for k in keys[:3]]
    want = [(N, 3), (N,), (N,), (N,), (N, 3), (N,), (N,)]
    if any(v.dtype != torch.float32 or v.shape != w for v, w in zip(g + o, want)):
        raise ValueError("kernel C' takes float32 image [N, 3] and [N] gradients "
                         "and outputs")
    require_cuda_tensors(sig, *g, *o)
    g_sig = torch.empty_like(sig)
    g_rgb = torch.empty_like(rgb)
    g_amb = torch.empty_like(sig)
    if N > 0:
        KERNELS["composite_rays_backward"].launch(
            "composite_rays_bwd", sig.device, sig.data_ptr(), rgb.data_ptr(), dt.data_ptr(),
            t.data_ptr(), ok.data_ptr(), *[v.data_ptr() for v in o],
            *[v.data_ptr() for v in g], g_sig.data_ptr(), g_rgb.data_ptr(),
            g_amb.data_ptr(), N, S, _f32(T_thresh))
    return g_sig, g_rgb, g_amb


class _CompositeRays(torch.autograd.Function):
    """Kernel C forward, kernel C' backward."""

    @staticmethod
    def forward(ctx, sigmas, rgbs, dts, ts, valid, ambient, T_thresh):
        outs = _composite_kernel(sigmas, rgbs, dts, ts, valid, ambient, T_thresh)
        ctx.save_for_backward(sigmas, rgbs, dts, ts, valid, ambient, *outs[:3])
        ctx.T_thresh = T_thresh
        return outs

    @staticmethod
    def backward(ctx, g_image, g_depth, g_ws, g_amb):
        sigmas, rgbs, dts, ts, valid, ambient, image, depth, ws = ctx.saved_tensors
        grads = {"image": g_image, "depth": g_depth, "weights_sum": g_ws,
                 "ambient_sum": g_amb}
        grads = {k: torch.zeros_like(v) if grads[k] is None else grads[k]
                 for k, v in (("image", image), ("depth", depth),
                              ("weights_sum", ws), ("ambient_sum", ws))}
        g_sig, g_rgb, g_a = composite_rays_backward(
            sigmas, rgbs, dts, ts, valid, ambient, grads,
            {"image": image, "depth": depth, "weights_sum": ws}, ctx.T_thresh)
        need = ctx.needs_input_grad
        return (g_sig if need[0] else None, g_rgb if need[1] else None, None, None, None,
                g_a if need[5] else None, None)


def composite_rays(sigmas, rgbs, dts, ts, valid, ambient,
                   T_thresh: float = 1e-4):
    """Front-to-back compositing of a [N, S] sample lattice: kernel C on CUDA
    tensors, the plain twin on CPU tensors.

    ``alpha = 1 - exp(-sigma*dt)``, ``w = alpha * T`` with T the
    transmittance before the step; a step is processed iff it is the first
    or T after the previous step is >= T_thresh (the crossing step is
    included). depth accumulates ``w * (t + dt)``; ``ambient_sum`` is the
    unweighted sum of ``ambient`` over processed valid steps. Invalid steps
    contribute nothing.

    On CUDA tensors, when autograd wants a gradient for sigmas, rgbs or
    ambient, the call goes through a ``torch.autograd.Function`` whose
    backward is kernel C'; dts and ts take no gradient (a request raises).

    Returns dict: image [N, 3] (premultiplied, no background), depth [N],
      weights_sum [N], ambient_sum [N].
    """
    if sigmas.device.type == "cpu":
        return composite_rays_plain(sigmas, rgbs, dts, ts, valid, ambient, T_thresh)
    args = _check_composite(sigmas, rgbs, dts, ts, valid, ambient)
    refuse_grad("kernel C", dts=dts, ts=ts)
    sig, rgb, dt, t, amb, ok = args
    if torch.is_grad_enabled() and any(v.requires_grad for v in (sig, rgb, amb)):
        outs = _CompositeRays.apply(sig, rgb, dt, t, ok, amb, T_thresh)
    else:
        outs = _composite_kernel(sig, rgb, dt, t, ok, amb, T_thresh)
    return dict(zip(("image", "depth", "weights_sum", "ambient_sum"), outs))
