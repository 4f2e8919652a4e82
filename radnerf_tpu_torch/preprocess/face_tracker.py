"""3DMM face tracker on the card (preprocessing task 8; counterpart of
``radnerf_tpu/preprocess/face_tracker.py``; reference
data_utils/face_tracking/face_tracker.py).

A BFM-2009 3DMM fit: a focal sweep (600..1400 step 100) on every 40th
frame, a coarse per-frame pose/expression fit over all frames with temporal
laplacian smoothing, then the photometric refinement through the
differentiable renderer of ``render_3dmm`` (SH light and texture, then
frame-wise fine fitting in 64-frame windows). The parameterisation, losses
and schedules are JAX's: id [1, 100], exp [N, 79], euler [N, 3], trans
[N, 3] starting at z = -7; mean squared landmark error + 0.5 id^2 + 0.4
exp^2 (+ the laplacian); Adam (0.9, 0.999, 1e-8) with a fresh optimizer at
each of JAX's optax phases (the x0.2 decay at joint iteration 1500; stage
1's two phases at iteration 51, with two learning rates; every stage-2
window).

Every parameter lives on the device and each fit steps ``torch.optim.Adam``.
The focal sweep fits all candidates at once: the parameters carry a
leading candidate axis and the candidates' losses are summed, so each
candidate's gradient and Adam update are exactly its own, in one step for
all of them (JAX runs one fit per candidate).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class LandmarkBasis:
    """68-landmark morphable model: lm = mean + id_base @ id + exp_base @ exp.

    mean [68, 3]; id_base [68, 3, id_dim]; exp_base [68, 3, exp_dim] (numpy,
    or tensors after ``to(device)``), in the BFM convention of the reference.
    """

    mean: np.ndarray
    id_base: np.ndarray
    exp_base: np.ndarray

    @property
    def id_dim(self):
        return self.id_base.shape[-1]

    @property
    def exp_dim(self):
        return self.exp_base.shape[-1]

    def to(self, device) -> "LandmarkBasis":
        def f(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return LandmarkBasis(f(self.mean), f(self.id_base), f(self.exp_base))


def euler_rot(euler: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, 3, 3], the tracker's convention (process.py:276-298)."""
    th, ph, ps = euler[:, 0], euler[:, 1], euler[:, 2]
    one, zero = torch.ones_like(th), torch.zeros_like(th)
    rx = torch.stack([one, zero, zero,
                      zero, torch.cos(th), torch.sin(th),
                      zero, -torch.sin(th), torch.cos(th)], -1).reshape(-1, 3, 3)
    ry = torch.stack([torch.cos(ph), zero, -torch.sin(ph),
                      zero, one, zero,
                      torch.sin(ph), zero, torch.cos(ph)], -1).reshape(-1, 3, 3)
    rz = torch.stack([torch.cos(ps), -torch.sin(ps), zero,
                      torch.sin(ps), torch.cos(ps), zero,
                      zero, zero, one], -1).reshape(-1, 3, 3)
    return rx @ ry @ rz


def project(points: torch.Tensor, euler: torch.Tensor, trans: torch.Tensor,
            focal, cxy) -> torch.Tensor:
    """World landmarks [N, 68, 3] -> image coordinates [N, 68, 2]. ``focal``
    is a number or a tensor that broadcasts against [N, 68]."""
    rot = euler_rot(euler)
    cam = torch.einsum("nij,nkj->nki", rot, points) + trans[:, None, :]
    # jnp.maximum's gradient: split at a tie, as torch.maximum's
    z = torch.maximum(-cam[..., 2], cam.new_tensor(1e-6))  # camera looks down -z
    u = focal * cam[..., 0] / z + cxy[0]
    v = -focal * cam[..., 1] / z + cxy[1]
    return torch.stack([u, v], -1)


def landmarks_from_params(basis: LandmarkBasis, ids: torch.Tensor, exp: torch.Tensor):
    """[B, id_dim], [B, exp_dim] -> [B, 68, 3]."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=ids.device)

    return (t(basis.mean)[None] + torch.einsum("kdi,bi->bkd", t(basis.id_base), ids)
            + torch.einsum("kdi,bi->bkd", t(basis.exp_base), exp))


def _lan_loss(proj, lms):
    """Mean squared landmark distance over the last two axes but one:
    [..., N, 68, 2] -> [...]."""
    return ((proj - lms) ** 2).sum(-1).mean(dim=(-2, -1))


def _split_iters(n):
    return [min(n, 1500), max(0, n - 1500)]


LR = 0.1  # the landmark fits' Adam learning rate (face_tracker.py:64-101)


def _adam_steps(loss_fn, params: list, lr, iters: int):
    """``iters`` steps of a fresh Adam(lr) on ``params``, minimising the sum
    of ``loss_fn()`` (per-candidate losses); returns the last step's losses
    (before its update), or None without steps."""
    opt = torch.optim.Adam(params, lr=lr)
    loss = None
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.sum().backward()
        opt.step()
    return None if loss is None else loss.detach()


def _fit_batched(basis: LandmarkBasis, lms: torch.Tensor, focals, cxy, n_pose, n_joint,
                 smooth_weight=0.0):
    """``_fit`` for C focal candidates at once: parameters with a leading
    candidate axis ([C, 1, id], [C, N, exp], [C, N, 3], [C, N, 3]), the
    candidates' losses summed. Returns (params, losses [C] of the last
    step)."""
    dev = lms.device
    C, N = len(focals), lms.shape[0]
    basis = basis.to(dev)
    f = torch.tensor([float(v) for v in focals], dtype=torch.float32, device=dev)
    f = f.repeat_interleave(N)[:, None]  # [C * N, 1]
    trans = torch.zeros((C, N, 3), device=dev)
    trans[..., 2] = -7.0
    p = {"id": torch.zeros((C, 1, basis.id_dim), device=dev),
         "exp": torch.zeros((C, N, basis.exp_dim), device=dev),
         "euler": torch.zeros((C, N, 3), device=dev), "trans": trans}
    for v in p.values():
        v.requires_grad_(True)

    def lan():
        geo = landmarks_from_params(
            basis, p["id"].expand(C, N, basis.id_dim).reshape(C * N, -1),
            p["exp"].reshape(C * N, -1))
        proj = project(geo, p["euler"].reshape(C * N, 3), p["trans"].reshape(C * N, 3), f, cxy)
        return _lan_loss(proj.reshape(C, N, *proj.shape[1:]), lms)

    def full_loss():
        loss = lan()
        loss = loss + 0.5 * (p["id"] ** 2).mean(dim=(1, 2)) + 0.4 * (p["exp"] ** 2).mean(dim=(1, 2))
        if smooth_weight > 0 and N > 2:
            for k in ("euler", "trans", "exp"):
                lap = p[k][:, 1:-1] - 0.5 * (p[k][:, :-2] + p[k][:, 2:])
                loss = loss + smooth_weight * (lap**2).mean(dim=(1, 2))
        return loss

    # stage A: pose only (JAX masks the other gradients: those stay put)
    loss = _adam_steps(lan, [p["euler"], p["trans"]], LR, n_pose)
    # stage B: joint, decay x0.2 at 1500 (a fresh Adam per phase, as optax)
    for phase, iters in enumerate(_split_iters(n_joint)):
        last = _adam_steps(full_loss, list(p.values()), LR * (0.2**phase), iters)
        loss = loss if last is None else last
    return {k: v.detach() for k, v in p.items()}, loss


def _fit(basis, lms, focal, cxy, n_pose, n_joint, smooth_weight=0.0):
    """One fitting stage: pose-only Adam, then joint id/exp + pose Adam with
    the reference's regularisers and x0.2 decay at iteration 1500
    (face_tracker.py:64-101). Returns (params on lms's device, last loss)."""
    params, loss = _fit_batched(basis, lms, [focal], cxy, n_pose, n_joint, smooth_weight)
    return {k: v[0] for k, v in params.items()}, float(loss[0])


def track_landmarks(
    lms: np.ndarray,
    img_w: int,
    img_h: int,
    basis: LandmarkBasis,
    focal_candidates=range(600, 1500, 100),
    sel_stride: int = 40,
    focal_iters=(2000, 2500),
    coarse_iters=(1000, 2500),
    photometric_fn: Optional[Callable] = None,
    device="cuda",
) -> dict:
    """The tracking pipeline on 68-point landmark tracks [N, 68, 2], on
    ``device``: the focal sweep on every ``sel_stride``-th frame (all
    candidates in one batched fit; the first candidate of least loss wins,
    as JAX's loop picks), the coarse fit over all frames with temporal
    smoothing, then the optional photometric hook. Returns numpy {'focal':
    [1], 'euler': [N, 3], 'trans': [N, 3], 'id': [1, id_dim], 'exp': [N,
    exp_dim]}."""
    dev = resolve_device(device)
    lms = torch.as_tensor(np.asarray(lms, np.float32), device=dev)
    cxy = (img_w / 2.0, img_h / 2.0)

    sel = torch.arange(0, lms.shape[0], sel_stride, device=dev)
    focals = [float(f) for f in focal_candidates]
    _, losses = _fit_batched(basis, lms[sel], focals, cxy, n_pose=focal_iters[0],
                             n_joint=focal_iters[1])
    best = (None, np.inf)
    for focal, loss in zip(focals, losses.cpu().numpy()):
        if loss < best[1]:
            best = (focal, loss)
    focal = float(best[0])

    params, _ = _fit(basis, lms, focal, cxy, n_pose=coarse_iters[0], n_joint=coarse_iters[1],
                     smooth_weight=0.01)
    out = {"focal": np.asarray([focal], np.float32),
           **{k: params[k].cpu().numpy().astype(np.float32)
              for k in ("euler", "trans", "id", "exp")}}
    if photometric_fn is not None:
        out = photometric_fn(out)
    return out


def photometric_refine(
    track: dict,
    lms: np.ndarray,
    images: np.ndarray,
    mesh,
    lm_basis: LandmarkBasis,
    img_h: int,
    img_w: int,
    batch_size: int = 64,
    light_iters: int = 71,
    fine_iters: int = 50,
    device="cuda",
) -> dict:
    """Photometric texture + SH-lighting refinement (the reference's fine
    tracking stages, face_tracker.py:178-360) of the landmark fit in
    ``track``, on ``device``.

    Stage 1 "fitting light": on ~batch_size spread-out frames, a global
    texture code + per-frame 27-d SH light + id/exp/pose through the
    renderer; masked photometric L2 (util.py:cal_col_loss) + landmark +
    id/exp regularisers; Adam with tex + light at lr 0.1 and id/exp/pose at
    0.01, x0.2 after iteration 50 (a fresh optimizer), landmark weight 3 ->
    0.05 after iteration 50.

    Stage 2 "fine frame-wise fitting": consecutive batch_size-frame
    windows, a fresh Adam(0.005) each on exp/euler/trans/light; loss = 0.5
    col + lan (8 -> 1.5 after iteration 30) + 1e5 temporal laplacian on the
    rigid vertices (with the 5 already refined frames before the window) +
    exp^2.

    track: {'focal', 'euler', 'trans', 'id', 'exp'}; lms [N, 68, 2]; images
    [N, H, W, 3] RGB 0..255 (any numpy dtype; kept on the host, each
    window's frames go to the device as float32); mesh: render_3dmm
    .MeshBasis. Returns the refined dict + {'tex', 'light'}.
    """
    from .render_3dmm import Render3DMM, forward_geo, forward_tex

    dev = resolve_device(device)
    N = int(np.asarray(track["euler"]).shape[0])
    S = min(batch_size, N)
    focal = float(np.asarray(track["focal"]).reshape(-1)[0])
    cxy = (img_w / 2.0, img_h / 2.0)
    rigid = mesh.rigid_ids
    if rigid is None:
        rigid = np.arange(0, mesh.mean.shape[0], max(1, mesh.mean.shape[0] // 200))
    mesh = mesh.to(dev)
    lm_basis = lm_basis.to(dev)
    rigid = torch.as_tensor(np.asarray(rigid, np.int64), device=dev)
    renderer = Render3DMM(focal, img_h, img_w, mesh.tris)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    lms = t(lms)
    euler, trans, idp, exp = (t(track[k]) for k in ("euler", "trans", "id", "exp"))

    def frames(ids) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(images[ids])).to(dev).float()

    def rott(geo, eul, tr):
        return torch.einsum("nij,nkj->nki", euler_rot(eul), geo) + tr[:, None, :]

    def render_loss(geo_cam, tex_codes, light, imgs):
        out = renderer(geo_cam, forward_tex(mesh, tex_codes), light)  # [S, H, W, 4]
        mask = out[..., 3].detach() > 0.0
        err = ((out[..., :3] - imgs) ** 2).sum(-1) * mask / 255.0
        return (err.sum((1, 2)) / mask.sum((1, 2)).float().clamp_min(1.0)).mean()  # cal_col_loss

    def lan_loss_of(idb, expb, eulb, trb, lms_b):
        proj = project(landmarks_from_params(lm_basis, idb, expb), eulb, trb, focal, cxy)
        return _lan_loss(proj, lms_b)

    def leaf(x):
        return x.detach().clone().requires_grad_(True)

    # ----------------------------------------------------- stage 1: light
    sel = np.arange(0, N, max(1, N // S))[:S]
    sel_t = torch.as_tensor(sel, device=dev)
    sel_imgs, sel_lms = frames(sel), lms[sel_t]
    p1 = {"tex": torch.zeros((1, mesh.tex_dim), device=dev),
          "light": torch.zeros((S, 27), device=dev), "id": idp,
          "exp": exp[sel_t], "euler": euler[sel_t], "trans": trans[sel_t]}
    p1 = {k: leaf(v) for k, v in p1.items()}

    def stage1_loss(lan_w, regid_w, regexp_w):
        loss_lan = lan_loss_of(p1["id"].expand(S, lm_basis.id_dim), p1["exp"], p1["euler"],
                               p1["trans"], sel_lms)
        geo = forward_geo(mesh, p1["id"].expand(S, mesh.id_dim), p1["exp"])
        geo_cam = rott(geo, p1["euler"], p1["trans"])
        loss_col = render_loss(geo_cam, p1["tex"].expand(S, mesh.tex_dim), p1["light"],
                               sel_imgs)
        return (loss_col + lan_w * loss_lan + regid_w * (p1["id"] ** 2).mean()
                + regexp_w * (p1["exp"] ** 2).mean())

    for phase, (lo, hi) in enumerate([(0, min(51, light_iters)), (51, light_iters)]):
        if hi <= lo:
            continue
        d = 0.2**phase
        opt = torch.optim.Adam([{"params": [p1["tex"], p1["light"]], "lr": 0.1 * d},
                                {"params": [p1[k] for k in ("id", "exp", "euler", "trans")],
                                 "lr": 0.01 * d}])
        for it in range(lo, hi):
            weights = (0.05, 1.0, 0.8) if it > 50 else (3.0, 2.0, 1.0)
            opt.zero_grad(set_to_none=True)
            loss = stage1_loss(*weights)
            loss.backward()
            opt.step()

    idp, tex = p1["id"].detach(), p1["tex"].detach()
    # copies: on the CPU the tensors share memory with track's arrays
    euler, trans, exp = euler.clone(), trans.clone(), exp.clone()
    euler[sel_t], trans[sel_t], exp[sel_t] = (p1[k].detach() for k in ("euler", "trans", "exp"))
    light = p1["light"].detach().mean(0, keepdim=True).repeat(N, 1)
    del sel_imgs

    # ---------------------------------------------- stage 2: fine fitting
    pre_num = 5

    def stage2_loss(p2, imgs_b, lms_b, pre_geo, lan_w):
        B = p2["exp"].shape[0]
        loss_lan = lan_loss_of(idp.expand(B, lm_basis.id_dim), p2["exp"], p2["euler"],
                               p2["trans"], lms_b)
        geo = forward_geo(mesh, idp.expand(B, mesh.id_dim), p2["exp"])
        geo_cam = rott(geo, p2["euler"], p2["trans"])
        loss_col = render_loss(geo_cam, tex.expand(B, mesh.tex_dim), p2["light"], imgs_b)
        # temporal laplacian on the rigid vertices, with the 5 preceding
        # already-refined frames prepended (face_tracker.py:323-339)
        rg = geo_cam[:, rigid, :].reshape(B, -1)
        if pre_geo is not None:
            rg = torch.cat([pre_geo, rg], 0)
        lap = rg[1:-1] - 0.5 * (rg[:-2] + rg[2:])
        return (0.5 * loss_col + lan_w * loss_lan + 1e5 * (lap**2).mean()
                + (p2["exp"] ** 2).mean())

    for bi in range(-(-N // S)):
        start = min(bi * S, N - S)
        ids = torch.arange(start, start + S, device=dev)
        p2 = {"exp": leaf(exp[ids]), "euler": leaf(euler[ids]), "trans": leaf(trans[ids]),
              "light": leaf(light[ids])}
        pre_geo = None
        if start >= pre_num:
            pre = torch.arange(start - pre_num, start, device=dev)
            geo_pre = forward_geo(mesh, idp.expand(pre_num, mesh.id_dim), exp[pre])
            pre_geo = rott(geo_pre, euler[pre], trans[pre])[:, rigid, :].reshape(pre_num, -1)
        imgs_b = frames(np.arange(start, start + S))
        opt = torch.optim.Adam(list(p2.values()), lr=0.005)
        for it in range(fine_iters):
            opt.zero_grad(set_to_none=True)
            loss = stage2_loss(p2, imgs_b, lms[ids], pre_geo, 8.0 if it <= 30 else 1.5)
            loss.backward()
            opt.step()
        exp[ids], euler[ids], trans[ids], light[ids] = (
            p2[k].detach() for k in ("exp", "euler", "trans", "light"))
        del imgs_b

    out = dict(track)
    out.update({k: v.cpu().numpy().astype(np.float32) for k, v in (
        ("euler", euler), ("trans", trans), ("exp", exp), ("id", idp), ("tex", tex),
        ("light", light))})
    return out


def _frame_paths(ori_imgs_dir: str, ext: str) -> list:
    return sorted(glob.glob(os.path.join(ori_imgs_dir, f"*.{ext}")),
                  key=lambda p: int(os.path.basename(p).split(".")[0]))


def make_photometric_fn(mesh, lm_basis: LandmarkBasis, ori_imgs_dir: str,
                        img_h: int, img_w: int, device="cuda", **kwargs):
    """A ``track_landmarks`` ``photometric_fn``: loads the frames (uint8 RGB,
    on the host) and their landmark files and runs ``photometric_refine`` on
    ``device``."""
    dev = resolve_device(device)

    def photometric_fn(track: dict) -> dict:
        import cv2

        paths = _frame_paths(ori_imgs_dir, "jpg")
        imgs = np.stack([cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in paths])
        lms = np.stack([np.loadtxt(p.replace(".jpg", ".lms")) for p in paths]).astype(np.float32)
        return photometric_refine(track, lms, imgs, mesh, lm_basis, img_h, img_w,
                                  device=dev, **kwargs)

    return photometric_fn


def basis_from_file(path: str, keys_path: Optional[str] = None,
                    id_dim: int = 100, exp_dim: int = 79) -> LandmarkBasis:
    """A LandmarkBasis from disk. Two formats:

    - ``.npz`` with ``mean [68, 3]``, ``id_base [68, 3, id]``, ``exp_base
      [68, 3, exp]`` (the JAX package's native format), or
    - the reference's ``3DMM_info.npy`` (convert_BFM.py: ``mu_shape`` /
      ``b_shape`` / ``sig_shape`` + exp + tex arrays, Basel-2009 units) with
      ``keys_info.npy`` (``keyinds`` = landmark vertex ids) as ``keys_path``.
      The sigma scalings are folded into the bases so unit-scale parameters
      match the reference's ``para * sig`` (facemodel.py:28-30, 51-53).
    """
    if path.endswith(".npz"):
        blob = np.load(path)
        return LandmarkBasis(
            mean=np.asarray(blob["mean"], np.float32),
            id_base=np.asarray(blob["id_base"], np.float32),
            exp_base=np.asarray(blob["exp_base"], np.float32),
        )
    info = np.load(path, allow_pickle=True).item()
    if keys_path is None:
        raise ValueError("3DMM_info.npy needs keys_info.npy (landmark vertex ids) as keys_path")
    keys = np.load(keys_path, allow_pickle=True).item()
    keyinds = np.asarray(keys["keyinds"]).reshape(-1)

    mu = (np.asarray(info["mu_shape"]) + np.asarray(info["mu_exp"])).reshape(-1, 3)
    mu = mu - mu.mean(axis=0, keepdims=True)  # facemodel.py:24-26
    mu = (mu / 100000.0).astype(np.float32)

    def _base(b, sig, dim):
        b = np.asarray(b)[:dim].reshape(dim, -1, 3) / 100000.0
        b = b * np.asarray(sig)[:dim, None, None]  # fold sig: unit params
        return np.transpose(b, (1, 2, 0)).astype(np.float32)  # [V, 3, dim]

    id_base = _base(info["b_shape"], info["sig_shape"], id_dim)
    exp_base = _base(info["b_exp"], info["sig_exp"], exp_dim)
    return LandmarkBasis(mean=mu[keyinds], id_base=id_base[keyinds],
                         exp_base=exp_base[keyinds])


def make_tracker_fn(basis: LandmarkBasis, device="cuda", **kwargs):
    """A PreprocessPipeline ``tracker_fn`` on the frames' landmark files,
    fitting on ``device``."""
    dev = resolve_device(device)

    def tracker_fn(ori_imgs_dir: str, h: int, w: int, n_frames: int) -> dict:
        lms = np.stack([np.loadtxt(p) for p in _frame_paths(ori_imgs_dir, "lms")], 0)
        return track_landmarks(lms, w, h, basis, device=dev, **kwargs)

    return tracker_fn
