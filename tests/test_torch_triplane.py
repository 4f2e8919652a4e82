"""ER-NeRF's field in the port (``--arch ernerf``): ``TriplaneNetwork``
against the benchmark's plain reference (``portbench/reference/
field_triplane.py`` and ``render_triplane.py``, plain float32 PyTorch), the
tri-plane encode's plain twin, the captured frame, checkpoints, the CLIs and
what they refuse. No JAX: ER-NeRF has no JAX counterpart, so the reference
is the benchmark's, written from ER-NeRF's equations.

Tolerances: the field's head runs the reference's float32 ops in the same
order and is held bit for bit. The torso's adaptive pose encoding inverts
the 4x4 pose as the adjugate over the determinant where the reference calls
``torch.linalg.inv``: APE's six numbers differ in their last bits (held to
1e-6 relative), and the torso grid's finest levels (U(-4, 4) tables over
cells of 1/1024) magnify that to about 1e-4 of a torso pixel, so the torso
and the frame are held to 2e-3 absolute and 5e-5 root-mean-square.

The ``cuda``-marked cases run kernel A-tri and the CLIs on the card:

    python -m pytest tests/test_torch_triplane.py -q --noconftest
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import field_triplane as ftri
from portbench.reference import render as rrender
from portbench.reference import render_triplane as rtri
from portbench.reference import scene as rscene
from radnerf_tpu_torch import infer
from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.data.rays import convert_poses, get_bg_coords, get_rays
from radnerf_tpu_torch.main import main
from radnerf_tpu_torch.models import (
    NetworkConfig, RenderConfig, TriplaneNetwork, build_network, frame_graph, graph_stats,
    make_state, render_rays, reset_graph_stats,
)
from radnerf_tpu_torch.models.network_triplane import inverse4, triplane_spec
from radnerf_tpu_torch.ops import _kernels, grid_encode_plain, triplane_encode, \
    triplane_encode_plain
from radnerf_tpu_torch.train import Trainer
from radnerf_tpu_torch.utils.image import write_png

REPO = Path(__file__).resolve().parents[1]
MODEL = {"arch": "ernerf", "asr_model": "deepspeech", "audio_in_dim": 29, "audio_dim": 32,
         "att": 2, "hidden_dim": 64, "geo_feat_dim": 64, "num_layers": 3,
         "num_layers_color": 2, "hidden_dim_color": 64, "ind_dim": 4, "ind_num": 10000,
         "ind_dim_torso": 8, "torso_shrink": 0.8, "bound": 1.0, "exp_eye": True}
RENDER = {"bound": 1.0, "min_near": 0.05, "density_thresh": 10.0, "density_thresh_torso": 0.01,
          "max_steps": 16, "dt_gamma": 1.0 / 256, "cull_T": 1e-6, "T_thresh": 1e-4,
          "grid_size": 128}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread: the suite's parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options(**kw) -> Options:
    return Options(arch="ernerf", asr_model="deepspeech", exp_eye=True, torso=True, **kw)


def _cfg(**kw) -> NetworkConfig:
    return NetworkConfig(arch="ernerf", audio_in_dim=29, audio_dim=32, torso=True,
                         exp_eye=True, **kw)


def _avatar(seed: int = 7, device="cpu"):
    """The reference's avatar draw and the program's network holding it."""
    arch = ftri.Arch(MODEL, torso=True)
    params = ftri.draw_params(arch, "avatar", seed, device)
    net = build_network(_cfg(), device=device)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(params[name])
    return arch, params, net


def _pose(yaw: float = 0.05, t=(0.01, -0.02, -3.3)) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = t
    return pose


# ------------------------------------------------------------- the field
def test_field_matches_the_reference():
    """field_forward, field_density and field_uncertainty at the published
    widths on 2,048 points (some outside the box), bit for bit."""
    arch, p, net = _avatar()
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2048, 3, generator=g) * 2.2 - 1.1
    d = torch.nn.functional.normalize(torch.randn(2048, 3, generator=g), dim=-1)
    enc_a = torch.randn(1, 32, generator=g)
    eye = torch.tensor([[0.27]])
    with torch.no_grad():
        mine = net.field_forward(x, d, enc_a, p["individual_codes"][3], eye)
        ref = ftri.field_forward(p, arch, x, d, enc_a, p["individual_codes"][3], eye)
        for a, b in zip(mine, ref):
            assert a.shape == b.shape and torch.equal(a, b)
        assert torch.equal(net.field_density(x, enc_a, eye)["sigma"],
                           ftri.field_density(p, arch, x, enc_a, eye))
        u = net.field_uncertainty(x)
        assert u.shape == (2048, 1) and torch.equal(u, ftri.field_uncertainty(p, arch, x))
    assert mine[2].shape == (2048, 1) and float(mine[1].min()) >= -1e-3


def test_ape_torso_matches_the_reference():
    """The adaptive pose encoding's six numbers and the torso layer."""
    arch, p, net = _avatar()
    pose = torch.from_numpy(_pose())[None]
    feats = net.anchor_features(pose)
    assert feats.shape == (1, 6)
    torch.testing.assert_close(feats, ftri.anchor_features(p, pose), rtol=1e-6, atol=0)
    torch.testing.assert_close(inverse4(pose), torch.linalg.inv(pose), rtol=1e-6, atol=1e-6)
    xy = torch.rand(2048, 2, generator=torch.Generator().manual_seed(5)) * 2 - 1
    code = p["individual_codes_torso"][1]
    with torch.no_grad():
        alpha, color, dx = net.forward_torso(xy, pose, code)
        ref = ftri.forward_torso(p, arch, xy, pose, code)
    assert dx.shape == (2048, 2)
    for a, b in zip((alpha, color), ref):
        assert float((a - b).abs().max()) < 2e-3
        assert float((a - b).pow(2).mean().sqrt()) < 5e-5


def test_triplane_twin_is_three_plane_encodes():
    """The plain twin against the reference's own hash encode (an
    independent copy of the hashed corner index) on each plane, a point
    outside the box on one axis zero on the two planes that see it."""
    spec = triplane_spec(1.0)
    g = torch.Generator().manual_seed(11)
    tables = [torch.rand(spec.n_embeddings, 1, generator=g) * 8 - 4 for _ in range(3)]
    x = torch.rand(4096, 3, generator=g) * 2 - 1
    x[0] = torch.tensor([1.5, 0.2, -0.3])
    out = triplane_encode(x, tables, spec, 1.0)
    assert out.shape == (4096, 36)
    arch = ftri.Arch(MODEL, torso=False)
    for k, (dims, t) in enumerate(zip(ftri.PLANES, tables)):
        plane = out[:, 12 * k:12 * (k + 1)]
        assert torch.equal(plane, grid_encode_plain(x[:, list(dims)], t, spec, 1.0))
        assert torch.equal(plane, ftri.plane_encode(x[:, list(dims)], t, arch.plane, 1.0))
    assert torch.equal(out[0, :12], torch.zeros(12)) and torch.equal(out[0, 24:], torch.zeros(12))
    assert bool((out[0, 12:24] != 0).any())
    assert any(spec.hashed(level) for level in range(12)) and not spec.hashed(0)


# ------------------------------------------------------------- the frame
def _frame_inputs(H: int, seed: int = 4):
    pose = _pose()
    focal = 1200.0 * H / 450.0
    rays = get_rays(pose, (focal, focal, H / 2, H / 2), H, H, -1)
    auds = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(8, 29, 16)).astype(np.float32))
    return {"rays_o": torch.from_numpy(rays["rays_o"]), "rays_d": torch.from_numpy(rays["rays_d"]),
            "bg_coords": torch.from_numpy(get_bg_coords(H, H)),
            "poses": torch.from_numpy(convert_poses(pose[None])),
            "poses_matrix": torch.from_numpy(pose)[None], "auds": auds,
            "eye": torch.tensor([[0.3]]), "index": 0, "bg_color": torch.ones(H * H, 3),
            "H": H, "W": H}


def test_frame_through_test_step_matches_the_reference():
    """One 48x48 head+torso frame of the avatar through Trainer.test_step
    (the default capacities on the bench occupancy at 128^3) against
    render_triplane.render."""
    arch, p, _ = _avatar(seed=9)
    tr = Trainer(_options(), device="cpu", workspace=None, mute=True)
    with torch.no_grad():
        for name, q in tr.net.named_parameters():
            q.copy_(p[name])
    occ, torso = rscene.avatar_grids("cpu", 128)
    mean = float(occ.mean())
    tr.state = make_state(tr.render_cfg, occ, torso, mean, float(torso.mean()),
                          audio_dim=32)
    batch = _frame_inputs(48)
    pred, _ = tr.test_step(dict(batch))
    rs = rrender.RenderSettings(RENDER, torso=True, smooth_lips=False)
    state = rrender.make_state(rs, occ, torso, mean, float(torso.mean()),
                               min(mean, RENDER["density_thresh"]), 32)
    with torch.no_grad():
        ref = rtri.render(p, arch, rs, state, batch, ftri.encode_audio(p, arch, batch["auds"]))
    gap = (torch.from_numpy(pred).reshape(-1, 3) - ref["image"]).abs()
    assert float(gap.max()) < 2e-3 and float(gap.pow(2).mean().sqrt()) < 5e-5
    # the head is there: opaque rays in front of the torso
    assert float(ref["weights_sum"].max()) > 0.5 and ref["n_samples"] > 1000


@pytest.fixture
def segmented(monkeypatch):
    monkeypatch.setattr(frame_graph, "engages", lambda rays_o: True)
    reset_graph_stats()
    yield
    reset_graph_stats()


def test_captured_frame_equals_the_eager_frame(segmented, monkeypatch):
    """The captured path's segments on the CPU: the torso segment takes the
    4x4 pose as a static input; 3 captures, then 3 replays a frame, every
    frame bit for bit the eager one from the same incoming state."""
    _, _, net = _avatar()
    G = 32
    rc = RenderConfig(grid_size=G, torso=True, smooth_lips=True, dt_gamma=1.0 / 256,
                      cull_T=1e-4)
    occ, torso = rscene.avatar_grids("cpu", G)
    state = make_state(rc, occ, torso, float(occ.mean()), float(torso.mean()), audio_dim=32)
    b = _frame_inputs(24)
    args = (b["rays_o"], b["rays_d"], b["auds"], b["bg_coords"], b["poses"], b["eye"], 0,
            b["bg_color"])
    with torch.no_grad():
        for _ in range(4):
            monkeypatch.setattr(frame_graph, "engages", lambda rays_o: True)
            out, after = render_rays(net, rc, state, *args, poses_matrix=b["poses_matrix"])
            monkeypatch.setattr(frame_graph, "engages", lambda rays_o: False)
            eager, _ = render_rays(net, rc, state, *args, poses_matrix=b["poses_matrix"])
            for k in ("image", "depth", "torso_alpha", "deform"):
                assert torch.equal(out[k], eager[k]), k
            state = after
    assert graph_stats() == {"captures": 3, "replays": 9, "eager": 5}
    with pytest.raises(ValueError, match="poses_matrix"):
        render_rays(net, rc, state, *args)


def test_a_traced_frame_carries_the_field_spans():
    """Under a profiler ER-NeRF's field stretch holds radnerf.render.field.
    triplane (A-tri) and .attention (the attention MLPs and density head)."""
    _, _, net = _avatar()
    rc = RenderConfig(grid_size=32, torso=True, dt_gamma=1.0 / 256, cull_T=1e-4)
    occ, torso = rscene.avatar_grids("cpu", 32)
    state = make_state(rc, occ, torso, float(occ.mean()), float(torso.mean()), audio_dim=32)
    b = _frame_inputs(16)
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        render_rays(net, rc, state, b["rays_o"], b["rays_d"], b["auds"], b["bg_coords"],
                    b["poses"], b["eye"], 0, b["bg_color"], poses_matrix=b["poses_matrix"])
    names = {e.key for e in prof.key_averages()}
    assert {"radnerf.render.field", "radnerf.render.field.triplane",
            "radnerf.render.field.attention"} <= names


# ------------------------------------------------------------- refusals
def test_checkpoints_record_their_field(tmp_path):
    """An ER-NeRF checkpoint carries arch and loads back bit for bit; a
    RAD-NeRF trainer refuses it, and an ER-NeRF trainer a RAD-NeRF one."""
    ws = str(tmp_path / "ws")
    _, p, _ = _avatar()
    tr = Trainer(_options(ind_num=16), device="cpu", workspace=ws, mute=True,
                 use_checkpoint="scratch")
    with torch.no_grad():
        for name, q in tr.net.named_parameters():
            q.copy_(p[name][:16] if name.startswith("individual_codes") else p[name])
    tr.save_checkpoint(full=True)
    path = os.path.join(ws, "checkpoints", "ngp_ep0000.npz")
    back = Trainer(_options(ind_num=16), device="cpu", workspace=str(tmp_path / "b"), mute=True,
                   use_checkpoint=path)
    for (n, a), (_, b) in zip(tr.net.named_parameters(), back.net.named_parameters()):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="'ernerf'.*'radnerf'"):
        Trainer(Options(exp_eye=True, torso=True, ind_num=16), device="cpu",
                workspace=str(tmp_path / "c"), mute=True, use_checkpoint=path)
    rad = Trainer(Options(exp_eye=True, ind_num=16, grid_levels=2), device="cpu",
                  workspace=str(tmp_path / "r"), mute=True, use_checkpoint="scratch")
    rad.save_checkpoint(name="rad")
    with pytest.raises(ValueError, match="'radnerf'.*'ernerf'"):
        Trainer(_options(ind_num=16), device="cpu", workspace=str(tmp_path / "e"), mute=True,
                use_checkpoint=os.path.join(str(tmp_path / "r"), "checkpoints", "rad.npz"))


def test_what_ernerf_refuses():
    """-O, a train step (and the loop step) and main without --test."""
    with pytest.raises(ValueError, match="float32"):
        TriplaneNetwork(dataclasses.replace(_cfg(), compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        Trainer(_options(ind_num=4).apply_O(), device="cpu", workspace=None, mute=True)
    tr = Trainer(_options(ind_num=4), device="cpu", workspace=None, mute=True)
    with pytest.raises(NotImplementedError, match="ER-NeRF training"):
        tr.train_step({"rays_o": torch.zeros(4, 3)})
    with pytest.raises(NotImplementedError, match="ER-NeRF training"):
        tr.step(None, 0)
    with pytest.raises(NotImplementedError, match="ER-NeRF training"):
        main(["somewhere", "--arch", "ernerf"], device="cpu")
    with pytest.raises(ValueError, match="arch"):
        NetworkConfig(arch="gaussian")
    assert _cfg().arch == NetworkConfig.from_options(_options()).arch == "ernerf"


def test_chip_smokes_triplane_work_is_the_benchmarks():
    """A-tri's bytes and flops as chip_smoke.py counts them (from the port's
    hash) equal the benchmark's roofline yardstick (work_triplane.py, from
    the plain reference's), on points in and past the box."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from portbench.reference import work_triplane

    spec = triplane_spec(1.0)
    x = torch.rand(3000, 3, generator=torch.Generator().manual_seed(5)) * 2.2 - 1.1
    got = chip_smoke.triplane_work(x, spec, 1.0)
    assert got == work_triplane.triplane_work(x, ftri.Arch(MODEL, torso=True).plane, 1.0)
    assert got[0] > x.numel() * 4 + 3000 * 36 * 4 and got[1] > 0


def test_new_modules_import_no_jax():
    mods = ["radnerf_tpu_torch.models.network_triplane", "radnerf_tpu_torch.models.factory",
            "radnerf_tpu_torch.ops.triplane_encode", "portbench.reference.field_triplane",
            "portbench.reference.render_triplane", "portbench.reference.work_triplane",
            "portbench.harness.render_triplane", "portbench.harness.render_dense",
            "portbench.harness.heap"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'radnerf_tpu')]\n"
            "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


# ------------------------------------------------------------- the CLIs
def _write_dataset(root: str, H: int, n: int, seed: int = 0):
    """A processed-video directory (the layout TalkingHeadDataset reads):
    n frames of the bench camera, plates, landmarks, 29-channel DeepSpeech
    features, train and val transforms."""
    rng = np.random.default_rng(seed)
    for sub in ("gt_imgs", "torso_imgs", "ori_imgs"):
        os.makedirs(os.path.join(root, sub))
    pose = np.zeros((4, 4), np.float32)  # its NGP pose (scale 4) is the bench camera
    pose[0, :3], pose[1, :3], pose[2, :3], pose[3, 3] = [0, 0, -1], [1, 0, 0], [0, -1, 0], 1.0
    pose[0, 3] = -3.3 / 4.0
    frames = []
    for i in range(n):
        write_png(os.path.join(root, "gt_imgs", f"{i}.jpg"),
                  rng.integers(0, 256, (H, H, 3), dtype=np.uint8))
        write_png(os.path.join(root, "torso_imgs", f"{i}.png"),
                  rng.integers(0, 256, (H, H, 4), dtype=np.uint8))
        np.savetxt(os.path.join(root, "ori_imgs", f"{i}.lms"),
                   rng.uniform(0.3 * H, 0.7 * H, (68, 2)))
        frames.append({"img_id": i, "aud_id": i, "transform_matrix": pose.tolist()})
    write_png(os.path.join(root, "bc.jpg"), rng.integers(0, 256, (H, H, 3), dtype=np.uint8))
    np.save(os.path.join(root, "aud_ds.npy"), rng.normal(size=(n, 16, 29)).astype(np.float32))
    for name in ("train", "val"):
        with open(os.path.join(root, f"transforms_{name}.json"), "w") as f:
            json.dump({"focal_len": 1200.0 * H / 450.0, "cx": H / 2, "cy": H / 2,
                       "frames": frames}, f)


def _ernerf_checkpoint(ws: str, device, grid: int):
    """The seeded avatar's ER-NeRF checkpoint of the port in ``ws``."""
    arch, p, _ = _avatar(seed=13, device=device)
    tr = Trainer(_options(ind_num=16), device=device, workspace=ws, mute=True,
                 use_checkpoint="scratch")
    with torch.no_grad():
        for name, q in tr.net.named_parameters():
            q.copy_(p[name][:16] if name.startswith("individual_codes") else p[name])
    occ, torso = rscene.avatar_grids(device, grid)
    tr.state = make_state(tr.render_cfg, occ, torso, float(occ.mean()), float(torso.mean()),
                          audio_dim=32)
    tr.save_checkpoint(full=True)


def _run_clis(tmp_path, device, H: int, n: int, grid: int):
    """main --arch ernerf --test on the dataset, then infer on a pose json:
    every frame rendered, the captured frame engaged on the card."""
    root, ws = str(tmp_path / "data"), str(tmp_path / "ws")
    _write_dataset(root, H, n)
    _ernerf_checkpoint(ws, device, grid)
    base = ["--arch", "ernerf", "--asr_model", "deepspeech", "--exp_eye", "--torso",
            "--ind_num", "16", "--workspace", ws]
    reset_graph_stats()
    tt = main([root, "--test", *base], device=device)
    assert tt.net_cfg.arch == "ernerf" and len(tt.stats["results"]) == 1
    assert os.listdir(os.path.join(ws, "results"))
    stats = graph_stats()
    with open(os.path.join(root, "transforms_val.json")) as f:
        frames = json.load(f)["frames"]
    pose_path, aud_path = str(tmp_path / "pose.json"), str(tmp_path / "aud.npy")
    with open(pose_path, "w") as f:
        json.dump({"focal_len": 1200.0 * H / 450.0, "cx": H / 2, "cy": H / 2,
                   "frames": frames}, f)
    np.save(aud_path, np.random.default_rng(5).normal(size=(n, 16, 29)).astype(np.float32))
    reset_graph_stats()
    fps = infer.main(["--pose", pose_path, "--aud", aud_path, *base[:-2],
                      "--workspace", str(tmp_path / "infer"),
                      "--ckpt", os.path.join(ws, "checkpoints", "ngp_ep0000.npz")], device=device)
    assert fps > 0
    return stats, graph_stats()


def test_clis_render_an_ernerf_checkpoint(tmp_path, monkeypatch):
    """On the CPU at 32x32 on a 32^3 grid (the CLI has no grid flag)."""
    rc_from = RenderConfig.from_options
    monkeypatch.setattr(RenderConfig, "from_options", staticmethod(
        lambda opt: dataclasses.replace(rc_from(opt), grid_size=32)))
    _run_clis(tmp_path, "cpu", 32, 3, 32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: kernel A-tri runs on the card only")
    _kernels.build_all()
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_a_tri_bit_for_bit_with_its_twin(card):
    """A-tri against the plain twin on the card (spread points, points on
    the march's rays of the bench frame, points past the box), one launch a
    call; a gradient is refused."""
    spec = triplane_spec(1.0)
    g = torch.Generator(device=card).manual_seed(17)
    tables = [torch.rand(spec.n_embeddings, 1, generator=g, device=card) * 8 - 4
              for _ in range(3)]
    o = torch.rand(4096, 1, 3, generator=g, device=card) * 1.2 - 0.6
    dirs = torch.nn.functional.normalize(torch.randn(4096, 1, 3, generator=g, device=card),
                                         dim=-1)
    ray = (o + dirs * torch.arange(16, device=card)[None, :, None] * 0.02).reshape(-1, 3)
    for x in (torch.rand(1 << 20, 3, generator=g, device=card) * 2.04 - 1.02, ray,
              torch.rand(1000, 3, generator=g, device=card) * 4 - 2):
        _kernels.reset_launches()
        out = triplane_encode(x, tables, spec, 1.0)
        assert _kernels.launches()["triplane_encode"] == 1
        assert _kernels.launches()["grid_encode"] == 0
        twin = triplane_encode_plain(x, tables, spec, 1.0)
        assert torch.equal(out, twin)
        three = [grid_encode_plain(x[:, list(d)], t, spec, 1.0)
                 for d, t in zip(ftri.PLANES, tables)]
        assert torch.equal(out, torch.cat(three, dim=-1))
    with pytest.raises(RuntimeError, match="A-tri has no backward"):
        triplane_encode(x, [t.requires_grad_() for t in tables], spec, 1.0)


@pytest.mark.cuda
def test_clis_render_an_ernerf_checkpoint_on_the_card(card, tmp_path):
    """main --arch ernerf --test and infer at 512x512 on the 128^3 grid: the
    first frame of each command eager, the second captures the three
    segments, every later frame replays them (0 captures after the
    second, 3 replays a frame); A-tri one launch a frame."""
    n = 6
    _kernels.reset_launches()
    main_stats, infer_stats = _run_clis(tmp_path, "cuda", 512, n, 128)
    # main --test: the evaluation's n frames, then the test video's n
    assert main_stats == {"captures": 3, "replays": 3 * (2 * n - 1), "eager": 1}
    assert infer_stats == {"captures": 3, "replays": 3 * (n - 1), "eager": 1}
    assert _kernels.launches()["triplane_encode"] == 2 * n + n
