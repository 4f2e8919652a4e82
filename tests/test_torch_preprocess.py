"""The port's preprocessing against the JAX package's, on the CPU: the
BiSeNet (one seeded checkpoint in the reference's key layout through both
packages' ``load_torch_weights``, and through ``convert.bisenet_from_jax``),
the landmark tracker (``project``, ``landmarks_from_params``, ``_fit`` across
a fresh-Adam boundary, ``track_landmarks`` with its batched focal sweep),
``photometric_refine`` over two windows, the DeepSpeech front-end, tasks 2,
5, 6 and 9 on disk, and the pipeline's wiring.

Tolerances, each for a stated reason:
- BiSeNet logits: 1e-4 of the largest |logit| (18 float32 convolutions
  summing in other orders, batch norm folded differently); class maps are
  compared where the top-two margin exceeds that tolerance.
- Fits: the same Adam arithmetic on gradients whose sums run in other
  orders; losses 1e-5 relative, parameters 1e-4 (the landmark fits) and
  2e-3 of the parameter's largest magnitude (the photometric refinement:
  ~190 Adam steps whose per-pixel gradient sums differ in order).
- The numpy tasks are copies: their outputs are equal, but for task 5's
  holes, where several recovered pixels lie at the nearest distance (the
  port's colour must come from one of them).
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.preprocess import deepspeech as JD
from radnerf_tpu.preprocess import face_parsing as JP
from radnerf_tpu.preprocess import face_tracker as JT
from radnerf_tpu.preprocess import pipeline as JL
from radnerf_tpu.preprocess import render_3dmm as JR

from radnerf_tpu_torch import process
from radnerf_tpu_torch.convert import bisenet_from_jax
from radnerf_tpu_torch.preprocess import deepspeech as PD
from radnerf_tpu_torch.preprocess import face_parsing as PP
from radnerf_tpu_torch.preprocess import face_tracker as PT
from radnerf_tpu_torch.preprocess import pipeline as PL
from radnerf_tpu_torch.preprocess import render_3dmm as PR

from test_utils import parsing_dataset  # noqa: F401  (fixture)


# ------------------------------------------------------------------ BiSeNet
def _seeded_checkpoint(path, seed=0):
    """A reference-layout state dict (every key of the module, aux heads and
    step counters included) with numpy-seeded values."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in PP.BiSeNet().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            a = np.array(0, np.int64)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(("running_mean", "bn.bias", "bias")):
            a = rng.normal(0, 0.1, shape)
        elif v.dim() == 1:  # batch-norm scale
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        sd[k] = torch.from_numpy(np.asarray(a, np.int64 if a.dtype == np.int64 else np.float32))
    torch.save(sd, path)


def test_bisenet_matches_jax(tmp_path):
    path = str(tmp_path / "79999_iter.pth")
    _seeded_checkpoint(path)
    x = np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32)
    params = JP.load_torch_weights(path)
    want = np.asarray(jax.jit(JP.bisenet_apply)(params, jnp.asarray(x)))
    net = PP.load_torch_weights(path, device="cpu")
    net_j = bisenet_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tol = 1e-4 * np.abs(want).max()
    with torch.no_grad():
        for m in (net, net_j):
            got = m(torch.from_numpy(x)).numpy()
            assert got.shape == (2, 19, 64, 64)
            np.testing.assert_allclose(got, want, atol=tol)
    top2 = np.sort(want, axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * tol
    assert sure.mean() > 0.9
    classes = got.argmax(1)
    assert np.array_equal(classes[sure], want.argmax(1)[sure])
    colors = PP.classes_to_colors(classes[0].astype(np.uint8))
    assert np.array_equal(colors, JP.classes_to_colors(classes[0].astype(np.uint8)))
    # the reference's checkpoint loads strictly; a missing key raises
    sd = torch.load(path)
    del sd["ffm.conv1.weight"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="ffm.conv1.weight"):
        PP.load_torch_weights(path, device="cpu")


def test_parsing_fn_host_steps(tmp_path):
    """make_parsing_fn on a 40x56 frame: the host's normalisation is JAX's
    expression (make_parsing_fn :273-275) bit for bit, and the mask written
    is the coloured argmax of the network on it, resized back (INTER_NEAREST)."""
    path = str(tmp_path / "w.pth")
    _seeded_checkpoint(path, seed=2)
    ori, out = tmp_path / "ori_imgs", tmp_path / "parsing"
    os.makedirs(ori)
    os.makedirs(out)
    img = np.random.default_rng(3).integers(0, 255, (40, 56, 3)).astype(np.uint8)
    cv2.imwrite(str(ori / "0.jpg"), img)
    PP.make_parsing_fn(path, device="cpu")(str(ori), str(out))
    rgb = cv2.cvtColor(cv2.imread(str(ori / "0.jpg")), cv2.COLOR_BGR2RGB)
    x = cv2.resize(rgb, (512, 512), interpolation=cv2.INTER_LINEAR)
    want_x = ((x.astype(np.float32) / 255.0 - JP._MEAN) / JP._STD).transpose(2, 0, 1)
    got_x = PP.normalize_frame(rgb)
    assert np.array_equal(got_x, want_x)
    with torch.no_grad():
        classes = PP.load_torch_weights(path, "cpu")(torch.from_numpy(got_x)[None])[0].argmax(0)
    want = cv2.resize(JP.classes_to_colors(classes.numpy().astype(np.uint8)), (56, 40),
                      interpolation=cv2.INTER_NEAREST)
    got = cv2.imread(str(out / "0.png"))
    assert np.array_equal(got, want)
    assert set(map(tuple, got.reshape(-1, 3))) <= {(255, 255, 255), (255, 0, 0), (0, 255, 0),
                                                   (0, 0, 255)}


def test_resize_semantics_match_jax():
    """jax.image.resize nearest / linear at BiSeNet's 2x and 8x factors is
    F.interpolate nearest / bilinear with half-pixel centres, edges
    included."""
    x = np.random.default_rng(4).normal(size=(1, 2, 5, 7)).astype(np.float32)
    for f in (2, 8):
        hw = (5 * f, 7 * f)
        for jm, tm in (("nearest", dict(mode="nearest")),
                       ("linear", dict(mode="bilinear", align_corners=False))):
            want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, *hw), method=jm))
            got = torch.nn.functional.interpolate(torch.from_numpy(x), hw, **tm).numpy()
            np.testing.assert_allclose(got, want, atol=1e-6)


# ------------------------------------------------------------------ tracker
def _basis(rng, idd=8, expd=6):
    return (rng.normal(0, 0.5, (68, 3)).astype(np.float32),
            rng.normal(0, 0.1, (68, 3, idd)).astype(np.float32),
            rng.normal(0, 0.1, (68, 3, expd)).astype(np.float32))


def _track_case(N=6, focal=800.0):
    """tests/test_utils.py's synthetic tracker case: landmarks of known
    pose/expression through a seeded basis."""
    rng = np.random.default_rng(0)
    arrays = _basis(rng)
    euler = rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32)
    trans = np.concatenate([rng.uniform(-0.2, 0.2, (N, 2)),
                            -7 + rng.uniform(-0.3, 0.3, (N, 1))], -1).astype(np.float32)
    exp = rng.normal(0, 0.3, (N, 6)).astype(np.float32)
    geo = PT.landmarks_from_params(PT.LandmarkBasis(*arrays), torch.zeros(N, 8),
                                   torch.from_numpy(exp))
    lms = PT.project(geo, torch.from_numpy(euler), torch.from_numpy(trans), focal,
                     (225.0, 225.0)).numpy()
    return arrays, (euler, trans, exp), lms


def test_project_and_landmarks_match_jax():
    rng = np.random.default_rng(5)
    arrays = _basis(rng)
    ids, exp = rng.normal(size=(4, 8)).astype(np.float32), rng.normal(size=(4, 6)).astype(np.float32)
    euler = rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32)
    trans = (rng.normal(size=(4, 3)) + [0, 0, -7]).astype(np.float32)
    geo_j = JT.landmarks_from_params(JT.LandmarkBasis(*arrays), ids, exp)
    geo = PT.landmarks_from_params(PT.LandmarkBasis(*arrays), torch.from_numpy(ids),
                                   torch.from_numpy(exp))
    np.testing.assert_allclose(geo.numpy(), np.asarray(geo_j), atol=1e-5)
    rot = PT.euler_rot(torch.from_numpy(euler))
    np.testing.assert_allclose(rot.numpy(), np.asarray(JT.euler_rot(euler)), atol=1e-6)
    want = np.asarray(jax.jit(lambda *a: JT.project(*a, 900.0, (200.0, 220.0)))(
        geo_j, euler, trans))
    got = PT.project(torch.from_numpy(np.asarray(geo_j)), torch.from_numpy(euler),
                     torch.from_numpy(trans), 900.0, (200.0, 220.0)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)  # pixels ~ 1e2: ~1e-5 relative
    # the depth clamp's gradient at a tie is split, as jnp.maximum's
    pts = np.zeros((1, 68, 3), np.float32)
    pts[0, :, 2] = 7.0 - 1e-6  # z = -(7 - 1e-6) + 7 -> 1e-6 after the translation
    tr = np.array([[0.0, 0.0, -7.0]], np.float32)
    p = torch.from_numpy(pts).requires_grad_(True)
    PT.project(p, torch.zeros(1, 3), torch.from_numpy(tr), 900.0, (0.0, 0.0)).sum().backward()
    gj = jax.jit(jax.grad(lambda q: JT.project(q, jnp.zeros((1, 3)), tr, 900.0,
                                               (0.0, 0.0)).sum()))(pts)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gj), rtol=1e-5)


def test_fit_matches_jax_across_the_adam_phases(monkeypatch):
    """_fit with both modules' phase split moved to 5 joint iterations, so
    the pose stage, both joint phases and their fresh Adams all run."""
    arrays, _, lms = _track_case()
    split = lambda n: [min(n, 5), max(0, n - 5)]  # noqa: E731
    monkeypatch.setattr(JT, "_split_iters", split)
    monkeypatch.setattr(PT, "_split_iters", split)
    pj, loss_j = JT._fit(JT.LandmarkBasis(*arrays), jnp.asarray(lms), 800.0, (225.0, 225.0),
                         n_pose=6, n_joint=12, smooth_weight=0.01)
    pp, loss_p = PT._fit(PT.LandmarkBasis(*arrays), torch.from_numpy(lms), 800.0,
                         (225.0, 225.0), n_pose=6, n_joint=12, smooth_weight=0.01)
    assert loss_p == pytest.approx(loss_j, rel=1e-5)
    for k in ("id", "exp", "euler", "trans"):
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(pj[k]), atol=1e-4)


def test_track_landmarks_recovers_focal():
    """tests/test_utils.py:143's case at its iteration counts, where JAX's
    tracker picks the true focal 800: the batched focal sweep picks it too,
    and the coarse fit reprojects within 3 pixels (that test's bound)."""
    arrays, _, lms = _track_case()
    got = PT.track_landmarks(lms, 450, 450, PT.LandmarkBasis(*arrays), device="cpu",
                             focal_candidates=[700, 800, 900], sel_stride=2,
                             focal_iters=(150, 200), coarse_iters=(150, 300))
    assert got["focal"][0] == 800.0
    for k, shape in (("euler", (6, 3)), ("trans", (6, 3)), ("id", (1, 8)), ("exp", (6, 6))):
        assert got[k].dtype == np.float32 and got[k].shape == shape
    geo = PT.landmarks_from_params(PT.LandmarkBasis(*arrays),
                                   torch.from_numpy(got["id"]).expand(6, 8),
                                   torch.from_numpy(got["exp"]))
    proj = PT.project(geo, torch.from_numpy(got["euler"]), torch.from_numpy(got["trans"]),
                      800.0, (225.0, 225.0)).numpy()
    assert np.abs(proj - lms).mean() < 3.0


def test_batched_focal_sweep_is_each_candidates_own_fit():
    """Each candidate of the batched sweep follows the fit it would have
    alone (its gradient and Adam update are its own)."""
    arrays, _, lms = _track_case()
    basis, lms_t = PT.LandmarkBasis(*arrays), torch.from_numpy(lms[::2])
    params, losses = PT._fit_batched(basis, lms_t, [700.0, 800.0], (225.0, 225.0), 20, 30)
    for c, f in enumerate((700.0, 800.0)):
        alone, loss = PT._fit(basis, lms_t, f, (225.0, 225.0), 20, 30)
        assert float(losses[c]) == pytest.approx(loss, rel=1e-5)
        for k, v in alone.items():
            np.testing.assert_allclose(params[k][c].numpy(), v.numpy(), atol=1e-5)


# ------------------------------------------------------------- photometric
def _tiny_mesh(rng, g=6):
    """tests/test_utils.py's textured 6x6 bumpy plane."""
    xs, ys = np.meshgrid(np.linspace(-1, 1, g), np.linspace(-1, 1, g), indexing="ij")
    zs = 0.15 * np.cos(2 * xs) * np.cos(2 * ys)
    mean = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(g - 1):
        for j in range(g - 1):
            a = i * g + j
            tris += [[a, a + g, a + 1], [a + 1, a + g, a + g + 1]]
    V = g * g
    return JR.MeshBasis(
        mean=mean, id_base=(rng.normal(size=(V, 3, 3)) * 0.02).astype(np.float32),
        exp_base=(rng.normal(size=(V, 3, 3)) * 0.05).astype(np.float32),
        tex_mean=(128 + 80 * np.stack([xs, ys, xs * ys], -1).reshape(-1, 3)).astype(np.float32),
        tex_base=(rng.normal(size=(V, 3, 2)) * 20).astype(np.float32),
        tris=np.asarray(tris, np.int32), rigid_ids=np.arange(V))


def test_photometric_refine_matches_jax(monkeypatch):
    """N = 10 frames in windows of 5 (the second with the laplacian over the
    5 refined frames before it), light_iters 53 and fine_iters 32 (past both
    schedule switches)."""
    rng = np.random.default_rng(0)
    mesh = _tiny_mesh(rng)
    lm = JT.LandmarkBasis(mesh.mean, mesh.id_base, mesh.exp_base)
    N, H, W, focal = 10, 32, 32, 66.0
    euler = (rng.normal(size=(N, 3)) * 0.05).astype(np.float32)
    trans = np.concatenate([rng.normal(size=(N, 2)) * 0.1,
                            -7 + rng.normal(size=(N, 1)) * 0.1], -1).astype(np.float32)
    exp = (rng.normal(size=(N, 3)) * 0.3).astype(np.float32)
    gamma = np.zeros((N, 27), np.float32)
    gamma[:, 2] = 0.3
    rend = PR.Render3DMM(focal, H, W, mesh.tris)
    geo = PR.forward_geo(mesh, torch.zeros(N, 3), torch.from_numpy(exp))
    geo_cam = torch.einsum("nij,nkj->nki", PT.euler_rot(torch.from_numpy(euler)), geo) \
        + torch.from_numpy(trans)[:, None]
    imgs = rend(geo_cam, PR.forward_tex(mesh, torch.zeros(N, 2)), torch.from_numpy(gamma))
    imgs = imgs[..., :3].numpy()
    lms = PT.project(PT.landmarks_from_params(PT.LandmarkBasis(lm.mean, lm.id_base, lm.exp_base),
                                              torch.zeros(N, 3), torch.from_numpy(exp)),
                     torch.from_numpy(euler), torch.from_numpy(trans), focal,
                     (W / 2, H / 2)).numpy()
    track = {"focal": np.array([focal], np.float32),
             "euler": euler + rng.normal(size=(N, 3)).astype(np.float32) * 0.04,
             "trans": trans + rng.normal(size=(N, 3)).astype(np.float32) * 0.08,
             "id": np.zeros((1, 3), np.float32),
             "exp": exp + rng.normal(size=(N, 3)).astype(np.float32) * 0.1}

    kw = dict(batch_size=5, light_iters=53, fine_iters=32)
    # every 16x16 tile of the 32x32 frame holds at most the mesh's 50
    # triangles: JAX's K = 64 drops none
    want = JT.photometric_refine(track, lms, imgs, mesh, lm, H, W, K=64, **kw)
    # the losses of every step, in order: 53 of stage 1 (phases 0..50 and
    # 51, 52), then 32 of each stage-2 window
    losses, backward = [], torch.Tensor.backward

    def recording(self, *a, **k):
        losses.append(float(self.detach()))
        return backward(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "backward", recording)
    got = PT.photometric_refine(track, lms, imgs, PR.MeshBasis(**vars(mesh)),
                                PT.LandmarkBasis(lm.mean, lm.id_base, lm.exp_base),
                                H, W, device="cpu", **kw)
    monkeypatch.undo()
    assert len(losses) == 53 + 2 * 32
    for k in ("euler", "trans", "exp", "id", "tex", "light"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], atol=2e-3 * max(np.abs(want[k]).max(), 1e-3))
    # both stages lower the loss (stage 1 over its first phase, stage 2 over
    # its first window)
    for first, last in ((0, 50), (53, 53 + 31)):
        assert losses[last] < losses[first]


# ---------------------------------------------------------------- deepspeech
def test_deepspeech_front_end_is_jax_exactly(tmp_path):
    rng = np.random.default_rng(6)
    audio = (rng.normal(size=16000) * 3000).astype(np.int16)
    np.testing.assert_array_equal(PD.mfcc(audio), JD.mfcc(audio))
    iv = PD.audio_to_input_vector(audio, 16000)
    np.testing.assert_array_equal(iv, JD.audio_to_input_vector(audio, 16000))
    feats = rng.normal(size=(50, 29))
    np.testing.assert_array_equal(PD.interpolate_features(feats, 50, 25, 24),
                                  JD.interpolate_features(feats, 50, 25, 24))
    # the whole extractor on a wav, with a seeded stand-in network
    from scipy.io import wavfile

    wav = str(tmp_path / "aud.wav")
    wavfile.write(wav, 16000, audio)
    w = rng.normal(size=(494, 29)).astype(np.float32)
    net = lambda v: (v @ w)[:, None, :]  # noqa: E731
    want = JD.extract_ds_features(wav, out_path=str(tmp_path / "j.npy"), net_fn=net)
    got = PD.extract_ds_features(wav, net_fn=net)
    np.testing.assert_array_equal(got, want)
    # written where the datasets read a deepspeech model's features
    np.testing.assert_array_equal(np.load(tmp_path / "aud_ds.npy"), want)


# ------------------------------------------------------------ numpy tasks
def _capture_imwrite(monkeypatch):
    """cv2.imwrite, keeping a copy of each array written by path."""
    written, real = {}, cv2.imwrite

    def imwrite(path, img, *a):
        written[os.path.basename(os.path.dirname(path)) + "/" + os.path.basename(path)] = \
            np.array(img)
        return real(path, img, *a)

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    return written


def test_background_and_torso_tasks_match_jax(parsing_dataset, tmp_path, monkeypatch):  # noqa: F811
    import shutil

    base_p = parsing_dataset
    base_j = str(tmp_path / "vid_j")
    shutil.copytree(base_p, base_j)
    written = _capture_imwrite(monkeypatch)
    args = lambda b: (b, os.path.join(b, "ori_imgs"), os.path.join(b, "parsing"))  # noqa: E731
    PL.extract_background(*args(base_p), every=1)
    plate_p = written.pop("vid/bc.jpg")
    JL.extract_background(*args(base_j), every=1)
    plate_j = written.pop("vid_j/bc.jpg")

    # off the holes the plates are equal; a hole takes its colour from one
    # of the recovered pixels nearest to it
    from scipy.ndimage import distance_transform_edt

    segs = [cv2.imread(os.path.join(base_p, "parsing", f"{i}.png")) for i in range(3)]
    dist = np.max([distance_transform_edt((s == 255).all(-1)) for s in segs], 0)
    good = dist > 5.0
    assert good.mean() > 0.3 and (~good).sum() > 500
    assert np.array_equal(plate_p[good], plate_j[good])
    gi, gj = np.nonzero(good)
    n_tied = 0
    for i, j in np.argwhere(~good):
        if (plate_p[i, j] == plate_j[i, j]).all():
            continue
        n_tied += 1
        d2 = (gi - i) ** 2 + (gj - j) ** 2
        nearest = d2 == d2.min()
        assert nearest.sum() > 1
        assert (plate_p[gi[nearest], gj[nearest]] == plate_p[i, j]).all(-1).any()

    # task 6 on the same plate: equal gt frames and torso plates
    shutil.copy(os.path.join(base_p, "bc.jpg"), os.path.join(base_j, "bc.jpg"))
    PL.extract_torso_and_gt(*args(base_p))
    JL.extract_torso_and_gt(*args(base_j))
    for i in range(3):
        for d, ext in (("gt_imgs", "jpg"), ("torso_imgs", "png")):
            a = cv2.imread(os.path.join(base_p, d, f"{i}.{ext}"), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(base_j, d, f"{i}.{ext}"), cv2.IMREAD_UNCHANGED)
            assert a.shape[:2] == (64, 64) and np.array_equal(a, b)


def test_save_transforms_json_equal(tmp_path):
    rng = np.random.default_rng(7)
    params = {"focal": np.array([1150.0]),
              "euler": rng.uniform(-0.3, 0.3, (22, 3)).astype(np.float32),
              "trans": (rng.uniform(-1, 1, (22, 3)) * 10).astype(np.float32)}
    for d, fn in (("p", PL.save_transforms), ("j", JL.save_transforms)):
        os.makedirs(tmp_path / d)
        fn(str(tmp_path / d), params, 450, 450)
    for name in ("train", "val"):
        assert (tmp_path / "p" / f"transforms_{name}.json").read_text() == \
            (tmp_path / "j" / f"transforms_{name}.json").read_text()


# ------------------------------------------------------------------ pipeline
def test_pipeline_wiring_and_refusals(tmp_path, monkeypatch):
    base = tmp_path / "ds"
    os.makedirs(base / "ori_imgs")
    video = str(base / "vid.mp4")
    open(video, "w").close()
    for i in range(2):
        cv2.imwrite(str(base / "ori_imgs" / f"{i}.jpg"), np.zeros((32, 32, 3), np.uint8))
        np.savetxt(str(base / "ori_imgs" / f"{i}.lms"), np.full((68, 2), 16.0))
    built = {}

    def fake_parsing_factory(path, device):
        built["parsing"] = (path, device)
        return lambda ori, out: built.setdefault("parsing_ran", True)

    def fake_tracker_factory(basis, device, **kw):
        built["basis"] = (basis, device, kw)
        return lambda ori, h, w, n: {"focal": np.array([900.0]),
                                     "euler": np.zeros((n, 3), np.float32),
                                     "trans": np.tile([0, 0, -7], (n, 1)).astype(np.float32)}

    monkeypatch.setattr(PP, "make_parsing_fn", fake_parsing_factory)
    monkeypatch.setattr(PT, "make_tracker_fn", fake_tracker_factory)
    rng = np.random.default_rng(0)
    npz = str(tmp_path / "basis.npz")
    np.savez(npz, mean=rng.normal(size=(68, 3)), id_base=rng.normal(size=(68, 3, 4)),
             exp_base=rng.normal(size=(68, 3, 3)))

    p = PL.PreprocessPipeline(video, parsing_weights="/fake/bisenet.pth", basis_path=npz,
                              device="cpu")
    p.run(task=4)
    assert built["parsing"] == ("/fake/bisenet.pth", torch.device("cpu")) and built["parsing_ran"]
    p.run(task=8)
    assert built["basis"][0].id_dim == 4 and built["basis"][1] == torch.device("cpu")
    assert "photometric_fn" not in built["basis"][2]
    p.run(task=9)
    with open(base / "transforms_train.json") as f:
        assert json.load(f)["focal_len"] == 900.0
    # task 7 with a landmarks_fn writes JAX's .lms files
    p.landmarks_fn = lambda img: np.stack([np.arange(68.0), img.shape[0] - np.arange(68.0)], -1)
    p.run(task=7)
    got = (base / "ori_imgs" / "1.lms").read_text()
    JL.extract_landmarks(str(base / "ori_imgs"), p.landmarks_fn)
    assert got == (base / "ori_imgs" / "1.lms").read_text() and len(got.splitlines()) == 68
    # with the reference's 3DMM files and a topology, task 8 gets the
    # photometric stage on the pipeline's device
    V = 80
    info = {k: rng.normal(size=(n, V * 3)) for k, n in (("b_shape", 100), ("b_exp", 79),
                                                        ("b_tex", 100))}
    info.update(mu_shape=rng.normal(size=V * 3) * 1e5, mu_exp=np.zeros(V * 3),
                mu_tex=rng.uniform(0, 255, V * 3), sig_shape=np.ones(100), sig_exp=np.ones(79),
                sig_tex=np.ones(100))
    files = {k: str(tmp_path / f"{k}_info.npy") for k in ("3DMM", "keys", "topology")}
    np.save(files["3DMM"], info)
    np.save(files["keys"], {"keyinds": np.arange(68), "rigid_ids": np.arange(10)})
    np.save(files["topology"], {"tris": np.array([[0, 1, 2], [2, 1, 3]], np.int32)})
    PL.PreprocessPipeline(video, basis_path=files["3DMM"], keys_path=files["keys"],
                          topology_path=files["topology"], device="cpu").run(task=8)
    assert built["basis"][0].id_dim == 100 and callable(built["basis"][2]["photometric_fn"])

    # without paths or callables the tasks fail loudly
    p2 = PL.PreprocessPipeline(video, device="cpu")
    with pytest.raises(RuntimeError, match="parsing"):
        p2.run(task=4)
    with pytest.raises(RuntimeError, match="tracking"):
        p2.run(task=8)
    # the card is the default: without one, the pipeline and the CLI refuse
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PL.PreprocessPipeline(video)
        with pytest.raises(RuntimeError, match="CUDA"):
            process.main([video, "--task", "9"])


def test_audio_task_matches_jax(tmp_path):
    """Task 2 through the CLI with a seeded stand-in acoustic model (a linear
    map of each 320-sample chunk to 44 logits): the wav2vec path writes JAX's
    aud_eo.npy; --asr deepspeech writes aud_ds.npy, where the datasets read
    a deepspeech model's features."""
    from scipy.io import wavfile

    w = np.random.default_rng(5).normal(size=(320, 44)).astype(np.float32) * 0.1

    def logits(frame):
        n = len(frame) // 320
        return frame[: n * 320].reshape(n, 320) @ w

    for d in ("p", "j"):
        os.makedirs(tmp_path / d)
        wavfile.write(str(tmp_path / d / "aud.wav"), 16000,
                      (np.random.default_rng(8).normal(size=16000) * 3000).astype(np.int16))
    process.main([str(tmp_path / "p" / "vid.mp4"), "--task", "2"], device="cpu",
                 logits_fn=logits)
    JL.PreprocessPipeline(str(tmp_path / "j" / "vid.mp4"), asr_logits_fn=logits).run(2)
    got = np.load(tmp_path / "p" / "aud_eo.npy")
    assert got.shape[1:] == (16, 44)
    np.testing.assert_array_equal(got, np.load(tmp_path / "j" / "aud_eo.npy"))
    w_ds = np.random.default_rng(9).normal(size=(494, 29)).astype(np.float32)
    process.main([str(tmp_path / "p" / "vid.mp4"), "--task", "2", "--asr", "deepspeech"],
                 device="cpu", logits_fn=lambda v: (v @ w_ds)[:, None, :])
    assert np.load(tmp_path / "p" / "aud_ds.npy").shape[1:] == (16, 29)
