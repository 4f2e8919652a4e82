"""Data parallelism of the port (``radnerf_tpu_torch/parallel``) on the CPU:
two ranks spawned with gloo and a ``file://`` store, against the JAX
package's 1-device step and the port's own 1-rank trainer (the JAX side:
tests/test_parallel.py on its 8-device mesh).

One module-scoped spawn runs every rank-side check and writes each rank's
results to a file: a head step of 512 rays (tests/test_torch_train.py's
narrow model and blob scene), a patch step with its LPIPS term, an endurance
run of 18 head steps across the upkeep at step 16 and a torso-stage run
across its own, the frame by ``render_frame_dp`` (1024 rays, and 1037 padded
by ``pad_to_multiple``) and through ``Trainer.test_step``, 3 epochs that
adapt the capacities, and a short ``train`` with a workspace on each rank. The spawned ranks import this
module, so its top level imports the port alone; JAX and the parity tests'
fixtures are imported inside the parent's functions.
"""

import datetime
import os
import time
import traceback
from multiprocessing.connection import wait

import numpy as np
import pytest
import torch
import torch.distributed as dist

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import (
    load_jax_params,
    network_from_jax,
    network_to_jax,
    state_from_numpy,
)
from radnerf_tpu_torch.models import NeRFNetwork, NetworkConfig, RenderConfig, render_rays
from radnerf_tpu_torch.parallel import create_mesh, pad_to_multiple, render_frame_dp, shard_batch
from radnerf_tpu_torch.train import PSNRMeter, Trainer
from radnerf_tpu_torch.train.capacity import CAPACITY_FIELDS

WORLD = 2
JOIN_TIMEOUT_S = 300  # all ranks together; a collective gives up after COLLECTIVE_S
COLLECTIVE_S = 120
GRID = 32
# tests/test_torch_train.py's narrow head model, and with the torso
SMALL = dict(exp_eye=True, ind_num=8, grid_levels=4, hidden_dim=32, geo_feat_dim=15,
             hidden_dim_color=32, hidden_dim_ambient=32)
SMALL_T = dict(SMALL, torso=True)
RC = dict(grid_size=GRID, max_steps=8, dt_gamma=0.0, cull_T=1e-6)
STEP, ITERS, INDEX = 40, 100, 3
STATE_KEYS = ("density_grid", "density_bitfield", "sigma_bytes", "density_grid_torso")
TELEMETRY = ("n_hit", "n_samples_needed", "n_max_count", "n_k_span")


# ------------------------------------------------------------ shared set-up
class FakeDataset:
    """tests/test_parallel.py's ``_FakeDPDataset`` for the port: seeded
    batches of ``n_rays`` rays at the blob, with the torso plate in the
    torso stage; ``H`` x ``W`` full frames at evaluation."""

    def __init__(self, n_rays=512, torso=False, seed=0, frame=(16, 16)):
        self.rng = np.random.default_rng(seed)
        self.n_rays, self.torso = n_rays, torso
        self.H, self.W = frame
        self.poses = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
        self.intrinsics = (100.0, 100.0, 32.0, 32.0)
        self.auds = self.rng.normal(size=(4, 44, 16)).astype(np.float32)
        self.eye_area = np.full((4, 1), 0.25, np.float32)
        self.training = True

    def __len__(self):
        return 2

    def epoch_indices(self):
        return np.arange(2)

    def collate(self, i):
        from radnerf_tpu_torch.data import get_audio_features

        n = self.n_rays if self.training else self.H * self.W
        o = np.tile(np.array([[0, 0, -3.3]], np.float32), (n, 1))
        d = np.concatenate([self.rng.uniform(-0.1, 0.1, (n, 2)), np.ones((n, 1))], -1)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        batch = {
            "rays_o": o, "rays_d": d, "auds": get_audio_features(self.auds, 2, i),
            "bg_coords": self.rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            "poses": np.zeros((1, 6), np.float32), "eye": self.eye_area[[i]], "index": i,
            "bg_color": np.full((n, 3), 0.5, np.float32),
            "images": self.rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "face_mask": self.rng.uniform(size=n) < 0.5,
        }
        if self.torso:
            batch["bg_torso_color"] = self.rng.uniform(0, 1, (n, 3)).astype(np.float32)
        if not self.training:
            batch["H"], batch["W"] = self.H, self.W
        return batch


def _trainer(payload, torso=False, workspace=None, **opt):
    """A port trainer of the narrow model holding the JAX parameters and
    the blob state of the payload (the JAX tables drawn U(-1, 1))."""
    o = Options(**{"exp_eye": True, "iters": ITERS, "num_rays": 512, "dt_gamma": 0.0,
                   "torso": torso, **opt})
    tr = Trainer(o, NetworkConfig(**(SMALL_T if torso else SMALL)),
                 RenderConfig(torso=torso, **RC), device="cpu", workspace=workspace,
                 use_checkpoint="scratch", metrics=[PSNRMeter()], use_tensorboard=True)
    load_jax_params(tr.net, payload["torso_params" if torso else "params"])
    tr.state = _state(payload, torso)
    return tr


def _state(payload, torso):
    rc = RenderConfig(torso=torso, **RC)
    return state_from_numpy(rc, payload["grid"], payload["torso_grid"], 1.0,
                            0.1 if torso else 0.0, thresh=1.0, device="cpu")


def _batch(f, keys=("rays_o", "rays_d", "auds", "bg_coords", "bg_color", "eye", "images")):
    b = {k: torch.from_numpy(np.array(f[k])) for k in keys}
    b.update(poses=torch.from_numpy(f["pose6"]), index=INDEX,
             face_mask=torch.from_numpy(f["face_mask"]))
    return b


def one_step(payload, f, noises, **opt):
    """A trainer's train_step at global step 40 on the batch ``f`` with the
    given (global) noises: (loss, gradients, parameters after, telemetry)."""
    tr = _trainer(payload, **opt)
    tr.global_step = STEP
    tr.draw_noises = lambda n: torch.from_numpy(noises)
    loss = float(tr.train_step(_batch(f)))
    return {"loss": loss,
            "grads": {k: p.grad.clone() for k, p in tr.net.named_parameters()
                      if p.grad is not None},
            "params": {k: p.detach().clone() for k, p in tr.net.named_parameters()},
            "telemetry": {k: int(v) for k, v in tr.telemetry.items()}}


def frame_batch(n):
    rng = np.random.default_rng(5)
    o = np.tile(np.array([[0.0, 0.0, -3.3]], np.float32), (n, 1))
    d = np.concatenate([rng.uniform(-0.25, 0.25, (n, 2)), np.ones((n, 1))], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return {"rays_o": o, "rays_d": d,
            "bg_coords": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            "bg_color": np.full((n, 3), 0.5, np.float32)}


def frame_inputs(payload, raw):
    b = {k: torch.from_numpy(v) for k, v in raw.items()}
    b.update(auds=torch.from_numpy(payload["f"]["auds"]), poses=torch.zeros((1, 6)),
             eye=torch.full((1, 1), 0.25), index=0)
    return b


def frame_1rank(payload, raw):
    net = network_from_jax(payload["torso_params"], NetworkConfig(**SMALL_T), device="cpu")
    b = frame_inputs(payload, raw)
    with torch.no_grad():
        res, _ = render_rays(net, RenderConfig(torso=True, **RC), _state(payload, True),
                             b["rays_o"], b["rays_d"], b["auds"], b["bg_coords"], b["poses"],
                             b["eye"], b["index"], b["bg_color"])
    return res


def _in_sync_arrays(tr):
    """Every array the ranks must hold alike: parameters, Adam's moments,
    the renderer state's grids and bytes."""
    out = {f"param/{k}": p.detach().clone() for k, p in tr.net.named_parameters()}
    names = {id(p): k for k, p in tr.net.named_parameters()}
    for p, st in tr.optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"adam/{names[id(p)]}/{k}"] = st[k].clone()
    for k in STATE_KEYS:
        out[f"state/{k}"] = getattr(tr.state, k).clone()
    return out


# -------------------------------------------------------------- the ranks
def _rank_checks(rank, payload, ws_root):
    f, noises = payload["f"], payload["noises"]
    out = {"world": create_mesh()}
    out["step"] = one_step(payload, f, noises, data_parallel=True)
    out["patch"] = one_step(payload, payload["f_patch"], payload["noises_patch"],
                            data_parallel=True, patch_size=32, num_rays=1024)

    # endurance: 18 head steps across the upkeep at step 16, then the torso
    # stage across its own
    for name, torso, steps in (("head_run", False, 18), ("torso_run", True, 17)):
        tr = _trainer(payload, torso=torso, data_parallel=True, update_extra_interval=16)
        loss = tr.train_gui(FakeDataset(torso=torso), step=steps)["loss"]
        out[name] = {"loss": loss, "steps": tr.global_step,
                     "mean_density": float(tr.state.mean_density),
                     "mean_density_torso": float(tr.state.mean_density_torso),
                     "telemetry": {k: int(v) for k, v in tr.telemetry.items()},
                     "arrays": _in_sync_arrays(tr)}

    out["adaptive"] = adaptive_run(payload, data_parallel=True)

    # the frame: divided, padded, and through the trainer
    net = network_from_jax(payload["torso_params"], NetworkConfig(**SMALL_T), device="cpu")
    rc = RenderConfig(torso=True, **RC)
    frames = {}
    for n in (1024, 1024 + 13):
        padded, n_orig = {}, n
        for k, v in frame_batch(n).items():
            padded[k], n_orig = pad_to_multiple(v, WORLD)
        res, _ = render_frame_dp(net, rc, _state(payload, True), frame_inputs(payload, padded))
        frames[n] = {"image": res["image"][:n_orig], "depth": res["depth"][:n_orig],
                     "padded_rays": int(padded["rays_o"].shape[0]),
                     "telemetry": {k: int(v) for k, v in res.items() if k.startswith("n_")}}
    tr = _trainer(payload, torso=True, data_parallel=True)
    b = frame_inputs(payload, frame_batch(1024))
    b["H"], b["W"] = 32, 32
    frames["test_step"] = tr.test_step(b)
    out["frames"] = frames

    # a short train with a workspace: rank 0 alone writes files
    ws = os.path.join(ws_root, f"rank{rank}")
    tr = _trainer(payload, workspace=ws, data_parallel=True)
    val = FakeDataset(seed=1)
    val.training = False
    tr.train(FakeDataset(), val, max_epochs=1)
    out["train"] = {"valid_loss": tr.stats["valid_loss"], "results": tr.stats["results"],
                    "loss": tr.stats["loss"], "mute": tr.mute, "ws": ws}
    return out


def adaptive_run(payload, **opt):
    """3 epochs of FakeDataset's 2 steps with an upkeep every step, so that
    each epoch's second upkeep adapts the capacities (``auto_capacity``):
    the capacities after each epoch, the adaptations, the step losses and
    the arrays that must agree across ranks."""
    tr = _trainer(payload, update_extra_interval=1, **opt)
    ds, caps = FakeDataset(seed=2), []
    for epoch in (1, 2, 3):
        tr.epoch = epoch
        tr.train_one_epoch(ds)
        caps.append(tuple(getattr(tr.render_cfg, f) for f in CAPACITY_FIELDS))
    return {"caps": caps, "adaptations": tr._adapt_count, "losses": tr.stats["step_loss"],
            "arrays": _in_sync_arrays(tr)}


def _rank_main(rank, init_file, out_dir, payload):
    torch.set_num_threads(2)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=WORLD,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_S))
        out = _rank_checks(rank, payload, out_dir)
        dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn_ranks(tmp, payload, while_running=None):
    """Run ``_rank_main`` on WORLD spawned ranks, and ``while_running()`` in
    this process meanwhile; returns (the ranks' results in rank order, what
    ``while_running`` returned), or fails with a rank's traceback, its exit
    code or the timeout. A rank that fails ends the others."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp / "store"), str(tmp), payload))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        extra = while_running() if while_running else None
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        running = list(procs)
        while running and time.monotonic() < deadline:
            wait([p.sentinel for p in running], timeout=deadline - time.monotonic())
            for p in [p for p in running if not p.is_alive()]:
                p.join()
                running.remove(p)
                if p.exitcode != 0:
                    running = []  # the others may wait on it in a collective
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errs = {r: (tmp / f"rank{r}.err").read_text() for r in range(WORLD)
            if (tmp / f"rank{r}.err").exists()}
    assert not errs, errs
    assert all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs], f"ranks {hung} killed after a failure or the "
        f"{JOIN_TIMEOUT_S} s timeout")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], extra


# -------------------------------------------------------------- the parent
def _step_inputs(n, seed):
    """tests/test_torch_train.py's 48x48 blob-scene batch: numpy."""
    from radnerf_tpu.data.rays import get_bg_coords, get_rays

    rng = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    rays = get_rays(pose, (80.0, 80.0, 24.0, 24.0), 48, 48, n, rng=rng)
    f = dict(
        rays_o=rays["rays_o"], rays_d=rays["rays_d"],
        bg_coords=get_bg_coords(48, 48)[rays["inds"]],
        pose6=np.zeros((1, 6), np.float32),
        auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
        bg_color=rng.random((n, 3)).astype(np.float32),
        eye=np.array([[0.25]], np.float32),
        images=rng.random((n, 3)).astype(np.float32),
    )
    f["face_mask"] = rng.random(n) < 0.5
    return f, rng.random(n).astype(np.float32)


def _scaled_tables(p):
    """The grid tables drawn U(-1, 1): the init's U(-1e-4, 1e-4) times 1e4."""
    for k in ("encoder", "encoder_ambient", "torso_encoder"):
        if k in p:
            p[k] = p[k] * 1e4
    return p


@pytest.fixture(scope="module")
def payload():
    """The head model as tests/test_torch_train.py's head-step test draws
    it (JAX's init_params, key 11): a step compared parameter by parameter
    needs its gradients well away from Adam's eps of 1e-15, which the port's
    own draw does not give the audio attention (|g| ~1e-11). The torso model
    is the port's seeded draw."""
    import jax

    from radnerf_tpu.models import NetworkConfig as JNetworkConfig
    from radnerf_tpu.models import init_params
    from test_train import _blob_grid

    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: init_params(k, JNetworkConfig(**SMALL)))(jax.random.PRNGKey(11)))
    torso = NeRFNetwork(NetworkConfig(**SMALL_T), device="cpu",
                        generator=torch.Generator().manual_seed(13))
    f, noises = _step_inputs(512, 12)
    f_patch, noises_patch = _step_inputs(1024, 14)
    return {"params": _scaled_tables(params),
            "torso_params": _scaled_tables(network_to_jax(torso)),
            "grid": _blob_grid(GRID),
            "torso_grid": np.full(GRID * GRID, 0.3, np.float32),
            "f": f, "noises": noises, "f_patch": f_patch, "noises_patch": noises_patch}


def jax_head_step(payload):
    """JAX's 1-device head step on the payload's batch under jit, JAX at
    exhaustive capacities: (loss, telemetry, gradients by port name)."""
    import jax
    import jax.numpy as jnp

    from radnerf_tpu.models import NetworkConfig as JNetworkConfig
    from radnerf_tpu.models import RenderConfig as JRenderConfig
    from radnerf_tpu.models import render_rays as j_render_rays
    from radnerf_tpu.train.losses import head_loss as j_head_loss
    from radnerf_tpu_torch.convert import _state_dict_from_jax
    from test_torch_train import _blob_state_j

    f, noises = payload["f"], payload["noises"]
    rc_j = JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, exp_eye=True,
                         sample_capacity_mult=16.0, ray_capacity_frac=1.0, cull_T=1e-6)
    state_j = _blob_state_j(rc_j, payload["grid"], 1.0)
    a = {k: jnp.asarray(v) for k, v in f.items()}

    def loss_fn(p):
        res, _ = j_render_rays(p, JNetworkConfig(**SMALL), rc_j, state_j, a["rays_o"],
                               a["rays_d"], a["auds"], a["bg_coords"], a["pose6"], a["eye"],
                               jnp.asarray(INDEX, jnp.int32), a["bg_color"],
                               noises=jnp.asarray(noises), training=True)
        loss = j_head_loss(res, a["images"], a["face_mask"], jnp.asarray(STEP, jnp.float32),
                           ITERS, 0.1)
        return loss, {k: res[k] for k in TELEMETRY}

    (loss, tel), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, payload["params"]))
    return (float(loss), {k: int(v) for k, v in tel.items()},
            _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory):
    """The ranks' results, and JAX's head step computed while they run."""
    return spawn_ranks(tmp_path_factory.mktemp("dp"), payload,
                       while_running=lambda: jax_head_step(payload))


def test_helpers_match_jax():
    """pad_to_multiple is JAX's exactly; shard_batch shards the same keys
    JAX's does on its 8-device mesh (an odd-length ray array and the audio
    window stay whole) and its 8 shards join to the batch."""
    import jax.numpy as jnp

    from radnerf_tpu.parallel import create_mesh as j_create_mesh
    from radnerf_tpu.parallel import shard_batch as j_shard_batch
    from radnerf_tpu.parallel.mesh import pad_to_multiple as j_pad

    rng = np.random.default_rng(0)
    for shape, multiple, value in (((13, 3), 8, 0), ((16, 3), 8, 0), ((1037, 2), 2, -1.5)):
        a = rng.normal(size=shape).astype(np.float32)
        got, want = pad_to_multiple(a, multiple, value=value), j_pad(a, multiple, value=value)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])

    batch = {"rays_o": rng.normal(size=(1024, 3)), "images": rng.normal(size=(1000, 3)),
             "bg_color": rng.normal(size=(1001, 3)), "auds": rng.normal(size=(8, 44, 16)),
             "poses": rng.normal(size=(1, 6)), "face_mask": rng.random(1024) < 0.5,
             "index": 3, "eye": None}
    mesh = j_create_mesh()
    want = j_shard_batch(mesh, {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                for k, v in batch.items()})
    j_sharded = {k for k, v in want.items()
                 if hasattr(v, "sharding") and not v.sharding.is_fully_replicated}
    tb = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    shards = [shard_batch(tb, (r, 8)) for r in range(8)]
    sharded = {k for k, v in shards[0].items()
               if torch.is_tensor(v) and v.shape[0] != tb[k].shape[0]}
    assert sharded == j_sharded == {"rays_o", "images", "face_mask"}
    for k in sharded:
        assert torch.equal(torch.cat([s[k] for s in shards]), tb[k])
    assert all(shards[0][k] is tb[k] for k in tb if k not in sharded)


def test_dp_head_step_matches_jax_and_one_rank(ranks, payload):
    """The world-size-2 head step (the same global batch and noises on each
    rank, each rank its 256 rays, gradients and loss averaged over the
    ranks): loss within rel 1e-5 of JAX's 1-device step on the same weights,
    batch and noises, every all-reduced gradient within 1e-4 of the largest
    JAX gradient, the telemetry summed (counts) and maxed to JAX's; the
    parameters after the step within rtol 1e-4, atol 1e-6 of the port's
    1-rank step, and the ranks bit for bit alike."""
    results, (loss_j, tel_j, want) = ranks
    r0, r1 = (r["step"] for r in results)
    assert results[0]["world"] == (0, 2) and results[1]["world"] == (1, 2)
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], loss_j, rtol=1e-5)
    assert r0["telemetry"]["n_samples_needed"] > 300
    for k in TELEMETRY:
        assert r0["telemetry"][k] == tel_j[k], k
    assert set(r0["grads"]) == set(want)
    for name, w in want.items():
        g = r0["grads"][name].numpy()
        assert np.array_equal(g, r1["grads"][name].numpy()), name
        tol = 1e-4 * float(np.abs(w).max()) + 1e-7
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{name}: max |g - g_jax| {err} > {tol}"

    solo = one_step(payload, payload["f"], payload["noises"])
    np.testing.assert_allclose(r0["loss"], solo["loss"], rtol=1e-5)
    for name, p in solo["params"].items():
        assert torch.equal(r0["params"][name], r1["params"][name]), name
        np.testing.assert_allclose(r0["params"][name].numpy(), p.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_dp_patch_step_matches_one_rank(ranks, payload):
    """A patch step (one 32x32 patch, its LPIPS term at 1e-3) spans both
    ranks' rays, so it runs whole on every rank: the loss within rel 1e-5
    of the 1-rank step's and the parameters after it within rtol 1e-4,
    atol 1e-6, the ranks bit for bit alike."""
    r0, r1 = (r["patch"] for r in ranks[0])
    solo = one_step(payload, payload["f_patch"], payload["noises_patch"], patch_size=32,
                    num_rays=1024)
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], solo["loss"], rtol=1e-5)
    assert r0["telemetry"] == solo["telemetry"]
    for name, p in solo["params"].items():
        assert torch.equal(r0["params"][name], r1["params"][name]), name
        np.testing.assert_allclose(r0["params"][name].numpy(), p.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("run", ["head_run", "torso_run"])
def test_dp_ranks_stay_in_sync(ranks, run):
    """After 18 head steps (upkeeps at steps 0 and 16) and 17 torso-stage
    steps (the torso grid's upkeeps at 0 and 16), every rank's parameters,
    Adam moments, density grid, bitfield, sigma bytes and torso grid are bit
    for bit alike (tests/test_parallel.py:181, :221); the runs did work."""
    r0, r1 = (r[run] for r in ranks[0])
    assert r0["steps"] == r1["steps"] == (18 if run == "head_run" else 17)
    assert np.isfinite(r0["loss"]) and r0["loss"] == r1["loss"]
    assert r0["telemetry"]["n_samples_needed"] > 0
    if run == "head_run":
        assert r0["mean_density"] > 0
    else:
        assert r0["mean_density_torso"] > 0
    assert set(r0["arrays"]) == set(r1["arrays"])
    assert sum(k.startswith("adam/") for k in r0["arrays"]) > 0
    for k, v in r0["arrays"].items():
        assert torch.equal(v, r1["arrays"][k]), k


def test_dp_adaptive_capacities_match_one_rank(ranks, payload):
    """Under data parallelism each rank adapts the capacities from the
    telemetry reduced over the ranks: after each of 3 epochs both ranks
    hold the 1-rank trainer's seven capacities, with the same number of
    adaptations (at least one), their arrays bit for bit alike."""
    r0, r1 = (r["adaptive"] for r in ranks[0])
    one = adaptive_run(payload)
    assert r0["caps"] == r1["caps"] == one["caps"]
    assert r0["adaptations"] == r1["adaptations"] == one["adaptations"] >= 1
    assert r0["caps"][-1] != tuple(getattr(RenderConfig(**RC), f) for f in CAPACITY_FIELDS)
    assert np.all(np.isfinite(r0["losses"])) and r0["losses"] == r1["losses"]
    for k, v in r0["arrays"].items():
        assert torch.equal(v, r1["arrays"][k]), k


@pytest.mark.parametrize("n", [1024, 1024 + 13])
def test_dp_frame_matches_one_rank(ranks, payload, n):
    """render_frame_dp's frame (each rank its half of the rays, image and
    depth gathered by a sum all_reduce, telemetry reduced) against the
    1-rank render of the same rays: rtol 1e-5, atol 1e-5 (tests/
    test_parallel.py:247, :309); 1037 rays padded to 1038 with misses and
    the padding stripped; the frame is not the bare background."""
    want = frame_1rank(payload, frame_batch(n))
    for r in ranks[0]:
        got = r["frames"][n]
        assert got["padded_rays"] == n + n % 2
        np.testing.assert_allclose(got["image"].numpy(), want["image"].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["depth"].numpy(), want["depth"].numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert float((want["image"] - 0.5).abs().sum()) > 1.0
    if n % WORLD == 0:
        tel = {k: int(v) for k, v in want.items() if k.startswith("n_")}
        assert ranks[0][0]["frames"][n]["telemetry"] == tel


def test_dp_test_step_and_rank0_files(ranks, payload):
    """Trainer.test_step under data parallelism renders the frame sharded,
    as the 1-rank render; a short train with a workspace on each rank (its
    own directory): the same losses and evaluation on both ranks, rank 0's
    directory holds the log, the checkpoints, the validation images and the
    tensorboard run, rank 1 writes nothing and is muted."""
    want = frame_1rank(payload, frame_batch(1024))
    for r in ranks[0]:
        pred, depth = r["frames"]["test_step"]
        np.testing.assert_allclose(pred, want["image"].numpy().reshape(32, 32, 3),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(depth, want["depth"].numpy().reshape(32, 32),
                                   rtol=1e-5, atol=1e-5)
    t0, t1 = (r["train"] for r in ranks[0])
    assert t0["loss"] == t1["loss"] and t0["valid_loss"] == t1["valid_loss"]
    assert t0["results"] == t1["results"] and np.isfinite(t0["results"]).all()
    assert (t0["mute"], t1["mute"]) == (False, True)
    ws0 = t0["ws"]
    assert not os.path.exists(t1["ws"])
    files = sorted(os.listdir(ws0))
    assert {"log_ngp.txt", "checkpoints", "validation"} <= set(files), files
    with open(os.path.join(ws0, "log_ngp.txt")) as fh:
        log = fh.read()
    assert "[INFO] data parallel over 2 ranks (gloo), this rank 0 on cpu" in log
    assert "==> Start Training Epoch 1 ..." in log and "++> Evaluate epoch 1 Finished" in log
    assert sorted(os.listdir(os.path.join(ws0, "checkpoints"))) == ["ngp.npz", "ngp_ep0001.npz"]


def test_data_parallel_without_group_is_the_plain_trainer(payload):
    """data_parallel=True with no process group trains exactly as the plain
    trainer: the same losses and parameters bit for bit after 3 steps."""
    assert create_mesh() is None
    runs = []
    for dp in (False, True):
        tr = _trainer(payload, data_parallel=dp, update_extra_interval=2)
        assert tr.world is None and tr.is_main and not tr.mute
        losses = tr.train_gui(FakeDataset(), step=3)["loss"]
        runs.append((losses, {k: p.detach().clone() for k, p in tr.net.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
