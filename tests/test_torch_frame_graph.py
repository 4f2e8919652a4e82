"""The inference frame's captured stretches (``renderer._render_graphed``,
``models/frame_graph.py``) against the eager frame (``renderer._render``).

On the CPU the segments replay eagerly through the same static buffers and
the same key logic as the CUDA graphs: the ``segmented`` fixture lets CPU
rays take the captured path that ``render_rays`` gives CUDA rays. The
frames must equal the eager ones bit for bit, carry the audio code's EMA
from frame to frame, return results that no later frame touches, capture
once per segment over a steady stream (the EMA swap included) and once more
after a persistent tensor is replaced, and keep one captured frame per
network. The ``cuda``-marked cases run real graphs on the card:

    python -m pytest tests/test_torch_frame_graph.py -q --noconftest
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from radnerf_tpu_torch.data.rays import get_bg_coords, get_rays
from radnerf_tpu_torch.models import (
    NeRFNetwork, NetworkConfig, RenderConfig, graph_stats, make_state, render_rays,
    reset_graph_stats,
)
from radnerf_tpu_torch.models import frame_graph
from radnerf_tpu_torch.models import renderer as R
from radnerf_tpu_torch.ops import _kernels
from radnerf_tpu_torch.ops.morton import morton3d_invert
from radnerf_tpu_torch.scene import build_scene, random_weights

G = 32  # the CPU scene's grid
SMALL = dict(ind_num=8, grid_levels=4, hidden_dim=32, geo_feat_dim=15,
             hidden_dim_color=32, hidden_dim_ambient=32)
RESULTS = ("image", "depth", "weights_sum", "n_hit", "n_k_span", "n_samples_needed",
           "n_max_count", "n_groups_needed", "n_group_max")
TORSO_RESULTS = ("torso_alpha", "torso_color", "deform", "n_torso_mask")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The CPU cases' tensors are small: one thread, so that the suite's
    parallel workers do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def segmented(monkeypatch):
    """CPU rays take the captured path (the segments replay eagerly); the
    counters start from zero."""
    monkeypatch.setattr(frame_graph, "engages", lambda rays_o: True)
    reset_graph_stats()
    yield
    reset_graph_stats()


def _scene(torso=True, eye=True, smooth=True, dtype="float32", seed=0):
    """A narrow network with build_scene's weight draw, a head blob and a
    shoulders mask on a 32^3 / 32^2 grid."""
    net = NeRFNetwork(NetworkConfig(**SMALL, torso=torso, exp_eye=eye, compute_dtype=dtype),
                      device="cpu")
    random_weights(net, seed)
    rc = RenderConfig(grid_size=G, torso=torso, smooth_lips=smooth, dt_gamma=1.0 / 256,
                      cull_T=1e-4)
    xyz = 2.0 * morton3d_invert(torch.arange(G**3)).float() / (G - 1) - 1.0
    head = ((xyz[:, 0] / 0.35) ** 2 + ((xyz[:, 1] - 0.1) / 0.45) ** 2
            + (xyz[:, 2] / 0.4) ** 2) < 1.0
    gy, gx = torch.meshgrid(torch.linspace(-1, 1, G), torch.linspace(-1, 1, G), indexing="ij")
    shoulders = (gx.abs() < 0.25 + 0.55 * (-(gy + 0.05)).clamp(0, 1)) & (gy < 0.05)
    state = make_state(rc, head.float()[None] * 20.0, shoulders.float().reshape(-1) * 0.5,
                       mean_density=float(head.float().mean() * 20.0),
                       mean_density_torso=0.05, thresh=5.0, audio_dim=net.cfg.audio_dim)
    return net, rc, state


def _inputs(k, n_side=16, eye=True, noises=False, device="cpu"):
    """Frame k's inputs: a camera turning about the head, its audio window,
    eye value and background, all drawn from k."""
    g = torch.Generator().manual_seed(1000 + k)
    a = 0.05 * math.sin(0.7 * k)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
    pose[:3, 3] = [3.3 * math.sin(a), 0.02 * k % 0.1, -3.3 * math.cos(a)]
    focal = 1200.0 * n_side / 450.0
    rays = get_rays(pose, (focal, focal, n_side / 2, n_side / 2), n_side, n_side, -1)
    n = n_side * n_side
    f = {"rays_o": torch.from_numpy(rays["rays_o"]), "rays_d": torch.from_numpy(rays["rays_d"]),
         "auds": torch.randn(8, 44, 16, generator=g),
         "bg_coords": torch.from_numpy(get_bg_coords(n_side, n_side)),
         "pose6": torch.randn(1, 6, generator=g) * 0.1,
         "eye": torch.rand(1, 1, generator=g) * 0.3 if eye else None,
         "bg_color": torch.rand(n, 3, generator=g),
         "noises": torch.rand(n, generator=g) if noises else None}
    return {k: None if v is None else v.to(device) for k, v in f.items()}


def _args(f):
    return (f["rays_o"], f["rays_d"], f["auds"], f["bg_coords"], f["pose6"], f["eye"], 0,
            f["bg_color"])


def _eager(net, rc, state, f):
    with torch.no_grad():
        return R._render(net, rc, state, *_args(f), f["noises"], False)


def _assert_frames_equal(got, want, torso):
    keys = RESULTS + (TORSO_RESULTS if torso else ())
    assert set(got) == set(want)
    for k in keys:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("smooth,torso,eye", [
    (True, True, True), (False, True, True), (True, False, True), (True, True, False),
    (False, False, False)])
def test_segmented_frames_equal_eager(segmented, smooth, torso, eye):
    """30 frames through render_rays' captured path equal the eager frames
    bit for bit, each chain carrying its own state (the audio code's EMA
    with smooth_lips); the key's first frame renders eagerly, its second
    captures each segment once, every later frame replays each once."""
    net, rc, state0 = _scene(torso=torso, eye=eye, smooth=smooth)
    se, sg = state0, state0
    n_frames, n_seg = 30, 3 if torso else 2
    for k in range(n_frames):
        f = _inputs(k, eye=eye)
        want, se = _eager(net, rc, se, f)
        got, sg = render_rays(net, rc, sg, *_args(f))
        _assert_frames_equal(got, want, torso)
        assert torch.equal(sg.enc_a_smooth, se.enc_a_smooth)
        assert bool(sg.enc_a_initialized) == bool(se.enc_a_initialized) == smooth
    assert int(want["n_samples_needed"]) > 300 and float(want["weights_sum"].max()) > 0.3
    assert graph_stats() == {"captures": n_seg, "replays": n_seg * (n_frames - 1), "eager": 1}


def test_results_outlive_the_next_frame(segmented):
    """Nothing frame k returned, its state included, changes when frame k+1
    replays into the same static buffers."""
    net, rc, state = _scene()
    kept = None
    for k in range(6):
        res, state = render_rays(net, rc, state, *_args(_inputs(k)))
        if kept is not None:
            for key, v in kept[0].items():
                assert torch.equal(v, kept[1][key]), key
            assert torch.equal(kept[2].enc_a_smooth, kept[3])
        kept = (res, {key: v.clone() for key, v in res.items()}, state,
                state.enc_a_smooth.clone())
    assert graph_stats()["replays"] == 3 * 5


def test_noises_are_a_static_input(segmented):
    """A perturbed frame (test_gui's spp frames) carries its noises as a
    static input: each frame's own noises, bit for bit with eager."""
    net, rc, state = _scene(smooth=False)
    for k in range(4):
        f = _inputs(k, noises=True)
        want, _ = _eager(net, rc, state, f)
        got, _ = render_rays(net, rc, state, *_args(f), noises=f["noises"])
        _assert_frames_equal(got, want, True)
    assert graph_stats() == {"captures": 3, "replays": 9, "eager": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_steady_stream_captures_once_across_the_ema_swap(segmented, dtype):
    """Frames rendered with an EMA copied into the parameters in place and
    the live values copied back after each (Trainer._eval_params) keep
    their key: one capture per segment, and under the bf16 policy the torso
    table's bf16 and packed copies are refreshed in place, so every replay
    reads the EMA's values (bit for bit with eager)."""
    net, rc, state = _scene(dtype=dtype)
    params = dict(net.named_parameters())
    ema = {k: p.detach() * (1.0 + 0.01 * torch.randn_like(p)) for k, p in params.items()}
    se = sg = state
    for k in range(8):
        f = _inputs(k)
        live = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(ema[n] + 0.001 * k)
        want, se = _eager(net, rc, se, f)
        got, sg = render_rays(net, rc, sg, *_args(f))
        _assert_frames_equal(got, want, True)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(live[n])
    assert graph_stats() == {"captures": 3, "replays": 3 * 7, "eager": 1}


@pytest.mark.parametrize("what", ["sigma_bytes", "torso_grid", "parameter", "occ_bbox"])
def test_a_replaced_tensor_recaptures_once(segmented, what):
    """Replacing a persistent tensor the frame reads in place (an upkeep's
    sigma bytes, the torso grid, a parameter's storage, the occupied box)
    frees the key's segments: its next frame renders eagerly, the one
    after captures each segment once more, and the frames stay equal to
    eager on the new values."""
    net, rc, state = _scene(smooth=False)
    for k in range(3):
        render_rays(net, rc, state, *_args(_inputs(k)))
    assert graph_stats() == {"captures": 3, "replays": 6, "eager": 1}
    kept = state  # held to the end: no replacing tensor may take a freed one's address
    if what == "sigma_bytes":
        sb = state.sigma_bytes.clone()
        sb[sb.nonzero()[::3]] = 0
        state = state.with_sigma_bytes(sb)
    elif what == "torso_grid":
        state = dataclasses.replace(state, density_grid_torso=state.density_grid_torso * 0.5)
    elif what == "occ_bbox":
        state = dataclasses.replace(state, occ_bbox=state.occ_bbox * 0.9)
    else:
        w = net.torso_net.layers[0].weight
        w.data = w.data * 1.5
    for k in range(3, 7):
        f = _inputs(k)
        want, _ = _eager(net, rc, state, f)
        got, _ = render_rays(net, rc, state, *_args(f))
        _assert_frames_equal(got, want, True)
    assert graph_stats() == {"captures": 6, "replays": 6 + 9, "eager": 2}
    assert R._FRAMES[net].segments is not None
    del kept


def test_training_and_other_shapes_fall_back(segmented):
    """A training render stays eager and captures nothing; a frame of
    another ray count is a key of its own: it frees the first key's
    segments and renders eagerly, and keys that alternate frame by frame
    stay eager and capture nothing."""
    import weakref

    net, rc, state = _scene(smooth=False)
    f = _inputs(0)
    render_rays(net, rc, state, *_args(f), training=True)
    render_rays(net, rc, state, *_args(f), training=True)
    assert graph_stats() == {"captures": 0, "replays": 0, "eager": 2}
    for k in range(3):
        render_rays(net, rc, state, *_args(_inputs(k)))
    first = [weakref.ref(s) for s in R._FRAMES[net].segments.values()]
    small = _inputs(0, n_side=8)
    want, _ = _eager(net, rc, state, small)
    got, _ = render_rays(net, rc, state, *_args(small))
    _assert_frames_equal(got, want, True)
    assert graph_stats() == {"captures": 3, "replays": 6, "eager": 4}
    assert all(r() is None for r in first)
    for k in range(4):
        f = _inputs(k, n_side=8 if k % 2 else 16)
        want, _ = _eager(net, rc, state, f)
        _assert_frames_equal(render_rays(net, rc, state, *_args(f))[0], want, True)
    assert graph_stats() == {"captures": 3, "replays": 6, "eager": 8}
    assert R._FRAMES[net].segments is None


def test_an_adapted_config_keeps_one_captured_frame(segmented):
    """Render configs adapted twice (Trainer._adapt_capacities, a restored
    checkpoint's capacities) each capture on their second frame and free
    the previous config's segments: the network keeps one captured frame,
    and its frames stay equal to eager."""
    import weakref

    net, rc, state = _scene(smooth=False)
    old, k = [], 0
    for cfg in (rc, dataclasses.replace(rc, sample_slots=24),
                dataclasses.replace(rc, sample_slots=24, march_iters=48)):
        for _ in range(3):
            f = _inputs(k)
            want, _ = _eager(net, cfg, state, f)
            _assert_frames_equal(render_rays(net, cfg, state, *_args(f))[0], want, True)
            k += 1
        assert all(r() is None for r in old)
        frame = R._FRAMES[net]
        assert frame.key[0] is cfg
        old = [weakref.ref(s) for s in frame.segments.values()]
        del frame
    assert graph_stats() == {"captures": 9, "replays": 18, "eager": 3}


def test_data_parallel_frames_stay_eager(monkeypatch):
    """Under data parallelism (an initialised group of two ranks) a rank's
    shard of the frame, as render_frame_dp renders it, stays eager:
    ``frame_graph.engages`` (here shown the shard as CUDA rays) refuses it,
    as it takes CUDA rays outside data parallelism."""
    import types

    import torch.distributed as dist

    from radnerf_tpu_torch.parallel import shard_batch

    engages, on_card = frame_graph.engages, types.SimpleNamespace(is_cuda=True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(frame_graph, "engages", lambda rays_o: engages(on_card))
    assert frame_graph.engages(None)
    reset_graph_stats()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    net, rc, state = _scene(smooth=False)
    f = _inputs(0)
    batch = {"rays_o": f["rays_o"], "rays_d": f["rays_d"], "bg_coords": f["bg_coords"],
             "bg_color": f["bg_color"], "poses": f["pose6"], "eye": f["eye"],
             "auds": f["auds"], "index": 0}
    local = shard_batch(batch, (0, 2))
    for _ in range(3):
        render_rays(net, rc, state, local["rays_o"], local["rays_d"], local["auds"],
                    local["bg_coords"], local["poses"], local["eye"], 0, local["bg_color"])
    assert graph_stats() == {"captures": 0, "replays": 0, "eager": 3}


def test_a_copied_network_starts_without_captured_frames(segmented):
    """A deep copy of a network that has captured frames (chip_smoke copies
    one to the CPU) holds none of its graphs, renders the same frame, and
    the original keeps its own."""
    import copy

    net, rc, state = _scene(smooth=False)
    for k in range(3):
        render_rays(net, rc, state, *_args(_inputs(k)))
    twin = copy.deepcopy(net)
    assert net in R._FRAMES and twin not in R._FRAMES
    f = _inputs(3)
    want, _ = _eager(net, rc, state, f)
    _assert_frames_equal(render_rays(twin, rc, state, *_args(f))[0], want, True)
    _assert_frames_equal(render_rays(net, rc, state, *_args(f))[0], want, True)


def test_a_dropped_network_frees_its_captured_frames(segmented):
    """The captured frames hold their network weakly: dropping the last
    reference frees the network and its segments at once, without the
    cyclic collector (on the card they hold the graphs' memory pools)."""
    import gc
    import weakref

    net, rc, state = _scene(smooth=False)
    for k in range(3):
        render_rays(net, rc, state, *_args(_inputs(k)))
    segments = R._FRAMES[net].segments
    refs = [weakref.ref(net)] + [weakref.ref(s) for s in segments.values()]
    del segments
    gc.disable()
    try:
        del net
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_cpu_rays_stay_eager():
    """Without the fixture CPU rays never take the captured path."""
    reset_graph_stats()
    net, rc, state = _scene(smooth=False)
    for k in range(3):
        render_rays(net, rc, state, *_args(_inputs(k)))
    assert graph_stats() == {"captures": 0, "replays": 0, "eager": 3}
    assert net not in R._FRAMES


def test_graph_spans_nest_in_the_frame(segmented):
    """Under a profiler (on the CPU, where a capture may run under one) the
    key's second frame opens ``radnerf.render.graph.capture`` once, and it
    and the third each replay every segment inside its own span, the eager
    stretches between them: the compaction's read-back, the torso (its
    segment and its grid encode), then the field's launches."""
    from radnerf_tpu_torch.utils import tracing

    net, rc, state = _scene(smooth=False)
    render_rays(net, rc, state, *_args(_inputs(0)))
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        with tracing.span("frame"):
            for k in (1, 2):
                render_rays(net, rc, state, *_args(_inputs(k)))
    spans = []
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX):
            up = e.cpu_parent
            while up is not None and not up.name.startswith(tracing.PREFIX):
                up = up.cpu_parent
            spans.append((e.name, None if up is None else up.name))
    want = {("radnerf.frame", None): 1, ("radnerf.render.graph.capture", "radnerf.frame"): 1,
            ("radnerf.render.graph.march", "radnerf.frame"): 2,
            ("radnerf.sync.compact", "radnerf.frame"): 2,
            ("radnerf.render.torso", "radnerf.frame"): 2,
            ("radnerf.render.graph.torso", "radnerf.render.torso"): 2,
            ("radnerf.render.field", "radnerf.frame"): 2,
            ("radnerf.render.graph.composite", "radnerf.frame"): 2}
    assert {s: spans.count(s) for s in set(spans)} == want


# --------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graphs are captured on the card only")
    from radnerf_tpu_torch.main import float32_matmuls

    float32_matmuls()
    _kernels.build_all()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_frames_equal_eager(dev, dtype):
    """On the card, 512x512 head+torso frames with smooth_lips through
    render_rays (real CUDA graphs after the first frame) equal the eager
    frames bit for bit, under an EMA swap each frame. The host launches
    A three times a frame (the field's two encodes and the torso's, all
    eager) and B and C only where it does not replay them: once on the
    eager first frame, twice on the capturing second (warm-up and capture),
    never after."""
    net32, rc, state, batch, auds = build_scene(512, 512, device=dev)
    net = net32
    if dtype == "bfloat16":
        net = NeRFNetwork(dataclasses.replace(net32.cfg, compute_dtype=dtype), device=dev)
        net.load_state_dict(net32.state_dict())
    rc = dataclasses.replace(rc, smooth_lips=True)
    params = dict(net.named_parameters())
    reset_graph_stats()
    se = sg = state
    a_name = "grid_encode_bf16" if dtype == "bfloat16" else "grid_encode"
    for k in range(6):
        f = {"rays_o": batch["rays_o"], "rays_d": batch["rays_d"], "auds": auds[k],
             "bg_coords": batch["bg_coords"], "pose6": batch["poses"] + 0.01 * k,
             "eye": batch["eye"] + 0.01 * k, "bg_color": batch["bg_color"], "noises": None}
        live = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.mul_(1.0 + 0.001 * k)
        want, se = _eager(net, rc, se, f)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        got, sg = render_rays(net, rc, sg, *_args(f))
        torch.cuda.synchronize()
        launches = _kernels.launches()
        _assert_frames_equal(got, want, True)
        assert torch.equal(sg.enc_a_smooth, se.enc_a_smooth)
        bc = 1 if k == 0 else 2 if k == 1 else 0
        assert (launches[a_name], launches["march_rays"], launches["composite_rays"]) == \
            (3, bc, bc)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(live[n])
    assert int(want["n_samples_needed"]) > 10_000
    assert graph_stats() == {"captures": 3, "replays": 15, "eager": 1}
