"""The port's metrics against the JAX package's, on the CPU: PSNR exactly,
LPIPS-alex with the same weights to rel 1e-5 (convolution sums in another
order), the weights file, LMD with an injected landmark predictor."""

import jax
import numpy as np
import pytest
import torch

from radnerf_tpu.train.metrics import LMDMeter as JLMDMeter
from radnerf_tpu.train.metrics import LPIPS as JLPIPS
from radnerf_tpu.train.metrics import LPIPSMeter as JLPIPSMeter
from radnerf_tpu.train.metrics import PSNRMeter as JPSNRMeter

from radnerf_tpu_torch.train.metrics import LMDMeter, LPIPS, LPIPSMeter, PSNRMeter

CONV_IDS = (0, 3, 6, 8, 10)


def _images(seed, n=2, size=64):
    rng = np.random.default_rng(seed)
    a = rng.random((n, size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def _weights_from_jax(lp: JLPIPS):
    """The JAX LPIPS's filters as the official checkpoints name them."""
    alex, lin = {}, {}
    for cid, p in zip(CONV_IDS, lp.params["convs"]):
        alex[f"features.{cid}.weight"] = np.asarray(p["w"])
        alex[f"features.{cid}.bias"] = np.asarray(p["b"])
    for i, w in enumerate(lp.params["lins"]):
        lin[f"lin{i}.model.1.weight"] = np.asarray(w).reshape(1, -1, 1, 1)
    return alex, lin


def test_psnr_matches_jax():
    got, want = PSNRMeter(), JPSNRMeter()
    for seed in range(3):
        a, b = _images(seed, 1)
        got.update(a[0], b[0])
        want.update(a[0], b[0])
    assert got.measure() == want.measure() and got.report() == want.report()
    got.update(a[0], a[0])  # a perfect frame counts at the 1e-12 floor
    want.update(a[0], a[0])
    assert got.measure() == want.measure()
    got.clear()
    assert got.measure() == 0.0


def test_lpips_matches_jax_on_shared_weights():
    """The JAX LPIPS's seeded filters loaded into the port: distances to
    rel 1e-5, on differing and on equal images; the default filters differ
    (another generator) and say so in the report."""
    jl = JLPIPS(seed=3)
    port = LPIPS(device="cpu")
    uncalibrated = LPIPSMeter(device="cpu")
    assert "uncalibrated-torch" in uncalibrated.report()
    port.load_torch_weights(*_weights_from_jax(jl))
    a, b = _images(4)
    want = np.asarray(jl(jax.numpy.asarray(a), jax.numpy.asarray(b)))
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,) and want.min() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with torch.no_grad():
        assert float(port(torch.from_numpy(a), torch.from_numpy(a)).abs().max()) < 1e-6
    assert not torch.equal(LPIPS(device="cpu").weights[0], port.weights[0])


@pytest.mark.parametrize("suffix", ["npz", "pth"])
def test_lpips_weights_file(suffix, tmp_path):
    """A calibration file (npz, or a torch file with nested state dicts) gives
    the JAX meter's values to rel 1e-5 and the calibrated tag."""
    alex, lin = _weights_from_jax(JLPIPS(seed=5))
    path = str(tmp_path / f"lpips.{suffix}")
    if suffix == "npz":
        np.savez(path, **alex, **lin)
    else:
        torch.save({"alexnet": {k: torch.from_numpy(v) for k, v in alex.items()},
                    "lpips": {k: torch.from_numpy(v) for k, v in lin.items()}}, path)
    got = LPIPSMeter(weights_path=path, device="cpu")
    want = JLPIPSMeter(weights_path=path)
    for seed in (6, 7):
        a, b = _images(seed, 1)
        got.update(a[0], b[0])
        want.update(a[0], b[0])
    np.testing.assert_allclose(got.measure(), want.measure(), rtol=1e-5)
    assert got.report().startswith("LPIPS (alex) = ")
    np.savez(str(tmp_path / "bad.npz"), x=np.zeros(1))
    with pytest.raises(ValueError, match="features"):
        LPIPS(device="cpu").load_weights_file(str(tmp_path / "bad.npz"))


class _FakeLandmarks:
    """68 landmarks from the image's content."""

    def get_landmarks(self, img):
        rng = np.random.default_rng(int(img.sum()) % 1000)
        return [rng.uniform(0, 64, (68, 2))]


def test_lmd_with_a_predictor_matches_jax():
    got, want = LMDMeter(predictor=_FakeLandmarks()), JLMDMeter(predictor=_FakeLandmarks())
    for seed in (8, 9):
        a, b = _images(seed, 1)
        got.update(a[0], b[0])
        want.update(a[0], b[0])
    assert got.measure() == want.measure() > 0 and got.report() == want.report()
    with pytest.raises(ImportError):
        LMDMeter()  # no face_alignment here
