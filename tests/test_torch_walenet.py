"""The port's Wale-Net predictor (`frenetix_tpu_torch.models.walenet`) against
the JAX package's (`frenetix_tpu.models.walenet`), on the CPU.

Both read the same synthetic export (`workloads.write_synthetic_walenet_onnx`
at narrow widths; the real weights are not in the repository).

- Preprocessing: the scene raster, hist, nbrs and the frames bitwise equal
  to the JAX module's NumPy route (its native rasterizer is switched off:
  it differs pixel-wise and only reaches ~95 % coverage of the reference).
- `predict` and `walenet_predictions`: both nets run in float32 (weights and
  inputs are float32 in both packages), in different orders of summation;
  the net outputs agree within 1e-4 (tests/test_walenet.py's eager-vs-jit
  bound), so the world-frame means within 1e-4 m and the covariances and
  their inverses within 1e-4 relative.
- Everything after the net is exact: with the JAX net's (T, B, 5) output
  injected into the port (the port patched, not JAX) every field of
  `walenet_predictions` is bitwise equal, in float32 and float64.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu import native
from frenetix_tpu.io import scenario_factory as jfactory
from frenetix_tpu.models import walenet as jw
from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.models import walenet as tw
from frenetix_tpu_torch.workloads import write_synthetic_walenet_onnx

from torch_parity import CPU

torch.set_num_threads(1)

WIDTHS = dict(conv1=4, conv2=3, embed=4, enc=6, nbr_feat=5, scene_feat=3, dec=7)
FIELDS = ("means", "covs", "inv_covs", "orientations", "velocities", "lengths",
          "widths", "valid")


@pytest.fixture(scope="module")
def onnx_path(tmp_path_factory):
    return write_synthetic_walenet_onnx(
        str(tmp_path_factory.mktemp("walenet") / "synthetic.onnx"), seed=2, **WIDTHS)


@pytest.fixture
def nets(onnx_path, monkeypatch):
    """Both modules on the synthetic export, the JAX raster on its NumPy
    route, every cache cleared before and after."""
    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(jw, "WALENET_ONNX_PATH", onnx_path)
    monkeypatch.setattr(tw, "WALENET_ONNX_PATH", onnx_path)
    caches = (jw._WALENET_CACHE, jw.WaleNet._jit_cache, tw._WALENET_CACHE,
              tw.WaleNet._net_cache)
    for c in caches:
        c.clear()
    yield
    for c in caches:
        c.clear()


CASES = [("convoy", 40), ("overtake", 12), ("intersection_crossing", 30)]


def _ids(scenario):
    return [ob.obstacle_id for ob in scenario.dynamic_obstacles]


@pytest.mark.parametrize("family,t", CASES)
def test_preprocessing_equals_jax_numpy_route(nets, family, t):
    js, ts = (getattr(f, f"make_{family}")() for f in (jfactory, tfactory))
    jnet, tnet = jw.WaleNet(js), tw.WaleNet(ts, device=CPU)
    assert tnet._boundaries and len(tnet._boundaries) == len(jnet._boundaries)
    for (ta, tv), (ja, jv) in zip(tnet._boundaries, jnet._boundaries):
        np.testing.assert_array_equal(ta, ja)
        assert tv == jv
    ids = _ids(ts)
    # past the end of the recordings no obstacle has a state: zero rows
    end = max(s.time_step for ob in ts.dynamic_obstacles for s in ob.trajectory) + 3
    for step in (0, t, end):
        want = jnet._preprocess(ids, step)
        got = tnet._preprocess(ids, step)
        for name, a, b in zip(("hist", "nbrs", "sc_img"), got[:3], want[:3]):
            assert a.dtype == b.dtype == np.float32, name
            np.testing.assert_array_equal(a, b, err_msg=f"{name} t={step}")
        assert got[2].any() == (step != end)
        assert set(np.unique(got[2])) <= {0.0, 127.0, 255.0}
        for (tt, tr), (jt, jr) in zip(got[3], want[3]):
            np.testing.assert_array_equal(tt, jt)
            assert tr == jr
    # the raster alone at a pose off the lanes' vertices
    ob = ts.dynamic_obstacles[0].state_at_time(t)
    pos, rot = np.asarray(ob.position, float) + [1.3, -0.7], ob.orientation - 0.2
    np.testing.assert_array_equal(tnet._render_scene(pos, rot),
                                  jnet._render_scene(pos, rot))


@pytest.mark.parametrize("family,t", CASES[:2])
def test_predict_matches_jax_within_float32(nets, family, t):
    js, ts = (getattr(f, f"make_{family}")() for f in (jfactory, tfactory))
    ids = _ids(ts)
    want = jw.WaleNet(js).predict(ids, t)
    got = tw.WaleNet(ts, device=CPU).predict(ids, t)
    assert list(got) == list(want) == ids
    for oid in ids:
        (tp, tc), (jp, jc) = got[oid], want[oid]
        assert tp.shape == (40, 2) and tc.shape == (40, 2, 2)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
        np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-9)
        assert np.all(np.linalg.eigvalsh(tc) > 0)
    assert tw.WaleNet(ts, device=CPU).predict([], t) == {}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_walenet_predictions_match_jax_within_float32(nets, dtype):
    js, ts = jfactory.make_convoy(), tfactory.make_convoy()
    ids = _ids(ts)
    want = jw.walenet_predictions(js, ids, 35, 30, max_obstacles=9, dtype=dtype)
    got = tw.walenet_predictions(ts, ids, 35, 30, max_obstacles=9, dtype=dtype,
                                 device=CPU)
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape, f
    for f in ("valid", "lengths", "widths"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert got["valid"][:len(ids)].all() and not got["valid"][len(ids):].any()
    np.testing.assert_allclose(got["means"], want["means"], rtol=0, atol=1e-4)
    for f in ("covs", "inv_covs", "velocities"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got["orientations"], want["orientations"], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("family,t", CASES)
def test_after_the_net_everything_is_bitwise_equal(nets, monkeypatch, dtype, family, t):
    """The JAX net's output injected into the port: every field bitwise."""
    js, ts = (getattr(f, f"make_{family}")() for f in (jfactory, tfactory))
    ids = _ids(ts)
    jnet = jw.WaleNet(js)
    calls = []

    def jax_net(self, hist, nbrs, sc):
        out = np.asarray(jnet._predict(hist, nbrs, sc))
        calls.append(out.shape)
        return out

    monkeypatch.setattr(tw.WaleNet, "_run_net", jax_net)
    want = jw.walenet_predictions(js, ids, t, 30, max_obstacles=8, dtype=dtype)
    got = tw.walenet_predictions(ts, ids, t, 30, max_obstacles=8, dtype=dtype,
                                 device=CPU)
    assert calls and calls[0][0] == 40
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_the_net_runs_in_float32_on_the_given_device(nets):
    ts = tfactory.make_convoy()
    net = tw.WaleNet(ts, device=CPU)
    hist, nbrs, sc, _ = net._preprocess(_ids(ts), 20)
    out = net._run_net(hist, nbrs, sc)
    assert out.dtype == np.float32 and out.shape == (40, len(_ids(ts)), 5)
    assert all(t.dtype == torch.float32 and t.device == CPU
               for t in net._net.init.values() if isinstance(t, torch.Tensor))
    # f64 predictions still come from the float32 net: one interpreter per
    # (export, device), one cached scenario
    tw.walenet_predictions(ts, _ids(ts), 20, 30, dtype=np.float64, device=CPU)
    tw.walenet_predictions(ts, _ids(ts), 21, 30, dtype=np.float32, device=CPU)
    assert len(tw.WaleNet._net_cache) == 1 and len(tw._WALENET_CACHE) == 1
    tw.walenet_predictions(tfactory.make_highway(), [100], 5, 30, device=CPU)
    assert len(tw.WaleNet._net_cache) == 1 and len(tw._WALENET_CACHE) == 1


def test_a_missing_export_raises_and_nothing_stands_in(nets, monkeypatch, tmp_path):
    monkeypatch.setattr(tw, "WALENET_ONNX_PATH", str(tmp_path / "absent.onnx"))
    with pytest.raises(FileNotFoundError):
        tw.walenet_predictions(tfactory.make_convoy(), [100], 10, 30, device=CPU)
    (tmp_path / "broken.onnx").write_bytes(b"\x08\x07")
    with pytest.raises(ValueError, match="no graph"):
        tw.WaleNet(tfactory.make_convoy(), onnx_path=str(tmp_path / "broken.onnx"),
                   device=CPU)
    assert not tw._WALENET_CACHE


def test_the_net_defaults_to_the_card(nets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tw.WaleNet(tfactory.make_convoy())
    with pytest.raises(RuntimeError, match="CUDA device"):
        tw.walenet_predictions(tfactory.make_convoy(), [100], 10, 30)
