"""The port's sensing and occlusion stack against the JAX package, float64 on
the CPU.

- `sim/visible_area.py`: boundary segments, box segments, the polar ray cast
  in NumPy and its torch twin, the VisibleArea queries and
  `compute_visible_area`; `sensor_model.visible_obstacles` with the occlusion
  stage.  Visible ids and masks equal, ranges within rtol 1e-10; the torch
  twin agrees with the NumPy version within rtol 1e-12.
- `occlusion/occlusion_module.py`: thresholds and their typo guard,
  `phantom_safety_mask` with each of the eight metrics alone, all together
  and none, `external_occlusion_costs` per term, both with a leading agent
  axis equal to the per-agent call; the OcclusionModule's spawn points,
  phantom rows, polar map (cache, excluded ids, live occluders) and
  silhouette points.
- One `ReactivePlanner.plan` cycle with the module on and occ_um / occ_ve
  weighted selects the JAX planner's candidate at its cost.
- `batched_full_cycle(occlusion=True, ...)` with geometry against the JAX one
  on the stacked problem (A = 4); the gate rejects every candidate of one
  agent, whose `found` comes back False.  The JAX keywords `harm_threshold`
  and `risk_threshold` against the JAX cycle; their defaults give the
  default gate bitwise.
- The blind-spot scenario (a parked truck beside the lane) with the module
  on and `calc_occlusions`: sequential against JAX, batched against
  sequential, positions within 1e-9 m, visible ids per step equal to JAX.
- The ValueError for an `occ_*` weight without the module.

Where the JAX functions would reach the Pallas kernel on a TPU they run its
plain route here, as the JAX package's own tests do on the CPU.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu_torch import occlusion as tocc
from frenetix_tpu_torch.io import commonroad as tcr
from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.parallel import mesh as tmesh
from frenetix_tpu_torch.planner.core import context_from_numpy
from frenetix_tpu_torch.sim import sensor_model as tsensor
from frenetix_tpu_torch.sim import visible_area as tva
from frenetix_tpu_torch.sim.agent import EgoState
from frenetix_tpu_torch.sim.prediction import to_device
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils import config as tconfig
from tests.torch_parity import (
    CPU, Arrays, agent_states, coarse_sampling, jnp_array, random_risks, t64, to_np,
)

torch.set_num_threads(1)

RTOL = 1e-10


# ------------------------------------------------------------ visible area


@pytest.mark.parametrize("family", ["highway", "lane_change", "intersection_crossing",
                                    "turn_left"])
def test_road_boundary_segments_match_jax(family):
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.sim.visible_area import road_boundary_segments as jfn

    want = jfn(getattr(jfactory, f"make_{family}")())
    tsc = getattr(tfactory, f"make_{family}")()
    got = tva.road_boundary_segments(tsc)
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0 and tva.road_boundary_segments(tsc) is got     # cached


def test_obstacle_obb_segments_match_jax():
    from frenetix_tpu.sim.visible_area import obstacle_obb_segments as jfn

    rng = np.random.default_rng(0)
    for _ in range(5):
        pos, th = rng.normal(size=2) * 20.0, rng.uniform(-3.0, 3.0)
        np.testing.assert_array_equal(tva.obstacle_obb_segments(pos, th, 4.5, 1.8),
                                      jfn(pos, th, 4.5, 1.8))


def _segments(rng, n, spread=40.0):
    """Random short segments around the origin, some far outside any sensor
    radius, one vertical and one horizontal through the ego's axes (rays
    parallel to them divide by zero)."""
    a = rng.normal(size=(n, 2)) * spread
    segs = np.stack([a, a + rng.normal(size=(n, 2)) * 6.0], axis=1)
    segs[0] = [[10.0, -5.0], [10.0, 5.0]]
    segs[1] = [[-4.0, 7.0], [6.0, 7.0]]
    segs[2] = [[300.0, 300.0], [310.0, 305.0]]
    return segs


@pytest.mark.parametrize("n_seg,n_rays,radius", [(3, 720, 50.0), (40, 720, 50.0),
                                                 (200, 90, 25.0), (0, 360, 30.0)])
def test_polar_visibility_matches_jax_and_its_torch_twin(n_seg, n_rays, radius):
    import jax.numpy as jnp
    from frenetix_tpu.sim import visible_area as jva

    rng = np.random.default_rng(n_seg)
    segs = _segments(rng, n_seg) if n_seg else np.zeros((0, 2, 2))
    ego = np.array([0.5, -0.25])
    phi_j, r_j = jva.polar_visibility(ego, segs, radius, n_rays)
    phi, r = tva.polar_visibility(ego, segs, radius, n_rays)
    np.testing.assert_array_equal(phi, phi_j)
    np.testing.assert_array_equal(r, r_j)
    if n_seg:
        assert (r < radius).any() and (r == radius).any()

    valid = np.ones(len(segs), bool)
    twin = tva.polar_visibility_batch(t64(ego), t64(segs[:, 0]), t64(segs[:, 1]),
                                      torch.as_tensor(valid), radius, n_rays)
    # the mask replaces the cull; the last bit follows the library's sin / cos
    np.testing.assert_allclose(to_np(twin), r, rtol=1e-12)
    if n_seg:
        r_jb = jva.polar_visibility_batch(jnp.asarray(ego), jnp.asarray(segs[:, 0]),
                                          jnp.asarray(segs[:, 1]), jnp.asarray(valid),
                                          radius, n_rays)
        np.testing.assert_allclose(to_np(twin), np.asarray(r_jb), rtol=RTOL)
        # masked segments do not occlude
        valid[::2] = False
        masked = tva.polar_visibility_batch(t64(ego), t64(segs[:, 0]), t64(segs[:, 1]),
                                            torch.as_tensor(valid), radius, n_rays)
        _, r_kept = tva.polar_visibility(ego, segs[valid], radius, n_rays)
        np.testing.assert_allclose(to_np(masked), r_kept, rtol=1e-12)


def test_obb_segments_batch_matches_host_and_jax():
    import jax.numpy as jnp
    from frenetix_tpu.sim.visible_area import obb_segments_batch as jfn

    rng = np.random.default_rng(1)
    centers, thetas = rng.normal(size=(6, 2)) * 30.0, rng.uniform(-3.0, 3.0, 6)
    got = tva.obb_segments_batch(t64(centers), t64(thetas), (2.25, 0.9))
    assert got.shape == (6, 4, 2, 2)
    np.testing.assert_allclose(
        to_np(got), np.asarray(jfn(jnp.asarray(centers), jnp.asarray(thetas),
                                   (2.25, 0.9))), rtol=RTOL, atol=1e-12)
    for k in range(6):
        np.testing.assert_allclose(
            to_np(got[k]), tva.obstacle_obb_segments(centers[k], thetas[k], 4.5, 1.8),
            rtol=1e-12, atol=1e-12)
    per = tva.obb_segments_batch(t64(centers), t64(thetas),
                                 t64(np.tile([2.25, 0.9], (6, 1))))
    assert torch.equal(per, got)


def test_visible_area_queries_match_jax():
    from frenetix_tpu.sim import visible_area as jva

    rng = np.random.default_rng(2)
    segs = _segments(rng, 30)
    phi, r = tva.polar_visibility([0.0, 0.0], segs, 50.0, 720)
    ja, ta = jva.VisibleArea([0.0, 0.0], phi, r), tva.VisibleArea([0.0, 0.0], phi, r)
    ang = rng.uniform(-np.pi, np.pi, 500)
    ang[:4] = [-np.pi, np.pi - 1e-12, (0.5 / 720) * 2 * np.pi - np.pi, 0.0]  # ray ties
    np.testing.assert_array_equal(ta.r_at(ang), ja.r_at(ang))
    pts = rng.normal(size=(500, 2)) * 30.0
    np.testing.assert_array_equal(ta.points_visible(pts), ja.points_visible(pts))
    for _ in range(10):
        pos, th = rng.normal(size=2) * 25.0, rng.uniform(-3.0, 3.0)
        assert (ta.obstacle_visible(pos, th, 4.5, 1.8)
                == ja.obstacle_visible(pos, th, 4.5, 1.8))
    np.testing.assert_array_equal(ta.polygon(), ja.polygon())


def _sensor_scene(factory, commonroad):
    """The highway with the lead removed, a blocker 20 m and a target 40 m
    ahead on one ray, and a car in the neighbouring field (off the road)."""
    sc = factory.make_highway()
    del sc.obstacles[100]
    for oid, pos in ((300, [20.0, 0.0]), (301, [40.0, 0.0]), (302, [30.0, 9.0])):
        sc.obstacles[oid] = commonroad.Obstacle(
            obstacle_id=oid, obstacle_type="car", role="static", length=4.5,
            width=2.0, initial_state=commonroad.State(0, np.array(pos), 0.0, 0.0))
    return sc


class _Ego:
    position = np.array([0.0, 0.0])
    orientation = 0.0
    velocity = 10.0


@pytest.mark.parametrize("kw", [
    dict(occlusions=True, cone_filter=False),
    dict(occlusions=False),
    dict(occlusions=True, agent_ids=(300,)),
    dict(occlusions=True, agent_ids=(300,),
         extra_occluders=[(np.array([18.0, 0.0]), 0.0, 4.5, 2.0)]),
    dict(occlusions=True, road_segments=np.zeros((0, 2, 2))),
], ids=["occluded", "no-occlusion", "blocker-is-agent", "live-blocker", "no-walls"])
def test_visible_obstacles_match_jax(kw):
    from frenetix_tpu.io import commonroad as jcr, scenario_factory as jfactory
    from frenetix_tpu.sim.sensor_model import visible_obstacles as jfn

    jsc, tsc = _sensor_scene(jfactory, jcr), _sensor_scene(tfactory, tcr)
    want, jarea = jfn(jsc, 60000, _Ego(), 0, sensor_radius=60.0, return_area=True, **kw)
    got, area = tsensor.visible_obstacles(tsc, 60000, _Ego(), 0, sensor_radius=60.0,
                                          return_area=True, **kw)
    assert got == want
    if kw["occlusions"]:
        np.testing.assert_array_equal(area.r_vis, jarea.r_vis)
        if "agent_ids" not in kw or "extra_occluders" in kw:
            assert 301 not in got              # shadowed by the blocker
        else:
            assert 301 in got                  # the stale blocker casts no shadow
        if "road_segments" in kw:
            assert 302 in got                  # no wall hides the field
        else:
            assert 302 not in got
    else:
        assert area is None and jarea is None and {300, 301, 302} <= set(got)


def test_compute_visible_area_matches_jax():
    from frenetix_tpu.io import commonroad as jcr, scenario_factory as jfactory
    from frenetix_tpu.sim.visible_area import compute_visible_area as jfn

    jsc, tsc = _sensor_scene(jfactory, jcr), _sensor_scene(tfactory, tcr)
    extra = [(np.array([-15.0, 0.5]), 0.1, 4.5, 2.0), (np.array([500.0, 0.0]), 0.0, 4.5, 2.0)]
    for kw in (dict(), dict(include_obstacles=False), dict(extra_occluders=extra),
               dict(n_rays=90, agent_ids=(301,))):
        want = jfn(jsc, 60000, [5.0, 0.2], 0, 45.0, **kw)
        got = tva.compute_visible_area(tsc, 60000, [5.0, 0.2], 0, 45.0, **kw)
        np.testing.assert_array_equal(got.r_vis, want.r_vis)
        np.testing.assert_array_equal(got.phi, want.phi)


# -------------------------------------------------- thresholds and the gate


def test_thresholds_from_config_and_typo_guard():
    from frenetix_tpu.occlusion import PhantomThresholds as JThr
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig

    assert tocc.PhantomThresholds._fields == JThr._fields
    assert tuple(tocc.PhantomThresholds()) == tuple(JThr())
    for thresholds in ({}, {"dce": 2.0, "harm": None}, {"ttc": 1, "be": 6.5}):
        jcfg, tcfg = JaxConfig(), tconfig.FrenetixConfig()
        jcfg.occlusion.metric_thresholds = dict(thresholds)
        tcfg.occlusion.metric_thresholds = dict(thresholds)
        tcfg.occlusion.harm_threshold = jcfg.occlusion.harm_threshold = 0.03
        assert (tuple(tocc.PhantomThresholds.from_config(tcfg.occlusion))
                == tuple(JThr.from_config(jcfg.occlusion)))
    tcfg.occlusion.metric_thresholds = {"dcee": 2.0}
    with pytest.raises(ValueError, match="dcee"):
        tocc.PhantomThresholds.from_config(tcfg.occlusion)
    for bad in ({"occlusion": {"metric_thresholds": {"dcee": 2.0}}},
                {"external_cost_weights": {"occ_pmm": 1.0}}):
        with pytest.raises(ValueError, match="unknown"):
            tconfig.load_config(overrides=bad, strict_overrides=True)
    assert tocc.PHANTOM_TYPES == __import__(
        "frenetix_tpu.occlusion.occlusion_module", fromlist=["x"]).PHANTOM_TYPES


def test_external_cost_weights_load_from_cost_yaml(tmp_path):
    (tmp_path / "cost.yaml").write_text(
        "cost_weights:\n  prediction: 0.7\nexternal_cost_weights:\n  occ_pm: 1.5\n")
    cfg = tconfig.load_config(str(tmp_path))
    assert cfg.cost_weights["prediction"] == 0.7
    assert cfg.external_cost_weights == {"occ_pm": 1.5, "occ_um": 0.0, "occ_ve": 0.0}


def _gate_inputs(rng, m=48, o=5, n=12, lead=()):
    """Candidates driving +x past phantoms placed along their way; obstacle
    rows 1, 2 and 4 are phantoms, row 0 is a REAL obstacle on the path (it
    must never gate)."""
    shape = tuple(lead)
    t = np.arange(n + 1) * 0.1
    v = rng.uniform(4.0, 14.0, shape + (m, 1))
    x = v * t
    y = rng.uniform(-6.0, 6.0, shape + (m, 1)) + 0.0 * t
    means = np.zeros(shape + (o, n, 2))
    means[..., 0] = rng.uniform(3.0, 14.0, shape + (o, 1))
    means[..., 1] = rng.uniform(-4.0, 4.0, shape + (o, 1))
    means[..., 0, :, :] = [6.0, 0.0]
    ro = dict(x=x, y=y, v=np.broadcast_to(v, x.shape).copy())
    preds = dict(means=means, lengths=rng.uniform(0.3, 4.5, shape + (o,)),
                 widths=rng.uniform(0.5, 2.0, shape + (o,)))
    pm = np.zeros(shape + (o,), bool)
    pm[..., [1, 2, 4]] = True
    return ro, preds, pm


class _Veh:
    length, width = 4.508, 1.61


ALL_METRICS = dict(harm=0.9, risk=2.0, cp=0.9, ttc=0.45, wttc=0.35, ttce=0.35, dce=1.5,
                   be=120.0)


@pytest.mark.parametrize("metric", list(ALL_METRICS) + ["all", "none"])
def test_phantom_safety_mask_matches_jax(metric):
    from frenetix_tpu.occlusion import PhantomThresholds as JThr, phantom_safety_mask as jfn

    rng = np.random.default_rng(5)
    ro, preds, pm = _gate_inputs(rng)
    jr, tr = random_risks(rng, 48, 5)
    active = dict(harm=None, risk=None)
    if metric == "all":
        active = dict(ALL_METRICS)
    elif metric != "none":
        active[metric] = ALL_METRICS[metric]
    want = np.asarray(jfn(jr, pm, JThr(**active), rollout=Arrays(jnp_array, **ro),
                          preds=Arrays(jnp_array, **preds), veh=_Veh, dt=0.1))
    got = tocc.phantom_safety_mask(
        tr, pm, tocc.PhantomThresholds(**active), rollout=Arrays(t64, **ro),
        preds=Arrays(t64, **preds), veh=_Veh, dt=0.1)
    assert got.dtype == torch.bool and got.shape == (48,)
    np.testing.assert_array_equal(to_np(got), want)
    if metric == "none":
        assert want.all()
    else:
        assert 0 < want.sum() < 48, f"{metric} does not discriminate: {want.sum()}"


def test_phantom_safety_mask_with_agent_axis_equals_per_agent():
    rng = np.random.default_rng(6)
    ro, preds, pm = _gate_inputs(rng, lead=(3,))
    _, tr = random_risks(rng, 48, 5, lead=(3,))
    thr = tocc.PhantomThresholds(**ALL_METRICS)
    got = tocc.phantom_safety_mask(tr, pm, thr, rollout=Arrays(t64, **ro),
                                   preds=Arrays(t64, **preds), veh=_Veh, dt=0.1)
    assert got.shape == (3, 48)
    for a in range(3):
        one = tocc.phantom_safety_mask(
            type(tr)(*(f[a] for f in tr)), pm[a], thr,
            rollout=Arrays(t64, **{k: v[a] for k, v in ro.items()}),
            preds=Arrays(t64, **{k: v[a] for k, v in preds.items()}), veh=_Veh, dt=0.1)
        assert torch.equal(got[a], one)
    assert 0 < int(got.sum()) < got.numel()


def test_closest_encounter_takes_the_first_minimum():
    """A phantom the candidate passes at equal distance twice: the time of the
    closest encounter is the first of the two."""
    x = np.array([[0.0, 1.0, 2.0, 3.0, 4.0]])
    ro = Arrays(t64, x=x, y=np.zeros_like(x), v=np.ones_like(x))
    preds = Arrays(t64, means=np.tile([2.5, 0.0], (1, 4, 1)), lengths=np.array([0.4]),
                   widths=np.array([0.4]))
    _, tr = random_risks(np.random.default_rng(0), 1, 1)
    pm = np.array([True])

    def gate(ttce):
        thr = tocc.PhantomThresholds(harm=None, risk=None, ttce=ttce)
        return bool(tocc.phantom_safety_mask(tr, pm, thr, rollout=ro, preds=preds,
                                             veh=_Veh, dt=0.1)[0])

    assert gate(0.2) and not gate(0.25)       # steps 2 and 3 tie: t = 0.2 counts


# --------------------------------------------------------- the soft costs


def _soft_inputs(rng, m=40, n=15, lead=(), k=720, q=4):
    shape = tuple(lead)
    x = np.cumsum(rng.uniform(0.3, 2.0, shape + (m, n + 1)), axis=-1)
    y = rng.normal(size=shape + (m, n + 1)) * 2.0
    return dict(
        ro=dict(x=x, y=y),
        ego=rng.normal(size=shape + (2,)),
        r_vis=rng.uniform(4.0, 30.0, shape + (k,)),
        pts=rng.normal(size=shape + (q, 2)) * 8.0 + [12.0, 0.0],
        valid=np.broadcast_to(np.arange(q) % 3 != 2, shape + (q,)).copy(),
        pm=np.broadcast_to(np.arange(5) % 2 == 1, shape + (5,)).copy(),
    )


@pytest.mark.parametrize("w", [(1.5, 0.0, 0.0), (0.0, 2.0, 0.0), (0.0, 0.0, 0.5),
                               (0.7, 2.0, 0.5)], ids=["pm", "um", "ve", "all"])
def test_external_occlusion_costs_match_jax(w):
    from frenetix_tpu.occlusion import external_occlusion_costs as jfn

    rng = np.random.default_rng(7)
    s = _soft_inputs(rng)
    jr, tr = random_risks(rng, 40, 5)
    w_pm, w_um, w_ve = w
    want = np.asarray(jfn(
        Arrays(jnp_array, **s["ro"]), w_pm=w_pm, w_um=w_um, w_ve=w_ve, risks=jr,
        phantom_mask=s["pm"], ego=jnp_array(s["ego"]), r_vis=jnp_array(s["r_vis"]),
        occluder_pts=jnp_array(s["pts"]), occluder_valid=jnp_array(s["valid"])))
    got = tocc.external_occlusion_costs(
        Arrays(t64, **s["ro"]), w_pm=w_pm, w_um=w_um, w_ve=w_ve, risks=tr,
        phantom_mask=s["pm"], ego=s["ego"], r_vis=s["r_vis"], occluder_pts=s["pts"],
        occluder_valid=s["valid"])
    assert got.dtype == torch.float64 and got.shape == (40,)
    np.testing.assert_allclose(to_np(got), want, rtol=RTOL, atol=1e-300)
    assert want.max() > 0.0 and len(np.unique(want)) > 20


def test_external_occlusion_costs_with_agent_axis_equal_per_agent():
    rng = np.random.default_rng(8)
    s = _soft_inputs(rng, lead=(3,))
    _, tr = random_risks(rng, 40, 5, lead=(3,))
    kw = dict(w_pm=0.7, w_um=2.0, w_ve=0.5)
    got = tocc.external_occlusion_costs(
        Arrays(t64, **s["ro"]), risks=tr, phantom_mask=s["pm"], ego=s["ego"],
        r_vis=s["r_vis"], occluder_pts=s["pts"], occluder_valid=s["valid"], **kw)
    assert got.shape == (3, 40)
    for a in range(3):
        one = tocc.external_occlusion_costs(
            Arrays(t64, **{k: v[a] for k, v in s["ro"].items()}),
            risks=type(tr)(*(f[a] for f in tr)), phantom_mask=s["pm"][a],
            ego=s["ego"][a], r_vis=s["r_vis"][a], occluder_pts=s["pts"][a],
            occluder_valid=s["valid"][a], **kw)
        np.testing.assert_array_equal(to_np(got[a]), to_np(one))


def test_nearest_ray_lookup_rounds_half_to_even():
    """A point exactly between two rays takes the even one, as np.round does;
    the last half-ray wraps to ray 0."""
    k = 8
    r_vis = np.arange(k, dtype=float) + 1.0
    for ray in (0.5, 1.5, 2.5, 7.5):
        ang = ray / k * 2 * np.pi - np.pi
        pt = 100.0 * np.array([np.cos(ang), np.sin(ang)])
        ro = Arrays(t64, x=np.array([[0.0, pt[0]]]), y=np.array([[0.0, pt[1]]]))
        got = float(tocc.external_occlusion_costs(ro, w_um=1.0, ego=np.zeros(2),
                                                  r_vis=r_vis)[0])
        idx = int(np.round((np.arctan2(pt[1], pt[0]) + np.pi) / (2 * np.pi) * k)) % k
        np.testing.assert_allclose(got, 100.0 - r_vis[idx], rtol=1e-12)


def test_soft_costs_need_the_ego_position():
    ro = Arrays(t64, x=np.zeros((2, 5)), y=np.zeros((2, 5)))
    with pytest.raises(ValueError, match="ego"):
        tocc.external_occlusion_costs(ro, w_um=1.0, r_vis=np.full(720, 10.0))


# ------------------------------------------------------ the module (NumPy)


def _module_scene(commonroad):
    truck = commonroad.Obstacle(
        obstacle_id=9, obstacle_type="truck", role="static", length=9.0, width=2.5,
        initial_state=commonroad.State(0, np.array([20.0, 3.5]), 0.0, 0.0))
    car = commonroad.Obstacle(
        obstacle_id=10, obstacle_type="car", role="dynamic", length=4.5, width=2.0,
        initial_state=commonroad.State(0, np.array([30.0, -3.5]), 0.0, 5.0))
    far = commonroad.Obstacle(
        obstacle_id=11, obstacle_type="car", role="static", length=4.5, width=2.0,
        initial_state=commonroad.State(0, np.array([90.0, 0.0]), 0.0, 0.0))
    return commonroad.Scenario("occ", 0.1, {}, {9: truck, 10: car, 11: far}, {})


_ARC = np.stack([20.0 * np.sin(np.linspace(0, np.pi / 2, 50)),
                 20.0 * (1 - np.cos(np.linspace(0, np.pi / 2, 50)))], axis=1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(spawn_point_behind_static_obstacle=False, max_phantoms=8),
    dict(spawn_point_behind_dynamic_obstacle=False, max_phantoms=8),
    dict(max_dynamic_spawn_points=1, max_static_spawn_points=1, max_phantoms=8),
    dict(spawn_points_behind_turn=True, route_xy=_ARC, max_phantoms=8),
    dict(phantom_type="bicycle", variance_factor=1.3, size_factor_length=1.0),
], ids=["default", "dynamic-only", "static-only", "capped", "behind-turn", "bicycle"])
def test_occlusion_module_matches_jax(kw):
    from frenetix_tpu.io import commonroad as jcr
    from frenetix_tpu.occlusion import OcclusionModule as JModule

    jmod = JModule(_module_scene(jcr), **kw)
    tmod = tocc.OcclusionModule(_module_scene(tcr), **kw)
    assert tmod.thresholds == tuple(jmod.thresholds)
    jspecs, tspecs = jmod.find_spawn_points(_Ego(), 0), tmod.find_spawn_points(_Ego(), 0)
    assert len(tspecs) == len(jspecs) >= 1
    for js, ts in zip(jspecs, tspecs):
        np.testing.assert_array_equal(ts.position, js.position)
        assert ts.heading == js.heading and ts.agent_type == js.agent_type
    jrows = jmod.phantom_prediction_rows(jspecs, 30, 0.1, np.float64)
    trows = tmod.phantom_prediction_rows(tspecs, 30, 0.1, np.float64)
    for key in jrows:
        np.testing.assert_array_equal(trows[key], jrows[key], err_msg=key)

    def blank():
        return dict(means=np.zeros((6, 30, 2)), covs=np.zeros((6, 30, 2, 2)),
                    inv_covs=np.zeros((6, 30, 2, 2)), orientations=np.zeros((6, 30)),
                    velocities=np.zeros((6, 30)), lengths=np.ones(6), widths=np.ones(6),
                    valid=np.arange(6)[:, None].repeat(30, 1) < 3)

    (jpd, jn), (tpd, tn) = (jmod.augment_predictions(blank(), _Ego(), 0, 0.1),
                            tmod.augment_predictions(blank(), _Ego(), 0, 0.1))
    assert tn == jn == min(3, len(jspecs))
    for key in jpd:
        np.testing.assert_array_equal(tpd[key], jpd[key], err_msg=key)
    for (jp, jv), (tp, tv) in ((jmod.occluder_points(), tmod.occluder_points()),):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tv, jv)


def test_polar_map_matches_jax_excludes_agents_and_caches():
    from frenetix_tpu.io import commonroad as jcr
    from frenetix_tpu.occlusion import OcclusionModule as JModule

    jmod, tmod = JModule(_module_scene(jcr)), tocc.OcclusionModule(_module_scene(tcr))
    live = [(np.array([15.0, 0.0]), 0.0, 4.5, 2.0), (np.array([400.0, 0.0]), 0.0, 4.5, 2.0)]
    for step, exclude, extras in ((0, frozenset(), ()), (1, frozenset({9}), ()),
                                  (2, frozenset({9, 10}), tuple(live))):
        for mod in (jmod, tmod):
            mod.occluder_exclude, mod.extra_occluders = exclude, extras
        (jr, jego), (tr, tego) = jmod.polar_map(_Ego(), step), tmod.polar_map(_Ego(), step)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tego, jego)
    k0 = len(tr) // 2                      # the ray straight ahead
    assert tr[k0] < 14.0                   # the live vehicle clips it
    tmod.extra_occluders = ()
    assert tmod.polar_map(_Ego(), 2)[0][k0] < 14.0     # cached for this step
    assert tmod.polar_map(_Ego(), 3)[0][k0] == 50.0    # a new step: recomputed


# ---------------------------------------------------- planner and the batch


def _blind_spot(factory, commonroad):
    """A parked truck beside the lane creates a blind spot."""
    sc = factory.make_highway(ego_v=13.0, lead_v=13.0, lead_gap=120.0, n_steps=150)
    sc.obstacles[200] = commonroad.Obstacle(
        obstacle_id=200, obstacle_type="truck", role="static", length=9.0, width=2.5,
        initial_state=commonroad.State(0, np.array([60.0, 2.6]), 0.0, 0.0))
    return sc


def _occlusion_config(make, **sim):
    cfg = make(dtype="float64")
    cfg.occlusion.use_occlusion_module = True
    cfg.occlusion.harm_threshold = 0.02
    cfg.external_cost_weights["occ_um"] = 2.0
    cfg.external_cost_weights["occ_ve"] = 0.5
    cfg.prediction.calc_occlusions = True
    # small tensors: the risk stack on one CPU thread is slow
    cfg.prediction.max_obstacles = 4
    cfg.debug.matrix_bucket = 64
    for k, v in sim.items():
        setattr(cfg.simulation, k, v)
    return cfg


def test_planner_cycle_with_occlusion_module_matches_jax():
    """One replanning cycle 28 m before the truck: the gate removes the
    planner's first choice, and the port selects the JAX planner's
    candidate at its selection cost (soft terms included)."""
    import jax.numpy as jnp
    from frenetix_tpu.io import commonroad as jcr, scenario_factory as jfactory
    from frenetix_tpu.sim.agent import EgoState as JEgoState
    from frenetix_tpu.sim.prediction import to_device as jto_device
    from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig

    jsim = JaxSimulation(_blind_spot(jfactory, jcr), _occlusion_config(JaxConfig))
    tsim = Simulation(_blind_spot(tfactory, tcr),
                      _occlusion_config(tconfig.FrenetixConfig), CPU)
    ja, ta = jsim.agents[0], tsim.agents[0]
    pose = dict(time_step=0, position=np.array([32.0, 0.0]), orientation=0.0,
                velocity=13.0)
    ja.state, ta.state = JEgoState(**pose), EgoState(**pose)
    jpd, jids = jsim._predictions_for_step(0)
    tpd, tids = tsim._predictions_for_step(0)
    jp, jmask = jsim._agent_predictions(jpd, jids, ja)
    tp, tmask = tsim._agent_predictions(tpd, tids, ta)
    np.testing.assert_array_equal(tmask, jmask)
    assert tmask.sum() >= 1
    for key in jp:
        np.testing.assert_array_equal(tp[key], jp[key], err_msg=key)
    ja.interface.update_planner(jto_device(jp, jnp), jp["means"][:, 0],
                                jp["valid"][:, 0])
    jplan = ja.interface.step_interface()
    ta.update_planner(to_device(tp, CPU, torch.float64), tp["means"][:, 0],
                      tp["valid"][:, 0])
    tplan = ta.planner.plan(ta._rear_axle_state(), ta.ensure_x_cl())
    assert tplan.mode == jplan.mode == "optimal"
    np.testing.assert_array_equal(tplan.sampling_parameters, jplan.sampling_parameters)
    np.testing.assert_allclose(tplan.cost, jplan.cost, rtol=RTOL)
    np.testing.assert_allclose(tplan.x, jplan.x, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tplan.v, jplan.v, rtol=1e-9, atol=1e-9)
    stats = ta.planner.gate_stats
    assert stats["levels"] == 1 and stats["rejected_all"] == 0
    # the soft terms are part of the selection cost
    plain = float(np.dot(to_np(ta.planner.weights), tplan.cost_terms))
    assert tplan.cost - plain > 1e-6


A, DT, N = 4, 0.1, 30


def _gated_problem():
    """The JAX tests' stacked problem (every third candidate) with obstacle 0
    of every agent turned into a phantom next to the candidates' end points;
    agent 2's phantom stands 2.8 m beside the start of its path: no candidate
    collides with it, every candidate passes within the dce threshold."""
    import bench_scaling

    matrices, masks, jctx = bench_scaling.build_stacked_problem(
        A, dtype=np.float64, n_steps=N, spread=12.0)
    matrices, masks = matrices[:, ::3], masks[:, ::3]
    means = np.asarray(jctx.preds.means).copy()
    for i in range(A):
        means[i, 0, :, 0] = 40.0 + 12.0 * i
        means[i, 0, :, 1] = 5.0
    ref_s, ref_xy = np.asarray(jctx.ref.s)[2], np.asarray(jctx.ref.xy)[2]
    ref_th = np.asarray(jctx.ref.theta)[2]
    k = int(np.argmin(np.abs(ref_s - 31.0)))        # 1 m past the start state
    means[2, 0] = ref_xy[k] + 2.8 * np.array([-np.sin(ref_th[k]), np.cos(ref_th[k])])
    jctx = jctx._replace(preds=jctx.preds._replace(means=jnp_array(means)),
                         obstacle_xy=jnp_array(means[:, :, 0]))
    o = means.shape[1]
    pm = np.zeros((A, o), bool)
    pm[:, 0] = True
    rng = np.random.default_rng(3)
    geom = (means[:, 1, 0] - [25.0, 3.0],                       # egos (A, 2)
            rng.uniform(8.0, 35.0, (A, 720)),                   # r_vis
            means[:, :2, 0] + rng.normal(size=(A, 2, 2)),       # pts (A, Q, 2)
            np.tile([True, False], (A, 1)))                     # pts_valid
    leaves = {f: getattr(jctx, f) for f in jctx._fields}
    leaves["ref"] = type(jctx.ref)(*(np.asarray(x) for x in jctx.ref))
    leaves["preds"] = {k: np.asarray(v) for k, v in jctx.preds._asdict().items()}
    tctx = context_from_numpy(**leaves, device=CPU, dtype=torch.float64)
    return matrices, masks, jctx, tctx, pm, geom


def test_batched_full_cycle_with_occlusion_matches_jax():
    from frenetix_tpu.occlusion import PhantomThresholds as JThr
    from frenetix_tpu.parallel.mesh import batched_full_cycle as jbatched

    matrices, masks, jctx, tctx, pm, geom = _gated_problem()
    thr = dict(harm=0.02, risk=1.0, dce=3.2)
    kw = dict(dt=DT, n_steps=N, occlusion=True, occ_pm_weight=0.5, occ_um_weight=2.0,
              occ_ve_weight=0.5)
    jout = jbatched(thresholds=JThr(**thr), **kw)(
        matrices, masks, jctx, jnp_array(pm), *(jnp_array(g) for g in geom))
    jout = {k: np.asarray(v) for k, v in jout.items()}
    tm, tk = t64(matrices), torch.as_tensor(np.array(masks))
    tout = tmesh.batched_full_cycle(thresholds=tocc.PhantomThresholds(**thr), **kw)(
        tm, tk, tctx, torch.as_tensor(pm), t64(geom[0]), t64(geom[1]), t64(geom[2]),
        torch.as_tensor(geom[3]))
    np.testing.assert_array_equal(to_np(tout["found"]), jout["found"])
    # the gate rejected every candidate of agent 2 and of no other agent;
    # its `best` falls back to the cycle's own
    assert jout["found"].tolist() == [True, True, False, True]
    np.testing.assert_array_equal(to_np(tout["best"]), jout["best"])
    plain = tmesh.batched_full_cycle(dt=DT, n_steps=N)(tm, tk, tctx)
    assert int(tout["best"][2]) == int(plain["best"][2]) and bool(plain["found"][2])
    keep = [0, 1, 3]
    for key in ("x", "y", "v", "cost", "terms"):
        np.testing.assert_allclose(to_np(tout[key])[keep], jout[key][keep], rtol=1e-9,
                                   atol=1e-10, err_msg=key)
    # the soft terms are in the selection cost
    assert (to_np(tout["cost"])[keep] > to_np(plain["cost"])[keep]).all()


def _on_path_phantom_problem():
    """The JAX tests' stacked problem (every 12th candidate) with obstacle 0
    of every agent turned into a phantom standing 0.5 m beside its path
    15–24 m ahead: every selectable candidate carries a phantom risk
    (harm × collision probability) of 5e-6 to 7e-4."""
    import bench_scaling

    matrices, masks, jctx = bench_scaling.build_stacked_problem(
        A, dtype=np.float64, n_steps=N, spread=12.0)
    matrices, masks = matrices[:, ::12], masks[:, ::12]
    means = np.asarray(jctx.preds.means).copy()
    for i in range(A):
        s, xy, th = (np.asarray(getattr(jctx.ref, f))[i] for f in ("s", "xy", "theta"))
        k = int(np.argmin(np.abs(s - (45.0 + 3 * i))))
        means[i, 0] = xy[k] + 0.5 * np.array([-np.sin(th[k]), np.cos(th[k])])
    jctx = jctx._replace(preds=jctx.preds._replace(means=jnp_array(means)),
                         obstacle_xy=jnp_array(means[:, :, 0]))
    pm = np.zeros((A, means.shape[1]), bool)
    pm[:, 0] = True
    leaves = {f: getattr(jctx, f) for f in jctx._fields}
    leaves["ref"] = type(jctx.ref)(*(np.asarray(x) for x in jctx.ref))
    leaves["preds"] = {k: np.asarray(v) for k, v in jctx.preds._asdict().items()}
    tctx = context_from_numpy(**leaves, device=CPU, dtype=torch.float64)
    return matrices, masks, jctx, (t64(matrices), torch.as_tensor(np.array(masks)), tctx,
                                   torch.as_tensor(pm)), pm


@pytest.mark.parametrize("keyword", ["harm_threshold", "risk_threshold"])
def test_batched_full_cycle_threshold_keywords_match_jax(keyword):
    """`batched_full_cycle(harm_threshold=, risk_threshold=)`, the JAX
    keywords: a gate stricter than the default on one of them rejects every
    candidate of agent 0, as in the JAX cycle."""
    from frenetix_tpu.parallel.mesh import batched_full_cycle as jbatched

    matrices, masks, jctx, targs, pm = _on_path_phantom_problem()
    kw = {"dt": DT, "n_steps": N, "occlusion": True, keyword: 1e-5}
    jout = {k: np.asarray(v) for k, v in
            jbatched(**kw)(matrices, masks, jctx, jnp_array(pm)).items()}
    tout = tmesh.batched_full_cycle(**kw)(*targs)
    assert jout["found"].tolist() == [False, True, True, True]
    np.testing.assert_array_equal(to_np(tout["found"]), jout["found"])
    np.testing.assert_array_equal(to_np(tout["best"]), jout["best"])
    for key in ("x", "y", "cost"):
        np.testing.assert_allclose(to_np(tout[key])[1:], jout[key][1:], rtol=1e-9,
                                   atol=1e-10, err_msg=key)


def test_batched_full_cycle_default_thresholds_are_the_default_gate():
    """The keyword defaults (harm 0.1, risk 1.0) give bitwise what the
    default PhantomThresholds gave, and let every agent through here."""
    targs = _on_path_phantom_problem()[3]
    got = tmesh.batched_full_cycle(dt=DT, n_steps=N, occlusion=True)(*targs)
    want = tmesh.batched_full_cycle(dt=DT, n_steps=N, occlusion=True,
                                    thresholds=tocc.PhantomThresholds())(*targs)
    assert bool(got["found"].all())
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_batched_stepper_needs_masks_and_geometry():
    from frenetix_tpu_torch.parallel.batched_sim import BatchedAgentStepper

    cfg = _occlusion_config(tconfig.FrenetixConfig, start_multiagent=True)
    sim = Simulation(_blind_spot(tfactory, tcr), cfg, CPU)
    stepper = BatchedAgentStepper(cfg, sim.agents, CPU)
    assert stepper.use_occlusion and stepper.use_occ_geom and stepper.resp_weight == 0.0
    args = (np.zeros((2, 64, 13)), np.zeros((2, 64), bool), None, np.zeros(2),
            np.zeros(2), cfg.vehicle, None)
    with pytest.raises(ValueError, match="phantom masks"):
        stepper.step(*args)
    with pytest.raises(ValueError, match="occluder geometry"):
        stepper.step(*args, phantom_masks=np.zeros((2, 4), bool))


# -------------------------------------------------------------- simulation


def test_external_weights_without_the_module_raise():
    from frenetix_tpu.io.scenario_factory import make_highway as jmake
    from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig

    for key in ("occ_pm", "occ_um", "occ_ve"):
        jcfg, tcfg = JaxConfig(), tconfig.FrenetixConfig()
        jcfg.external_cost_weights[key] = tcfg.external_cost_weights[key] = 1.0
        with pytest.raises(ValueError, match="use_occlusion_module"):
            JaxSimulation(jmake(), jcfg)
        with pytest.raises(ValueError, match="use_occlusion_module"):
            Simulation(tfactory.make_highway(), tcfg, CPU)


STEPS = 24


@pytest.fixture(scope="module")
def sequential_blind_spot_run():
    cfg = coarse_sampling(_occlusion_config(tconfig.FrenetixConfig, start_multiagent=True))
    sim = Simulation(_blind_spot(tfactory, tcr), cfg, CPU)
    sim.max_steps = STEPS
    return sim, sim.run(), agent_states(sim)


def test_blind_spot_simulation_matches_jax(sequential_blind_spot_run):
    from frenetix_tpu.io import commonroad as jcr, scenario_factory as jfactory
    from frenetix_tpu.sim.sensor_model import visible_obstacles as jvisible
    from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig

    jsc = _blind_spot(jfactory, jcr)
    jsim = JaxSimulation(jsc, coarse_sampling(_occlusion_config(JaxConfig,
                                                        start_multiagent=True)))
    jsim.max_steps = STEPS
    jres = jsim.run()
    sim, res, states = sequential_blind_spot_run
    assert len(sim.agents) == 2 and res.steps == jres.steps == STEPS
    for aid, want in agent_states(jsim).items():
        assert states[aid].shape == want.shape
        np.testing.assert_allclose(states[aid], want, atol=1e-9)
    gated = sum(a.planner.gate_stats["levels"] for a in sim.agents)
    assert gated > 0

    # what each agent sees, step by step, from its executed states
    ids = {a.id for a in sim.agents}
    hidden = 0
    for a in sim.agents:
        for st in a.record.states:
            kw = dict(sensor_radius=50.0, occlusions=True, agent_ids=ids)
            got = tsensor.visible_obstacles(sim.scenario, a.id, st, st.time_step, **kw)
            want = jvisible(jsc, a.id, st, st.time_step, **kw)
            assert got == want, (a.id, st.time_step)
            hidden += 200 not in got
    assert hidden > 0


def test_blind_spot_simulation_batched_equals_sequential(sequential_blind_spot_run):
    cfg = coarse_sampling(_occlusion_config(tconfig.FrenetixConfig, start_multiagent=True,
                                    batched_device_agents=True))
    sim = Simulation(_blind_spot(tfactory, tcr), cfg, CPU)
    sim.max_steps = STEPS
    res = sim.run()
    _, seq, seq_states = sequential_blind_spot_run
    assert res.steps == seq.steps and res.agent_status == seq.agent_status
    for aid, want in seq_states.items():
        np.testing.assert_allclose(agent_states(sim)[aid], want, atol=1e-9)
    stepper = sim._batched_stepper
    assert stepper.use_occlusion and stepper.use_occ_geom
    assert any(a.record.batch_planning_times for a in sim.agents)
