"""The device-resident run's selection margins (`run(emit_margins=True)`)
against the JAX package's (`DeviceSimulation._build_run(emit_margins=True)`,
the private route `tools/tie_margins.py` reads) on the CPU.

Per cycle and agent the run reports the gap between the best and the second
best selectable cost of the program its selection came from (`margin_gap`,
inf with fewer than two selectable candidates) and that gap over the best
cost (`margin_rel`).  On the plain highway and curve families of 120 steps
at sampling level 1 (no behavior, no post-pass: a JAX run with them compiles
for minutes).  On the highway the best candidate has an identical duplicate
at every cycle (the sampling matrix appends the current velocity and d), so
its gap is 0 throughout, and it runs in float64 only; the curve's float64
gaps are all positive, down to ~1e-6 (in float32 some round to a tie of 0):

- float64: both packages' margins within 1e-9, with equal inf and NaN
  patterns;
- float32: equal within `F32_ULPS` float32 ulps of the best cost up to the
  first cycle whose selection differs (the two packages sum a dozen weighted
  cost terms in another order, and JAX builds its grids in double-single:
  the gaps differ by up to 11 such ulps on the curve), where JAX's own
  margin must be a tie within 4 float32 ulps of the best cost;
- the switch changes nothing else: the switch-on run's selections, found
  flags, trajectories and steps equal the switch-off run's, with one fetch
  each; a fleet gives each member the margins of its solo run; the hybrid
  path raises.
"""
import numpy as np
import pytest
import torch

from torch_parity import CPU, coarse_sampling, host_count

torch.set_num_threads(1)

F64_TOL = 1e-9
ULPS = 4
F32_ULPS = 64


def _config(dtype, behavior=False):
    from frenetix_tpu_torch.utils.config import load_config

    cfg = coarse_sampling(load_config())
    cfg.dtype = dtype
    cfg.behavior.use_behavior_planner = behavior
    return cfg


def _port_sim(dtype, n_steps=120, family="highway", behavior=False):
    from frenetix_tpu_torch.io import scenario_factory
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation
    from frenetix_tpu_torch.sim.simulation import Simulation

    scenario = getattr(scenario_factory, f"make_{family}")(n_steps=n_steps)
    return DeviceSimulation(Simulation(scenario, _config(dtype, behavior), CPU))


@pytest.fixture(scope="module", params=[("highway", "float64"), ("curve", "float64"),
                                        ("curve", "float32")],
                ids=lambda p: "-".join(p))
def both(request):
    """(family, dtype, JAX's emit_margins outputs, the port's switch-on
    result, the port's switch-off result, fetches of each port run)."""
    import jax

    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.parallel.device_sim import DeviceSimulation as JDeviceSim
    from frenetix_tpu.sim import Simulation as JSimulation
    from frenetix_tpu.utils.config import load_config as jload
    from frenetix_tpu_torch.parallel import device_sim

    family, dtype = request.param
    jcfg = coarse_sampling(jload())
    jcfg.dtype = dtype
    jds = JDeviceSim(JSimulation(getattr(jfactory, f"make_{family}")(n_steps=120), jcfg))
    jout = jax.device_get(jax.jit(jds._build_run(emit_margins=True))(jds.tensors))
    ds = _port_sim(dtype, family=family)
    fetches = []
    results = []
    for emit in (True, False):
        before = host_count("device_sim.fetches")
        results.append(ds.run(emit_margins=emit))
        fetches.append(host_count("device_sim.fetches") - before)
    return family, dtype, {k: np.asarray(v) for k, v in jout.items()}, *results, fetches


def _assert_same_pattern(port, ref, what):
    for test in (np.isinf, np.isnan):
        np.testing.assert_array_equal(test(port), test(ref), err_msg=f"{what}: {test.__name__}")


def _first_differing_selection(port_sel, jax_sel, port_found, jax_found):
    """First cycle at which some agent's found flag differs, or its selected
    (t1, target, d1) differs beyond float32 rounding; None if none does."""
    tol = 8 * np.spacing(np.maximum(np.abs(jax_sel), 1.0).astype(np.float32))
    differs = (port_found != jax_found) | np.any(np.abs(port_sel - jax_sel) > tol, axis=-1)
    rows = np.nonzero(differs.any(axis=1))[0]
    return int(rows[0]) if len(rows) else None


def _best_cost(gap, rel):
    """|best cost| = gap / margin_rel where the gap is positive, else 1."""
    pos = np.isfinite(gap) & (rel > 0)
    return np.where(pos, gap / np.where(pos, rel, 1.0), 1.0)


def test_margins_match_jax(both):
    family, dtype, jout, on, _, _ = both
    gap, rel = on.extras["margin_gap"], on.extras["margin_rel"]
    jgap, jrel = jout["margin_gap"], jout["margin_rel"]
    assert gap.shape == jgap.shape == on.found.shape
    live = jgap[np.isfinite(jgap)]
    assert len(live) > 50
    if dtype == "float64":
        assert np.all(live == 0) if family == "highway" else np.all(live > 0)
        _assert_same_pattern(gap, jgap, "margin_gap")
        _assert_same_pattern(rel, jrel, "margin_rel")
        for port, ref in ((gap, jgap), (rel, jrel)):
            ok = np.isfinite(ref)
            np.testing.assert_allclose(port[ok], ref[ok], rtol=0, atol=F64_TOL)
        return
    part = _first_differing_selection(on.selections, jout["selections"], on.found,
                                      jout["found"])
    upto = gap.shape[0] if part is None else part
    _assert_same_pattern(gap[:upto], jgap[:upto], "margin_gap")
    ok = np.isfinite(jgap[:upto])
    best = np.maximum(_best_cost(gap, rel), _best_cost(jgap, jrel))
    tol = F32_ULPS * np.spacing(best[:upto].astype(np.float32)).astype(np.float64)
    np.testing.assert_array_less(np.abs(gap[:upto][ok] - jgap[:upto][ok]), tol[ok] * 1.0001)
    if part is not None:
        # where the two float32 runs select differently, JAX's own margin
        # says the selection was a knife edge
        live = np.isfinite(jgap[part])
        bound = ULPS * np.spacing(np.abs(best[part]).astype(np.float32))
        assert np.any(live & (jgap[part] <= bound)), (part, jgap[part], bound)


def test_margins_change_nothing_else(both):
    _, _, _, on, off, fetches = both
    assert fetches == [1, 1], "one fetch per run, margins included"
    assert on.steps == off.steps
    np.testing.assert_array_equal(on.status, off.status)
    np.testing.assert_array_equal(on.selections, off.selections)
    np.testing.assert_array_equal(on.found, off.found)
    np.testing.assert_array_equal(on.trajectories, off.trajectories)
    assert "margin_gap" not in off.extras
    assert on.extras["k1_launches"] == off.extras["k1_launches"]


def test_fleet_members_carry_their_solo_margins():
    from frenetix_tpu_torch.parallel.device_sim import run_fleet

    sims = [_port_sim("float64", n_steps=n) for n in (60, 90)]
    fleet = run_fleet(sims, emit_margins=True)
    for member, sim in zip(fleet, sims):
        solo = sim.run(emit_margins=True)
        for name in ("margin_gap", "margin_rel"):
            got, want = member.extras[name], solo.extras[name]
            assert got.shape == want.shape
            _assert_same_pattern(got, want, name)
            ok = np.isfinite(want)
            np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=F64_TOL)


def test_the_hybrid_path_refuses_margins():
    from frenetix_tpu_torch.io import scenario_factory
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation, run_fleet
    from frenetix_tpu_torch.sim.simulation import Simulation

    cfg = _config("float64", behavior=True)
    cfg.behavior.device_fsm = "hybrid"
    make = [scenario_factory.make_traffic_light, scenario_factory.make_stop_sign]
    sims = [DeviceSimulation(Simulation(m(), cfg, CPU)) for m in make]
    with pytest.raises(ValueError, match="emit_margins"):
        sims[0].run(emit_margins=True)
    with pytest.raises(ValueError, match="emit_margins"):
        run_fleet(sims, emit_margins=True)
