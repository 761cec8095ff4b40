"""The plain reference against the port on the CPU at a small size, through
a whole run of each cell; the control (the reference in bfloat16 in the
program's place) and planted faults must come out not correct."""
from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.risk import costs as risk_costs
from frenetix_tpu_torch.risk import probability

from portbench import entries, generate, judge, run
from portbench.tests.conftest import tiny

CELLS = ("ego_dense.sweep", "convoy8_risk.near", "convoy8_risk.open", "convoy8.plain")


def _run(workload, cpu, seed=2 ** 31 + 77, seconds=0.3):
    config, mix = tiny(workload)
    return run.run_cell(workload, seed, seconds, False, cpu, config=config, mix=mix,
                        setup_from=lambda: 0.0)


@pytest.mark.parametrize("workload", CELLS)
def test_port_matches_reference(workload, cpu):
    result, checks, window = _run(workload, cpu)
    assert result["correct"], checks
    assert result["failed"] == 0
    assert result["attempted"] == len(window.latencies_s) > 0
    for name, value, limit in checks:
        assert value <= limit, (name, value, limit)


@pytest.mark.parametrize("workload", ("ego_dense.sweep", "convoy8_risk.near", "convoy8.plain"))
def test_control_in_bfloat16_is_not_correct(workload, cpu):
    config, mix = tiny(workload)
    lines, pool = generate.draw_pool(config, mix, 13)
    checked = [(req, judge.reference_answer(config, lines, req, dtype=torch.bfloat16,
                                            device=cpu)) for req in pool]
    numbers = judge.compare(config, lines, checked, device=cpu)
    assert not judge.verdict(numbers, judge.limits(config["name"])), numbers


def _stale(request):
    """The step returns its state unchanged: each request gets the answer
    computed for the one before."""
    held = {}

    def wrapped(self, prepared):
        fresh = request(self, prepared)
        out = held.get("last", fresh)
        held["last"] = fresh
        return out
    return wrapped


def _altered(request):
    """An answer altered where it is produced: the selected index moves on
    by one."""
    def wrapped(self, prepared):
        out = request(self, prepared).copy()
        if out.shape[0] == 14:                       # the planner's pack
            out[0, 1] += 1
        else:
            out[:, 12 * (self.n_steps + 1) + 1] += 1
        return out
    return wrapped


def _half_batch(request):
    """Half of the agents left out: their answers are never computed."""
    def wrapped(self, prepared):
        out = request(self, prepared).copy()
        out[out.shape[0] // 2:] = 0.0
        return out
    return wrapped


@pytest.mark.parametrize("workload,fault", [
    ("ego_dense.sweep", _stale), ("ego_dense.sweep", _altered),
    ("convoy8_risk.near", _altered), ("convoy8_risk.near", _half_batch),
    ("convoy8.plain", _stale), ("convoy8.plain", _altered), ("convoy8.plain", _half_batch),
])
def test_planted_fault_is_not_correct(workload, fault, cpu, monkeypatch):
    config, _ = tiny(workload)
    module = entries.load(config["entry"])
    monkeypatch.setattr(module.Entry, "request", fault(module.Entry.request))
    result, checks, _ = _run(workload, cpu, seconds=1.0)
    assert not result["correct"], checks
    assert result["failed"] > 0


def _quadrature_zeroed(monkeypatch):
    """The collision-probability quadrature returns zeros."""
    fast = probability.collision_probability_fast

    def zeroed(ro, preds, veh):
        prob, t = fast(ro, preds, veh)
        return torch.zeros_like(prob), t
    monkeypatch.setattr(risk_costs, "collision_probability_fast", zeroed)


def _gate_at(metres):
    """The quadrature's distance gate moved from 5 m to `metres`: at 2.5 m
    it leaves cells unpriced that it must price."""
    def plant(monkeypatch):
        source = inspect.getsource(probability.collision_probability_fast)
        assert source.count("<= 5.0") == 1
        space = dict(vars(probability))
        exec(compile(source.replace("<= 5.0", f"<= {float(metres)!r}"),
                     probability.__file__, "exec"), space)
        monkeypatch.setattr(risk_costs, "collision_probability_fast",
                            space["collision_probability_fast"])
    plant.__name__ = f"_gate_at_{metres}"
    return plant


def _harm_dropped(monkeypatch):
    """The risk is the collision probability alone: every harm reads 1."""
    harm_tensors = risk_costs._harm_tensors

    def ones(*args, **kwargs):
        ego, obst = harm_tensors(*args, **kwargs)
        return torch.ones_like(ego), torch.ones_like(obst)
    monkeypatch.setattr(risk_costs, "_harm_tensors", ones)


@pytest.mark.parametrize("fault", [_quadrature_zeroed, _gate_at(2.5), _harm_dropped],
                         ids=["quadrature_zeroed", "gate_at_2.5", "harm_dropped"])
def test_planted_risk_fault_is_not_correct(fault, cpu, monkeypatch):
    """A fault in the risk stack under the window's program: only
    `resp_err_rel` sees it, since the picks rarely come near an obstacle."""
    fault(monkeypatch)
    result, checks, _ = _run("convoy8_risk.near", cpu, seconds=1.0)
    numbers = {name: (value, limit) for name, value, limit in checks}
    assert numbers["resp_err_rel"][0] > numbers["resp_err_rel"][1], checks
    assert not result["correct"]


def test_judge_reads_an_unselectable_pick(cpu):
    config, mix = tiny("ego_dense.sweep")
    lines, pool = generate.draw_pool(config, mix, 3)
    solved = [(req, judge.reference.solve(config, lines, req, device=cpu)) for req in pool]
    req, ref = next((q, r) for q, r in solved if r["found"][0])
    ans = judge.reference_answer(config, lines, req, dtype=torch.float64, device=cpu)
    ans["best"] = np.array([int(np.flatnonzero(~ref["selectable"][0].numpy())[0])])
    numbers = judge.compare(config, lines, [(req, ans)], device=cpu)
    assert numbers["pick_gap"] == judge.UNSELECTABLE
