"""CommonRoad-style solution feasibility check: vehicle-dynamics resimulation.

The port's own NumPy copy of `frenetix_tpu/evaluation/solution_check.py`:
reconstruct control inputs from the executed state list, forward-simulate
them through the kinematic single-track (KS) vehicle model, and compare the
resimulated trajectory against the executed one — a physics-consistency
oracle for planner output (`evaluation.agents` / `--evaluate`).

The KS dynamics replicate commonroad-vehicle-models' VehicleDynamics.KS:
    state  x = [x, y, δ, v, ψ]
    input  u = [v_δ (steering rate), a (longitudinal acceleration)]
    ẋ = v cos ψ,  ẏ = v sin ψ,  δ̇ = v_δ,  v̇ = a,  ψ̇ = v tan δ / L
with steering/acceleration constraints from the vehicle parameters.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SolutionCheckResult", "check_solution", "reconstruct_inputs",
           "forward_simulate", "check_acceleration"]


@dataclass
class SolutionCheckResult:
    feasible: bool
    max_position_error: float
    max_orientation_error: float
    input_violations: int
    acceleration_consistent: bool
    max_acc_deviation: float


def _ks_derivative(x, u, wheelbase):
    return np.array([
        x[3] * np.cos(x[4]),
        x[3] * np.sin(x[4]),
        u[0],
        u[1],
        x[3] * np.tan(x[2]) / wheelbase,
    ])


def forward_simulate(x0, u, dt, wheelbase, substeps: int = 4):
    """RK4 forward simulation of the KS model over one control interval."""
    h = dt / substeps
    x = np.asarray(x0, dtype=float).copy()
    for _ in range(substeps):
        k1 = _ks_derivative(x, u, wheelbase)
        k2 = _ks_derivative(x + 0.5 * h * k1, u, wheelbase)
        k3 = _ks_derivative(x + 0.5 * h * k2, u, wheelbase)
        k4 = _ks_derivative(x + h * k3, u, wheelbase)
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def reconstruct_inputs(states, dt):
    """u_k = [(δ_{k+1}-δ_k)/dt, (v_{k+1}-v_k)/dt] (the CommonRoad checker
    solves a per-transition optimization; the planner's piecewise-polynomial
    states make the finite-difference inputs exact up to discretization)."""
    delta = np.array([s.steering_angle for s in states])
    v = np.array([s.velocity for s in states])
    return np.stack([np.diff(delta) / dt, np.diff(v) / dt], axis=1)


def check_acceleration(states, dt, tol=1e-1):
    """Planned acceleration vs. dv/dt consistency."""
    a_planned = np.array([s.acceleration for s in states])
    a_pc = 0.5 * (a_planned[:-1] + a_planned[1:])
    v = np.array([s.velocity for s in states])
    a_re = np.diff(v) / dt
    diff = np.abs(a_pc - a_re)
    return bool(np.all(diff < tol)), float(np.max(diff)) if len(diff) else 0.0


def check_solution(states, veh, dt, *, pos_tol=0.15, orient_tol=0.1):
    """Full check: input reconstruction → KS resimulation → deviation +
    input-constraint accounting.

    states: executed EgoState list (center positions).  The KS kinematics
    ẋ = v cos ψ etc. describe the REAR-AXLE point, so positions are shifted
    rear before integration and compared in the rear-axle frame.
    """
    if len(states) < 2:
        return SolutionCheckResult(True, 0.0, 0.0, 0, True, 0.0)
    u = reconstruct_inputs(states, dt)

    def rear(s):
        return (
            s.position[0] - veh.wb_rear_axle * np.cos(s.orientation),
            s.position[1] - veh.wb_rear_axle * np.sin(s.orientation),
        )

    violations = 0
    for k in range(len(u)):
        v_k = states[k].velocity
        a_max = veh.a_max * veh.v_switch / v_k if v_k > veh.v_switch else veh.a_max
        if abs(u[k, 0]) > veh.v_delta_max + 1e-6:
            violations += 1
        if not (-veh.a_max - 1e-6 <= u[k, 1] <= a_max + 1e-6):
            violations += 1

    rx0, ry0 = rear(states[0])
    x = np.array([
        rx0, ry0, states[0].steering_angle, states[0].velocity,
        states[0].orientation,
    ])
    pos_err = 0.0
    orient_err = 0.0
    for k in range(len(u)):
        x = forward_simulate(x, u[k], dt, veh.wheelbase)
        s = states[k + 1]
        rx, ry = rear(s)
        pos_err = max(pos_err, float(np.hypot(x[0] - rx, x[1] - ry)))
        d_th = abs((x[4] - s.orientation + np.pi) % (2 * np.pi) - np.pi)
        orient_err = max(orient_err, float(d_th))

    acc_ok, acc_dev = check_acceleration(states, dt)
    return SolutionCheckResult(
        feasible=(pos_err < pos_tol and orient_err < orient_tol and violations == 0),
        max_position_error=pos_err,
        max_orientation_error=orient_err,
        input_violations=violations,
        acceleration_consistent=acc_ok,
        max_acc_deviation=acc_dev,
    )
