"""The port's agent mesh (`parallel.mesh.sharded_full_cycle`) in gloo worlds.

Worlds of 2 and 4 spawned CPU processes over a file store
(`parallel.distributed.run_world`); the rank functions live in
`tests/torch_mesh_worker.py` and never import JAX.  Each world runs, float64:

- the JAX tests' stacked problem (`bench_scaling.build_stacked_problem(8,
  float64, n_steps=30, spread=12.0)`, handed over as NumPy arrays), held
  against JAX's `sharded_full_cycle` on the 8 virtual CPU devices and the
  port's `batched_full_cycle`: `found` and `histogram` exactly, `best` equal
  or a tie whose two costs lie within 4 ulps, float fields at
  `torch_parity.RTOL` / `ATOL`; `poses_all` equal on every rank, and the
  full result on every rank;
- the same problem over a mesh of the first two ranks only: the ranks
  outside it end with the mesh's result;
- the responsibility and occlusion post-passes (`worker.post_pass_problem`:
  the port's stacked problem cut to 4 agents, 63 candidates and 5 obstacle
  slots, with `workloads.stacked_post_pass_extras`) against the port's
  batched cycle (the JAX versions of these are `slow` tests);
- an agent count that does not divide over the world: ValueError.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu_torch.parallel import mesh as tmesh
from frenetix_tpu_torch.parallel.distributed import run_world
from frenetix_tpu_torch.planner.core import evaluate_cycle
from tests import torch_mesh_worker as worker
from tests.torch_parity import ATOL, RTOL

torch.set_num_threads(1)

A, DT, N = 8, 0.1, 30
ULPS = 4
WORLDS = (2, 4)
FLOAT_KEYS = ("x", "y", "theta", "v", "a", "kappa", "s", "s_dot", "s_ddot", "d",
              "d_dot", "d_ddot", "cost", "terms")


@pytest.fixture(scope="module")
def jax_problem(tmp_path_factory):
    """The JAX stacked problem as a .npz for the ranks, and JAX's sharded
    result over the 8 virtual devices."""
    import jax

    import bench_scaling
    from frenetix_tpu.parallel.mesh import make_agent_mesh, sharded_full_cycle

    matrices, masks, jctx = bench_scaling.build_stacked_problem(
        A, dtype=np.float64, n_steps=N, spread=12.0)
    jmesh = make_agent_mesh(jax.devices()[:8])
    jout, jposes = sharded_full_cycle(jmesh, dt=DT, n_steps=N)(matrices, masks, jctx)
    leaves = {f: getattr(jctx, f) for f in jctx._fields}
    leaves["ref"] = {k: np.asarray(v) for k, v in jctx.ref._asdict().items()}
    leaves["preds"] = {k: np.asarray(v) for k, v in jctx.preds._asdict().items()}
    leaves["veh"] = np.asarray(tuple(jctx.veh), np.float64)
    path = str(tmp_path_factory.mktemp("mesh") / "problem.npz")
    worker.save_problem(path, matrices, masks, leaves)
    return path, {k: np.asarray(v) for k, v in jout.items()}, np.asarray(jposes)


@pytest.fixture(scope="module")
def worlds(jax_problem):
    """Every rank's results of `worker.sharded_cycles`, per world size."""
    path = jax_problem[0]
    return {w: run_world(worker.sharded_cycles, w, args=(path, DT, N), timeout=240)
            for w in WORLDS}


@pytest.fixture(scope="module")
def port_batched(jax_problem):
    """The port's batched cycle on the same problems: plain, with the
    responsibility term, with the occlusion gate and soft costs."""
    matrices, masks, ctx = worker.load_problem(jax_problem[0])
    plain = tmesh.batched_full_cycle(dt=DT, n_steps=N)(matrices, masks, ctx)
    (m_p, k_p, ctx_p, dt_p, n_p), (grid, pm, geom) = worker.post_pass_problem()
    resp = tmesh.batched_full_cycle(dt=dt_p, n_steps=n_p, **worker.POST_PASSES["resp"])(
        m_p, k_p, ctx_p, grid)
    occl = tmesh.batched_full_cycle(dt=dt_p, n_steps=n_p, **worker.POST_PASSES["occl"])(
        m_p, k_p, ctx_p, pm, *geom)
    cost = evaluate_cycle(matrices, masks, ctx, dt=DT, n_steps=N,
                          low_vel_mode=False).cost.numpy()

    def host(out):
        return {k: v.numpy() for k, v in out.items()}

    return dict(plain=host(plain), resp=host(resp), occl=host(occl), cost=cost)


def _same_or_tie(a, b, cost_row):
    if a == b:
        return True
    ca, cb = cost_row[a], cost_row[b]
    return abs(ca - cb) <= ULPS * np.spacing(max(abs(ca), abs(cb)))


def _assert_selection(got, want, cost, what):
    """Exact found / histogram, best equal or a tie within 4 ulps, float
    fields of the agents with equal best at RTOL / ATOL."""
    np.testing.assert_array_equal(got["found"], want["found"], err_msg=what)
    np.testing.assert_array_equal(got["histogram"], want["histogram"], err_msg=what)
    for a in range(len(want["best"])):
        gb, wb = int(got["best"][a]), int(want["best"][a])
        assert _same_or_tie(gb, wb, cost[a]), (what, a, gb, wb)
        if gb != wb:
            continue
        for key in FLOAT_KEYS:
            np.testing.assert_allclose(got[key][a], want[key][a], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {key}[{a}]")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cycle_matches_jax_sharded_cycle(world, worlds, jax_problem,
                                                 port_batched):
    _, jout, jposes = jax_problem
    assert jout["found"].all()
    for rank, res in enumerate(worlds[world]):
        out, poses = res["plain"]
        assert res["mesh_size"] == world
        assert res["launches"] == 0          # CPU tensors: K1's plain twin
        _assert_selection(out, jout, port_batched["cost"], f"world {world} rank {rank}")
        agree = np.array([int(out["best"][a]) == int(jout["best"][a]) for a in range(A)])
        np.testing.assert_allclose(poses[agree], jposes[agree], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cycle_matches_port_batched_cycle(world, worlds, port_batched):
    for rank, res in enumerate(worlds[world]):
        _assert_selection(res["plain"][0], port_batched["plain"], port_batched["cost"],
                          f"world {world} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_with_the_same_poses(world, worlds):
    ranks = worlds[world]
    first_out, first_poses = ranks[0]["plain"]
    assert first_poses.shape == (A, 4)
    np.testing.assert_array_equal(first_poses, tmesh._poses_from(
        {k: torch.as_tensor(v) for k, v in first_out.items()}).numpy())
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["plain"][1], first_poses)
        for key, value in first_out.items():
            np.testing.assert_array_equal(res["plain"][0][key], value, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_outside_a_smaller_mesh_take_its_result(world, worlds):
    ranks = worlds[world]
    for res in ranks:
        for key, value in ranks[0]["plain"][0].items():
            np.testing.assert_array_equal(res["sub"][0][key], value, err_msg=key)
        np.testing.assert_array_equal(res["sub"][1], ranks[0]["plain"][1])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["resp", "occl"])
def test_sharded_post_passes_match_port_batched_cycle(world, case, worlds, port_batched):
    want = port_batched[case]
    assert want["found"].any()
    for rank, res in enumerate(worlds[world]):
        got = res[case][0]
        np.testing.assert_array_equal(got["found"], want["found"])
        np.testing.assert_array_equal(got["best"], want["best"])
        np.testing.assert_array_equal(got["histogram"], want["histogram"])
        for key in FLOAT_KEYS:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} world {world} rank {rank} {key}")


@pytest.mark.parametrize("world", WORLDS)
def test_agent_count_not_dividing_the_mesh_raises(world, worlds):
    for res in worlds[world]:
        assert res["indivisible"] is not None
        assert "must divide evenly" in res["indivisible"]
