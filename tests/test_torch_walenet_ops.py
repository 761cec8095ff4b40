"""The port's ONNX interpreter (`frenetix_tpu_torch.models.onnx_torch`)
against the JAX package's (`frenetix_tpu.models.onnx_jax`), on the CPU.

The graph is `workloads.write_synthetic_walenet_onnx` at narrow widths: the
Wale-Net I/O contract and every op of the interpreter's Wale-Net list.

- Per op: every node of the graph, fed the values the JAX interpreter
  computed for its inputs (float64: initializers cast in the test), against
  the JAX node's output.  Shape data, Constant(OfShape), Gather, Concat,
  Reshape, Transpose, (Un)Squeeze, Tile, Expand, Slice and MaxPool must be
  exactly equal; the float math (Conv, GRU, Gemm, MatMul, the activations,
  AveragePool) within 1e-10.
- The op functions on their own, on shapes the graph does not have
  (asymmetric pads, strides, -inf pool padding, negative slice steps, a GRU
  without bias): the same rules.
- The whole graph: float64 within 1e-10 (relative to the output's scale);
  float32, as the net runs, within 1e-4 as the JAX package's own eager-vs-jit
  check (tests/test_walenet.py).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frenetix_tpu.models import onnx_jax
from frenetix_tpu_torch.models import onnx_torch
from frenetix_tpu_torch.models.onnx_lite import OnnxGraph, OnnxNode, load_onnx
from frenetix_tpu_torch.workloads import write_synthetic_walenet_onnx

from torch_parity import CPU

torch.set_num_threads(1)

WIDTHS = dict(conv1=4, conv2=3, embed=4, enc=6, nbr_feat=5, scene_feat=3, dec=7)
WALENET_OPS = {"MatMul", "Add", "Gemm", "Conv", "MaxPool", "AveragePool", "GRU",
               "LeakyRelu", "Tanh", "Exp", "Reshape", "Transpose", "Squeeze",
               "Unsqueeze", "Slice", "Concat", "Expand", "Tile", "Shape", "Gather",
               "Constant", "ConstantOfShape", "Identity"}
EXACT_OPS = {"Shape", "Constant", "ConstantOfShape", "Gather", "Concat", "Reshape",
             "Transpose", "Squeeze", "Unsqueeze", "Tile", "Expand", "Slice", "MaxPool",
             "Identity"}
TOL = 1e-10


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    path = tmp_path_factory.mktemp("walenet") / "synthetic.onnx"
    return load_onnx(write_synthetic_walenet_onnx(str(path), seed=3, **WIDTHS))


def _inputs(b, dtype, seed=0):
    """hist, nbrs (metres around the obstacle) and a sparse 0/127/255 raster."""
    rng = np.random.default_rng(seed)
    hist = np.cumsum(rng.normal(0.0, 1.0, (30, b, 2)), axis=0)
    nbrs = rng.normal(0.0, 8.0, (30, 39 * b, 2)) * (rng.uniform(size=(1, 39 * b, 1)) < 0.2)
    sc = rng.choice([0.0, 0.0, 0.0, 127.0, 255.0], size=(b, 1, 256, 256))
    return {k: v.astype(dtype) for k, v in (("hist", hist), ("nbrs", nbrs), ("sc_img", sc))}


def _as_f64(graph):
    g = copy.deepcopy(graph)
    g.initializers = {k: (v.astype(np.float64) if v.dtype.kind == "f" else v)
                      for k, v in g.initializers.items()}
    return g


def _to_torch(x):
    """A JAX interpreter value as the port's: device arrays as CPU tensors,
    host NumPy values stay NumPy."""
    return x if isinstance(x, np.ndarray) else torch.as_tensor(np.array(x))


def _np(x):
    return x if isinstance(x, np.ndarray) else np.asarray(
        x.numpy() if isinstance(x, torch.Tensor) else x)


def _assert_same(got, want, exact, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    if exact or want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def test_synthetic_graph_has_the_walenet_contract(graph):
    assert graph.inputs == ["hist", "nbrs", "sc_img"]
    assert graph.outputs == ["predictions"]
    assert graph.initializers["sc_conv1.weight"].shape == (WIDTHS["conv1"], 1, 3, 3)
    assert {n.op_type for n in graph.nodes} == WALENET_OPS
    gru = [n for n in graph.nodes if n.op_type == "GRU"]
    assert len(gru) == 3 and all(n.attrs["linear_before_reset"] == 1 for n in gru)
    # scalar constants decode as scalars (shape ())
    consts = [np.asarray(n.attrs["value"]) for n in graph.nodes if n.op_type == "Constant"]
    assert any(c.shape == () for c in consts)
    out = onnx_torch.build_torch_fn(graph, CPU, torch.float32)(
        **{k: torch.as_tensor(v) for k, v in _inputs(2, np.float32).items()})[0]
    assert out.shape == (40, 2, 5) and out.dtype == torch.float32
    out = out.numpy()
    assert np.all(out[..., 2:4] > 0) and np.all(np.abs(out[..., 4]) < 1.0)


@pytest.mark.parametrize("b", [1, 3])
def test_every_node_matches_the_jax_interpreter(graph, b):
    """Each node of the graph on the JAX interpreter's own input values."""
    g64 = _as_f64(graph)
    names = [o for n in g64.nodes for o in n.outputs if o]
    probe = OnnxGraph(nodes=g64.nodes, initializers=g64.initializers, inputs=g64.inputs,
                      outputs=names)
    inputs = _inputs(b, np.float64)
    env = dict(zip(names, onnx_jax.build_jax_fn(probe)(
        **{k: jnp.asarray(v) for k, v in inputs.items()})))
    env.update({k: jnp.asarray(v) for k, v in g64.initializers.items()})
    env.update({k: jnp.asarray(v) for k, v in inputs.items()})
    run = onnx_torch.build_torch_fn(g64, CPU, torch.float64)
    seen = set()
    for node in g64.nodes:
        ins = [_to_torch(env[n]) for n in node.inputs if n]
        outs = run.op(node.op_type, ins, node.attrs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        for name, got in zip(node.outputs, outs):
            if name:
                # host values stay host values, as in the JAX interpreter
                assert isinstance(got, np.ndarray) == isinstance(env[name], np.ndarray) \
                    or node.op_type in ("Squeeze", "Reshape"), (node.name, name)
                _assert_same(got, env[name], node.op_type in EXACT_OPS, node.name)
        seen.add(node.op_type)
    assert seen == WALENET_OPS


@pytest.mark.parametrize("strides,pads", [((1, 1), (1, 1, 1, 1)), ((2, 2), (1, 1, 1, 1)),
                                          ((2, 1), (0, 2, 1, 0)), ((1, 1), (0, 0, 0, 0))])
def test_conv_matches_jax(strides, pads):
    rng = np.random.default_rng(1)
    x, w, b = rng.normal(size=(2, 3, 17, 14)), rng.normal(size=(5, 3, 3, 3)), rng.normal(size=5)
    attrs = {"strides": list(strides), "pads": list(pads)}
    want = onnx_jax._conv(jnp, [jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)], attrs)
    got = onnx_torch.conv(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                          strides=strides, pads=pads)
    _assert_same(got, want, False, f"conv {strides} {pads}")


@pytest.mark.parametrize("kernel,strides,pads", [((2, 2), None, (0, 0, 0, 0)),
                                                 ((3, 3), (2, 2), (1, 1, 1, 1)),
                                                 ((2, 3), (1, 2), (0, 1, 1, 0))])
def test_pools_match_jax(kernel, strides, pads):
    """Max pool exactly (its -inf padding never wins), average pool over
    VALID windows within 1e-10."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 11, 12)) - 5.0
    attrs = {"kernel_shape": list(kernel), "pads": list(pads)}
    if strides is not None:
        attrs["strides"] = list(strides)
    want = onnx_jax._maxpool(jnp, jnp.asarray(x), attrs)
    got = onnx_torch.maxpool(torch.as_tensor(x), kernel, strides, pads)
    _assert_same(got, want, True, "maxpool")
    want = onnx_jax._avgpool(jnp, jnp.asarray(x), attrs)
    got = onnx_torch.avgpool(torch.as_tensor(x), kernel, strides)
    _assert_same(got, want, False, "avgpool")


@pytest.mark.parametrize("with_bias", [True, False])
def test_gru_matches_jax(with_bias):
    """zrh gates, linear_before_reset = 1, h0 = 0: Y (T, 1, B, H), Y_h."""
    rng = np.random.default_rng(4)
    t, b, i, h = 12, 3, 5, 7
    x = rng.normal(size=(t, b, i))
    w, r = rng.normal(0, 0.5, (1, 3 * h, i)), rng.normal(0, 0.5, (1, 3 * h, h))
    bias = rng.normal(0, 0.5, (1, 6 * h))
    ins = [jnp.asarray(x), jnp.asarray(w), jnp.asarray(r)]
    if with_bias:
        ins.append(jnp.asarray(bias))
    y, y_h = onnx_jax._gru(jax, jnp, ins, {"hidden_size": h})
    ty, ty_h = onnx_torch.gru(torch.as_tensor(x), torch.as_tensor(w[0]),
                              torch.as_tensor(r[0]),
                              torch.as_tensor(bias[0]) if with_bias else None, h)
    assert tuple(ty.shape) == (t, 1, b, h) and tuple(ty_h.shape) == (1, b, h)
    _assert_same(ty, y, False, "Y")
    _assert_same(ty_h, y_h, False, "Y_h")


@pytest.mark.parametrize("starts,ends,axes,steps", [
    ([1], [2 ** 62], [0], None), ([0, 2], [3, -1], [1, 2], [1, 2]),
    ([-1], [-(2 ** 62)], [2], [-1]), ([5], [0], [0], [-2]), ([-4], [9], None, None),
])
def test_slice_matches_jax_exactly(starts, ends, axes, steps):
    x = np.arange(7 * 5 * 6, dtype=np.float64).reshape(7, 5, 6)
    ins = [np.asarray(starts), np.asarray(ends)]
    if axes is not None:
        ins.append(np.asarray(axes))
        if steps is not None:
            ins.append(np.asarray(steps))
    want = onnx_jax._slice(jnp, [jnp.asarray(x)] + ins)
    got = onnx_torch.slice_(torch.as_tensor(x), starts, ends, axes,
                            steps if axes is not None else None)
    _assert_same(got, want, True, "slice")
    # host data stays on the host
    assert isinstance(onnx_torch.slice_(np.arange(8), [2], [5]), np.ndarray)


def test_whole_graph_matches_jax_float64(graph):
    g64 = _as_f64(graph)
    inputs = _inputs(4, np.float64, seed=5)
    want = onnx_jax.build_jax_fn(g64)(**{k: jnp.asarray(v) for k, v in inputs.items()})[0]
    got = onnx_torch.build_torch_fn(graph, CPU, torch.float64)(
        **{k: torch.as_tensor(v) for k, v in inputs.items()})[0]
    assert got.dtype == torch.float64
    _assert_same(got, want, False, "predictions f64")


@pytest.mark.parametrize("b", [1, 3])
def test_whole_graph_matches_jax_float32(graph, b):
    inputs = _inputs(b, np.float32, seed=6)
    fn = onnx_jax.build_jax_fn(graph)
    want = jax.jit(lambda h, n, s: fn(hist=h, nbrs=n, sc_img=s)[0])(
        *(jnp.asarray(inputs[k]) for k in ("hist", "nbrs", "sc_img")))
    got = onnx_torch.build_torch_fn(graph, CPU, torch.float32)(
        **{k: torch.as_tensor(v) for k, v in inputs.items()})[0]
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_initializers_upload_once_in_the_given_dtype(graph):
    tensors = onnx_torch.graph_to_torch(graph, CPU, torch.float64)
    assert set(tensors) == set(graph.initializers)
    for name, arr in graph.initializers.items():
        assert isinstance(tensors[name], torch.Tensor) and tensors[name].dtype == torch.float64
        np.testing.assert_array_equal(tensors[name].numpy(), arr.astype(np.float64))
    ints = onnx_torch.graph_to_torch(
        OnnxGraph(initializers={"shape": np.array([2, -1], np.int64)}), CPU, torch.float32)
    assert isinstance(ints["shape"], np.ndarray)         # shape data stays on the host


def test_what_the_interpreter_does_not_carry_raises(graph):
    run = onnx_torch.build_torch_fn(graph, CPU, torch.float32)
    x = torch.zeros(2, 3)
    with pytest.raises(NotImplementedError, match="Erf"):
        run.op("Erf", [x], {})
    with pytest.raises(NotImplementedError, match="groups or dilations"):
        run.op("Conv", [torch.zeros(1, 2, 4, 4), torch.zeros(2, 1, 3, 3)], {"group": 2})
    with pytest.raises(NotImplementedError, match="linear_before_reset"):
        run.op("GRU", [torch.zeros(2, 1, 3), torch.zeros(1, 6, 3), torch.zeros(1, 6, 2)],
               {"hidden_size": 2, "linear_before_reset": 0})
    with pytest.raises(TypeError, match="shape data must stay on the host"):
        run.op("Reshape", [x, torch.tensor([3, 2])], {})
    ok = {k: torch.as_tensor(v) for k, v in _inputs(1, np.float32).items()}
    with pytest.raises(ValueError, match="must be a tensor on cpu"):
        run(**dict(ok, sc_img=ok["sc_img"].to("meta")))
    bad = OnnxGraph(nodes=[OnnxNode(op_type="Erf", inputs=["hist"], outputs=["y"])],
                    inputs=["hist"], outputs=["y"])
    with pytest.raises(NotImplementedError, match="ONNX op Erf not supported"):
        onnx_torch.build_torch_fn(bad, CPU)(hist=ok["hist"])
