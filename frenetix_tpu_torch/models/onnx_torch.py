"""ONNX graph → PyTorch function interpreter (inference ops).

PyTorch port of `frenetix_tpu/models/onnx_jax.py::build_jax_fn`.  It runs an
`onnx_lite.OnnxGraph` eagerly with torch ops on one device.  The graph's
float initializers are uploaded once (`graph_to_torch`), to the device and
float dtype the caller names; integer initializers stay host NumPy arrays.

Values live in one of two places, as in the JAX interpreter:

- shape data on the host: `Shape`, `Constant`, and `Gather`, `Concat`,
  `Unsqueeze`, `Slice` and integer `ConstantOfShape` over such values (and
  Add / Sub / Mul / Div / Gemm when every input is host data) compute in
  NumPy, so `Reshape`, `Expand`, `Tile` and `Slice` read their shape
  arguments without waiting for the device;
- everything else is a torch tensor on the device (a host constant that
  meets a tensor is uploaded in the graph's float dtype, or in its integer
  dtype, once: the interpreter keeps it, so a call whose constants are
  uploaded copies nothing host → device and can be captured).

Each op is a plain function on tensors (`conv`, `maxpool`, `avgpool`, `gru`,
`slice_`); the graph holds the weights.  The semantics are the JAX
interpreter's: explicit (begin, end) pads, a max pool over -inf padding, an
average pool over VALID windows divided by the window size, an ONNX GRU with
zrh gate order, linear_before_reset = 1 and h0 = 0 returning Y (T, 1, B, H)
and Y_h (1, B, H), Slice clamping `end` to the axis length.  An op outside
the set raises NotImplementedError, as do attributes whose semantics the
JAX interpreter does not implement (grouped or dilated convolutions,
non-forward or linear_before_reset = 0 GRUs, pools of other ranks than 2).

Every op here is a PyTorch call (`conv2d`, the pools, `matmul`), as the JAX
package leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["graph_to_torch", "build_torch_fn", "conv", "maxpool", "avgpool", "gru",
           "slice_"]


def _is_host(x) -> bool:
    return isinstance(x, np.ndarray)


def _is_shape_like(x) -> bool:
    return isinstance(x, np.ndarray) and x.dtype in (np.int64, np.int32)


def _host_ints(x) -> list:
    """The integer values of a host shape argument.  A device tensor here
    would be a shape computed on the device: the interpreter keeps shape
    data on the host, so it raises."""
    if not _is_host(x):
        raise TypeError("ONNX shape argument is a device tensor; shape data must "
                        "stay on the host")
    return [int(v) for v in np.asarray(x).reshape(-1)]


def graph_to_torch(graph, device, dtype) -> dict:
    """The graph's initializers: floats as `dtype` tensors on `device`
    (uploaded here, once), integers as host NumPy arrays (shape data)."""
    out = {}
    for name, arr in graph.initializers.items():
        arr = np.asarray(arr)
        if arr.dtype.kind == "f":
            out[name] = torch.as_tensor(np.require(arr, requirements="W"), dtype=dtype,
                                        device=device)
        else:
            out[name] = arr
    return out


def _axes_of(ins, attrs):
    if len(ins) > 1:
        return _host_ints(ins[1])
    return [int(v) for v in np.atleast_1d(attrs.get("axes", [0]))]


def conv(x, w, b=None, *, strides=(1, 1), pads=(0, 0, 0, 0)):
    """2-D convolution, NCHW × OIHW, `pads` = (h_begin, w_begin, h_end,
    w_end), bias added after the sum."""
    ph0, pw0, ph1, pw1 = (int(p) for p in pads)
    if (ph0, pw0) == (ph1, pw1):
        out = F.conv2d(x, w, stride=tuple(strides), padding=(ph0, pw0))
    else:
        out = F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), w, stride=tuple(strides))
    if b is not None:
        out = out + b[None, :, None, None]
    return out


def maxpool(x, kernel, strides=None, pads=(0, 0, 0, 0)):
    """2-D max pool over -inf padding (floor of the window count)."""
    strides = tuple(strides or kernel)
    ph0, pw0, ph1, pw1 = (int(p) for p in pads)
    if any((ph0, pw0, ph1, pw1)):
        x = F.pad(x, (pw0, pw1, ph0, ph1), value=float("-inf"))
    return F.max_pool2d(x, tuple(kernel), stride=strides)


def avgpool(x, kernel, strides=None):
    """2-D average pool over VALID windows (pads are not read, as in the
    JAX interpreter), divided by the window size."""
    return F.avg_pool2d(x, tuple(kernel), stride=tuple(strides or kernel))


def gru(x, w, r, b, hidden_size: int):
    """ONNX GRU, one forward direction, zrh gates, linear_before_reset = 1,
    h0 = 0.  x (T, B, I), w (3H, I), r (3H, H), b (6H,) or None.  Returns
    (Y (T, 1, B, H), Y_h (1, B, H))."""
    h_size = int(hidden_size)
    if b is None:
        b = torch.zeros(6 * h_size, dtype=x.dtype, device=x.device)
    wb, rb = b[:3 * h_size], b[3 * h_size:]
    # the input projections of the whole sequence, all three gates at once
    xp = torch.matmul(x, w.T) + wb                        # (T, B, 3H)
    rt = r.T
    h = torch.zeros((x.shape[1], h_size), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(x.shape[0]):
        hp = torch.matmul(h, rt) + rb                     # (B, 3H)
        xz, xr, xh = xp[t].split(h_size, dim=-1)
        hz, hr, hh = hp.split(h_size, dim=-1)
        z = torch.sigmoid(xz + hz)
        rg = torch.sigmoid(xr + hr)
        cand = torch.tanh(xh + rg * hh)
        h = (1.0 - z) * cand + z * h
        ys.append(h)
    y = torch.stack(ys)
    return y[:, None], h[None]


def slice_(data, starts, ends, axes=None, steps=None):
    """ONNX Slice; `end` is clamped to the axis length (negative ends count
    from the end).  Host data stays on the host."""
    axes = list(range(len(starts))) if axes is None else axes
    steps = [1] * len(starts) if steps is None else steps
    out = data
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        lim = data.shape[ax]
        en = min(en, lim) if en >= 0 else en
        sl = slice(st, en, sp)
        if sp > 0 or _is_host(out):
            idx = [slice(None)] * out.ndim
            idx[ax] = sl
            out = out[tuple(idx)]
        else:
            # torch slicing takes no negative step: gather the same indices
            index = torch.arange(*sl.indices(lim), device=out.device)
            out = torch.index_select(out, ax, index)
    return out


class _Run:
    """The graph as a callable on one device: `fn(**inputs)` → the list of
    output tensors."""

    def __init__(self, graph, device, dtype):
        self.graph = graph
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.dtype = dtype
        self.init = graph_to_torch(graph, self.device, dtype)
        self.uploaded = {}     # host values met on the device, by contents

    def dev(self, x):
        """A value as a device tensor (host floats in the graph's dtype).
        A host value is uploaded once and kept, keyed by its contents: a
        call whose constants are all uploaded copies nothing host → device,
        so a CUDA graph can capture it."""
        if isinstance(x, torch.Tensor):
            return x
        a = np.asarray(x)
        key = (a.dtype.str, a.shape, a.tobytes())
        if key not in self.uploaded:
            a = np.array(a)          # a copy of its own: the tensor keeps it
            if a.dtype.kind == "f":
                t = torch.as_tensor(a, dtype=self.dtype, device=self.device)
            else:
                t = torch.as_tensor(a, device=self.device)
            self.uploaded[key] = t
        return self.uploaded[key]

    def __call__(self, **inputs):
        for name, x in inputs.items():
            if not isinstance(x, torch.Tensor) or x.device != self.device:
                raise ValueError(f"input {name!r} must be a tensor on {self.device}")
        env = dict(self.init)
        env.update(inputs)
        with torch.no_grad():
            for node in self.graph.nodes:
                ins = [env[n] for n in node.inputs if n]
                outs = self.op(node.op_type, ins, node.attrs)
                if isinstance(outs, tuple):
                    for name, value in zip(node.outputs, outs):
                        if name:
                            env[name] = value
                else:
                    env[node.outputs[0]] = outs
        return [env[name] for name in self.graph.outputs]

    def op(self, op, ins, a):
        dev = self.dev
        if op == "Constant":
            return np.asarray(a["value"])
        if op in ("Identity", "Cast"):
            return ins[0]
        if op in ("Add", "Sub", "Mul", "Div"):
            x, y = ins if all(_is_host(v) for v in ins) else (dev(v) for v in ins)
            return {"Add": x + y, "Sub": x - y, "Mul": x * y, "Div": x / y}[op]
        if op == "MatMul":
            return torch.matmul(dev(ins[0]), dev(ins[1]))
        if op == "Gemm":
            args = ins if all(_is_host(v) for v in ins) else [dev(v) for v in ins]
            x, w = args[0], args[1]
            if a.get("transA"):
                x = x.T
            if a.get("transB"):
                w = w.T
            out = a.get("alpha", 1.0) * (x @ w)
            if len(args) > 2:
                out = out + a.get("beta", 1.0) * args[2]
            return out
        if op == "LeakyRelu":
            x = dev(ins[0])
            return torch.where(x >= 0, x, a.get("alpha", 0.01) * x)
        if op == "Relu":
            return torch.clamp(dev(ins[0]), min=0)
        if op == "Tanh":
            return torch.tanh(dev(ins[0]))
        if op == "Exp":
            return torch.exp(dev(ins[0]))
        if op == "Sigmoid":
            return torch.sigmoid(dev(ins[0]))
        if op == "Softmax":
            return torch.softmax(dev(ins[0]), dim=a.get("axis", -1))
        if op == "Conv":
            if int(a.get("group", 1)) != 1 or any(int(d) != 1 for d in a.get("dilations", [1])):
                raise NotImplementedError("ONNX Conv with groups or dilations not supported")
            if dev(ins[1]).ndim != 4:
                raise NotImplementedError("ONNX Conv other than 2-D not supported")
            return conv(dev(ins[0]), dev(ins[1]), dev(ins[2]) if len(ins) > 2 else None,
                        strides=a.get("strides", [1, 1]), pads=a.get("pads", [0, 0, 0, 0]))
        if op in ("MaxPool", "AveragePool"):
            k = tuple(a.get("kernel_shape"))
            if len(k) != 2:
                raise NotImplementedError(f"ONNX {op} other than 2-D not supported")
            if op == "MaxPool":
                return maxpool(dev(ins[0]), k, a.get("strides"), a.get("pads", [0] * 4))
            return avgpool(dev(ins[0]), k, a.get("strides"))
        if op == "GRU":
            if a.get("linear_before_reset", 0) != 1 \
                    or a.get("direction", "forward") != "forward":
                raise NotImplementedError(
                    "ONNX GRU other than forward with linear_before_reset = 1 not supported")
            has_b = len(ins) > 3 and (ins[3].numel() if isinstance(ins[3], torch.Tensor)
                                      else np.size(ins[3]))
            b = dev(ins[3])[0] if has_b else None
            return gru(dev(ins[0]), dev(ins[1])[0], dev(ins[2])[0], b, a["hidden_size"])
        if op == "Shape":
            return np.asarray(tuple(ins[0].shape), np.int64)
        if op == "Gather":
            data, idx = ins
            axis = a.get("axis", 0)
            idx = np.array(idx) if _is_host(idx) else idx
            if _is_shape_like(data):
                return np.asarray(np.take(data, idx, axis=axis))
            data = dev(data)
            axis = axis % data.ndim
            index = (dev(idx) if _is_host(idx) else idx).reshape(-1) % data.shape[axis]
            out = torch.index_select(data, axis, index)
            return out.reshape(data.shape[:axis] + tuple(idx.shape) + data.shape[axis + 1:])
        if op == "Unsqueeze":
            out = ins[0]
            for ax in sorted(_axes_of(ins, a)):
                out = np.expand_dims(out, ax) if _is_shape_like(out) else dev(out).unsqueeze(ax)
            return out
        if op == "Squeeze":
            out = ins[0]
            for ax in sorted(_axes_of(ins, a), reverse=True):
                out = np.squeeze(out, axis=ax) if _is_host(out) else out.squeeze(ax)
            return out
        if op == "Concat":
            axis = a.get("axis", 0)
            if all(_is_shape_like(x) for x in ins):
                return np.concatenate([np.atleast_1d(x) for x in ins], axis=axis)
            return torch.cat([dev(x) for x in ins], dim=axis)
        if op == "ConstantOfShape":
            shape = tuple(_host_ints(ins[0]))
            val_arr = np.asarray(a.get("value", np.zeros(1, np.float32))).reshape(-1)
            val = val_arr[0] if val_arr.size else 0
            if np.issubdtype(val_arr.dtype, np.integer):
                # an integer fill is shape data (Expand, Reshape, Tile)
                return np.full(shape, val, dtype=val_arr.dtype)
            return torch.full(shape, float(val), dtype=self.dtype, device=self.device)
        if op == "Reshape":
            x = ins[0]
            shape = _host_ints(ins[1])
            shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
            return np.reshape(x, shape) if _is_host(x) else dev(x).reshape(shape)
        if op == "Transpose":
            x = dev(ins[0])
            perm = a.get("perm") or list(range(x.ndim))[::-1]
            return x.permute(*perm)
        if op == "Expand":
            x = dev(ins[0])
            target = tuple(_host_ints(ins[1]))
            return x.expand(np.broadcast_shapes(tuple(x.shape), target))
        if op == "Tile":
            return dev(ins[0]).repeat(*_host_ints(ins[1]))
        if op == "Slice":
            opt = [_host_ints(v) for v in ins[1:]]
            return slice_(ins[0] if _is_host(ins[0]) else dev(ins[0]), *opt)
        if op == "Flatten":
            x = dev(ins[0])
            ax = a.get("axis", 1)
            return x.reshape(int(np.prod(x.shape[:ax])), -1)
        raise NotImplementedError(f"ONNX op {op} not supported")


def build_torch_fn(graph, device, dtype=torch.float32):
    """graph (OnnxGraph) → fn(**inputs) → list of output tensors on `device`.
    The float initializers are uploaded once, here; inputs must be tensors
    on `device` (ValueError otherwise)."""
    return _Run(graph, device, dtype)
