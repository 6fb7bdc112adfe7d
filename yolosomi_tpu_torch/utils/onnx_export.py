"""TorchScript and ONNX export of the port's own modules (counterpart of
yolosomi_tpu/utils/onnx_export.py:94-255).

The JAX package exports through a second copy of the model, its torch
mirror. The port's DetectionModel is torch already, so it is traced
directly, wrapped with models/heads.decode: the artifact takes `images`
(B, 3, H, W) float32 in [0, 1] and gives the decoded rows `output`
(B, N, 5 + nc) in input pixels, as the JAX package's does. Heads decoded
on the anchor grid (engine/runner.GRID_HEADS) export; the others raise
NotImplementedError.

Every export traces the model inside `plain_version()`, in eval mode and
under no_grad: a kernel's ctypes launch is invisible to the tracer, which
would record its unfilled output buffer, so the kernel wrappers raise
RuntimeError when they are traced (ops.refuse_trace). The artifact runs
the kernels' plain versions (ODConv's batch-grouped conv, DCN's gathers).

What the trace fixes:
- the device: decode's grids and anchors are baked in as constants on
  the device of the model, so an artifact traced on CUDA runs on CUDA;
- the batch of a graph with ODConv: its plain version reshapes the batch
  into conv groups (groups=B), so `dynamic_batch=True` raises ValueError
  for such a graph (the JAX package's mirror makes the same reshape and
  exports an artifact that fails at another batch when it runs).

ONNX goes through torch's TorchScript-based exporter (dynamo=False; the
dynamo exporter is never used). Its last step, `_add_onnxscript_fn`,
imports the `onnx` package, which neither this project nor the card
machine has, to add onnxscript functions; the graphs here have none, so
the step is replaced by the identity during the export, as the JAX
package does. A torch without that step's module raises RuntimeError. A
graph the exporter fails on raises NotImplementedError naming the row it
failed in: in yolo-somi-dcn that is the first ODConv after the deformable
rows, whose kernel shape the exporter no longer knows ("convolution for
kernel of unknown shape"; each deformable row exports alone, and the
flagship's ODConv rows do). Without onnxruntime, an ONNX file is checked for
structure only: `onnx_summary` walks the protobuf wire format (field
numbers from the public onnx.proto: ModelProto.graph 7, opset_import 8;
GraphProto.node 1, initializer 5, input 11, output 12; NodeProto.op_type 4).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from yolosomi_tpu_torch.engine.runner import GRID_HEADS
from yolosomi_tpu_torch.models.heads import decode
from yolosomi_tpu_torch.models.layers import ODConv2d
from yolosomi_tpu_torch.ops import plain_version


class DecodedModel(nn.Module):
    """The model and its decode: images (B, 3, H, W) -> rows (B, N, 5 + nc)."""

    def __init__(self, model: nn.Module, meta):
        super().__init__()
        self.model = model
        self.anchors_px = np.array(meta.anchors_px, np.float32)
        self.strides = tuple(float(s) for s in meta.strides)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return decode(self.model(images), self.anchors_px, self.strides)


def _wrap(model: nn.Module, meta, imgsz: int, batch: int):
    """(DecodedModel, a zero input on the model's device), or the error of
    a model that does not export."""
    if not meta.nl or meta.head_type not in GRID_HEADS:
        raise NotImplementedError(f"export decodes anchor-grid heads ({', '.join(GRID_HEADS)}); this graph's head is "
                                  f"{meta.head_type if meta.nl else 'none (headless)'}")
    dtypes = {p.dtype for p in model.parameters()}
    if dtypes != {torch.float32}:
        raise TypeError(f"export traces a float32 model, got {sorted(map(str, dtypes))}")
    device = next(model.parameters()).device
    return DecodedModel(model, meta), torch.zeros(batch, 3, imgsz, imgsz, device=device)


@contextlib.contextmanager
def _traced(model: nn.Module):
    """plain_version(), eval mode and no_grad; the model's mode restored after."""
    was_training = model.training
    model.eval()
    try:
        with plain_version(), torch.no_grad():
            yield
    finally:
        model.train(was_training)


@contextlib.contextmanager
def _no_onnxscript_step():
    """The ONNX exporter with `_add_onnxscript_fn` as the identity (it
    needs the absent `onnx` package and changes nothing in a graph without
    onnxscript functions)."""
    try:
        from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
    except ImportError as e:
        raise RuntimeError(f"torch {torch.__version__} has no torch.onnx._internal.torchscript_exporter."
                           "onnx_proto_utils: the onnxscript step of its ONNX exporter cannot be bypassed") from e
    step = getattr(onnx_proto_utils, "_add_onnxscript_fn", None)
    if step is None:
        raise RuntimeError(f"torch {torch.__version__}'s onnx_proto_utils has no _add_onnxscript_fn to bypass")
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        yield
    finally:
        onnx_proto_utils._add_onnxscript_fn = step


def export_torchscript(model: nn.Module, meta, path, imgsz: int = 640, batch: int = 1) -> torch.jit.ScriptModule:
    """Trace the float32 model and its decode at (batch, 3, imgsz, imgsz)
    on the model's device, write the TorchScript artifact to `path` and
    return it (reference export.py:50-63). It runs on that device."""
    wrapped, x = _wrap(model, meta, imgsz, batch)
    with _traced(model):
        ts = torch.jit.trace(wrapped, x, check_trace=False)
    ts.save(str(path))
    return ts


def export_onnx(model: nn.Module, meta, path, imgsz: int = 640, batch: int = 1, opset: int = 12,
                dynamic_batch: bool = False) -> None:
    """Export the float32 model and its decode to ONNX at (batch, 3, imgsz,
    imgsz) (reference export.py:64-130): input `images`, output `output`,
    the batch axis dynamic with `dynamic_batch`."""
    wrapped, x = _wrap(model, meta, imgsz, batch)
    per_sample = [f"row {i}: {meta.specs[i].name}" for i, m in enumerate(model.model)
                  if any(isinstance(s, ODConv2d) for s in m.modules())]
    if dynamic_batch and per_sample:
        raise ValueError("dynamic_batch: ODConv's per-sample conv runs as one conv of B groups, and the trace fixes B "
                         f"({', '.join(per_sample)}); export at the batch to serve")
    dyn = {"images": {0: "batch"}, "output": {0: "batch"}} if dynamic_batch else None
    with _traced(model), _no_onnxscript_step():
        try:
            torch.onnx.export(wrapped, x, str(path), opset_version=opset, input_names=["images"],
                              output_names=["output"], dynamic_axes=dyn, dynamo=False)
        except torch.onnx.errors.OnnxExporterError as e:
            row = re.search(r"::model\.(\d+)\b", str(e))  # the failing value's module scope
            if row is None:
                raise
            i = int(row.group(1))
            raise NotImplementedError(f"torch's ONNX exporter fails at row {i}: {meta.specs[i].name} "
                                      f"({str(e).split(' [Caused by')[0].strip()})") from e


# ---- a schema-less protobuf wire walker ---------------------------------


def _varint(buf: bytes, i: int):
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def _walk(buf: bytes) -> list:
    """The fields of one protobuf message: [(field number, wire type, value)],
    a varint's value an int, a length-delimited one its bytes."""
    i, n, fields = 0, len(buf), []
    while i < n:
        tag, i = _varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
            fields.append((fnum, wt, v))
        elif wt == 2:
            ln, i = _varint(buf, i)
            fields.append((fnum, wt, buf[i:i + ln]))
            i += ln
        elif wt in (1, 5):
            size = 8 if wt == 1 else 4
            fields.append((fnum, wt, buf[i:i + size]))
            i += size
        else:
            raise ValueError(f"unsupported wire type {wt} at byte {i}")
    return fields


def onnx_summary(path) -> Dict:
    """An .onnx file's structure: {'ops': {op_type: count}, 'n_nodes',
    'n_initializers', 'inputs', 'outputs', 'opset'}."""
    with open(path, "rb") as f:
        model = _walk(f.read())
    graph = _walk(next(v for f, w, v in model if f == 7 and w == 2))
    opset = max((v2 for f, w, v in model if f == 8 and w == 2 for f2, w2, v2 in _walk(v) if f2 == 2 and w2 == 0),
                default=0)
    ops: Dict[str, int] = {}
    n_nodes = 0
    for f, w, v in graph:
        if f == 1 and w == 2:
            n_nodes += 1
            for f2, w2, v2 in _walk(v):
                if f2 == 4 and w2 == 2:
                    ops[v2.decode()] = ops.get(v2.decode(), 0) + 1

    def names(field: int) -> list:  # ValueInfoProto.name
        return [v2.decode() for f, w, v in graph if f == field and w == 2 for f2, w2, v2 in _walk(v)
                if f2 == 1 and w2 == 2]

    return {"ops": ops, "n_nodes": n_nodes, "n_initializers": sum(1 for f, w, _ in graph if f == 5 and w == 2),
            "inputs": names(11), "outputs": names(12), "opset": opset}
