"""The frame as one captured CUDA graph, and its fallback report.

The port's counterpart of the reference's ahead-of-time program
(``runtime/aot.py`` of the JAX package): there the frame -> boxes function
is lowered and compiled once, at static shapes, and each call runs one
executable. Here the eager frame (``runtime/pipeline.py``) is captured
once, at load, as one CUDA graph over a static uint8 input buffer; each
call copies the staged frame into that buffer and replays the graph, so
the ~900 launches of a frame cost the host one ``cudaGraphLaunch``.

The reference's fallback analyzer checks the lowered program for host
callbacks and dynamic shapes. Here ``analyze_graph`` walks the captured
graph's nodes (the CUDA driver's graph API): host nodes and copies to or
from host memory are what would take the frame off the card; a graph has
no dynamic shapes. ``print_fallback_report`` refuses a graph with a host
node in strict mode.

``export_serving_artifact`` writes an artifact directory (the
reference's ``config.json`` keys, ``variables.msgpack`` and
``fallback_report.json``): on the card after capturing the frame and
checking its report, on the CPU after one eager frame (its report then
says no graph was taken).

Capturing needs the card; ``FallbackReport``, ``print_fallback_report``,
``pack_detections`` and ``validate_artifact_shapes`` work anywhere.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Any, Callable

import torch

from ..models.config import (
    DEFAULT_CONF_THRESHOLD,
    DEFAULT_CP_Q,
    DEFAULT_IOU_THRESHOLD,
    MAX_DETECTIONS,
)
from ..ops.cuda import _lib
from ..ops.cuda.camera_kernel import CameraGeometry
from ..ops.decode import Detections
from ..utils.checkpoint import save_msgpack, sorted_tree
from .pipeline import (
    build_batch_serving_fn,
    build_camera_serving_fn,
    build_serving_fn,
    staged_shape,
)

# each of the port's kernels by wrapper, as the graph's kernel nodes name
# their device functions (mangled or not)
PORT_KERNELS = {
    "normalize": r"normalize_(merged|pixel|mapped)_kernel",
    "fused_stem_stage1": r"fused_stem_stage1_kernel",
    "decode_topk": r"decode_topk_kernel",
    "nms": r"(?<![a-z_])nms_kernel",
    "stage1_merged": r"stage1_mma_kernel",
    "fused_c3k2": r"c3k2_(wide_)?kernel(ILb0E|<false[,>])",
    "fused_c3k2_cat": r"c3k2_(wide_)?kernel(ILb1E|<true[,>])",
    "fused_head": r"head_(mma|wide|large)_kernel",
    "camera": r"camera_preprocess_kernel",
    "int8_conv": r"int8_conv_kernel",
    "int8_sppf": r"int8_sppf_kernel",
    "qconcat": r"qconcat_kernel",
}

# CUgraphNodeType
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait_event", "event_record", "ext_semas_signal",
               "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
               "conditional")
WARMUP = 3   # eager calls on the capture stream before capturing

_MEM_HOST, _MEM_UNIFIED = 1, 4           # CUmemorytype
_POINTER_ATTRIBUTE_MEMORY_TYPE = 2       # CUpointer_attribute


@dataclasses.dataclass
class FallbackReport:
    """What the captured frame holds besides work on the card."""

    host_nodes: list[str]      # host nodes, copies to or from host memory
    dynamic_shapes: list[str]  # always empty for a graph (parity)
    output_bytes: int          # the Detections fields, bytes
    kernel_nodes: int
    port_kernels: dict[str, int]   # kernel nodes of each port kernel
    nodes: dict[str, int]          # every node, by type
    memsets: list[str] = dataclasses.field(default_factory=list)
    # each memset node: its bytes and the kernels that wait for it
    captured: bool = True      # False: one eager frame, no graph taken

    @property
    def clean(self) -> bool:
        return not self.host_nodes and not self.dynamic_shapes


def print_fallback_report(report: FallbackReport, strict: bool = True,
                          log_fn: Callable[[str], None] = print) -> None:
    """Log the report; in strict mode a graph with a host node raises."""
    log_fn("=== serving-graph fallback report ===")
    if not report.captured:
        log_fn("  graph:            none taken (one eager frame)")
    log_fn(f"  host nodes:       {report.host_nodes or 'none'}")
    log_fn(f"  dynamic shapes:   {report.dynamic_shapes or 'none'}")
    log_fn(f"  kernel nodes:     {report.kernel_nodes} "
           f"(port kernels {report.port_kernels})")
    log_fn(f"  nodes by type:    {report.nodes}")
    if report.memsets:
        log_fn(f"  memsets:          {report.memsets}")
    log_fn(f"  result transfer:  {report.output_bytes} B device->host")
    if not report.clean and strict:
        raise RuntimeError(
            "serving graph is not host-fallback-free: "
            f"host nodes={report.host_nodes} "
            f"dynamic={report.dynamic_shapes}")


def output_bytes(dets: Detections) -> int:
    return sum(t.numel() * t.element_size() for t in dets)


def pack_detections(dets: Detections) -> torch.Tensor:
    """Detections -> ([B,] K, 7) float32 ``[x1, y1, x2, y2, score, cls,
    valid]``: the whole result in one tensor, one device-to-host copy."""
    return torch.cat([dets.boxes.float(), dets.scores.float()[..., None],
                      dets.classes.float()[..., None],
                      dets.valid.float()[..., None]], dim=-1)


def validate_artifact_shapes(artifact, expected_input: int,
                             expected_classes: int) -> None:
    """Refuse to serve an artifact whose input size or class count is not
    the one the caller configured."""
    c = artifact.config
    if c["input_size"] != expected_input:
        raise ValueError(
            f"artifact input size {c['input_size']} != expected "
            f"{expected_input}")
    if c["num_classes"] != expected_classes:
        raise ValueError(
            f"artifact classes {c['num_classes']} != expected "
            f"{expected_classes}")


# ---- the captured graph's nodes (CUDA driver API) ----

class _KernelNodeParams(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def _memcpy_side() -> list:
    return [("x_in_bytes", ctypes.c_size_t), ("y", ctypes.c_size_t),
            ("z", ctypes.c_size_t), ("lod", ctypes.c_size_t),
            ("memory_type", ctypes.c_int), ("host", ctypes.c_void_p),
            ("device", ctypes.c_void_p), ("array", ctypes.c_void_p),
            ("reserved", ctypes.c_void_p), ("pitch", ctypes.c_size_t),
            ("height", ctypes.c_size_t)]


class _MemsetParams(ctypes.Structure):       # CUDA_MEMSET_NODE_PARAMS
    _fields_ = [("dst", ctypes.c_void_p), ("pitch", ctypes.c_size_t),
                ("value", ctypes.c_uint), ("element_size", ctypes.c_uint),
                ("width", ctypes.c_size_t), ("height", ctypes.c_size_t)]


class _MemcpySide(ctypes.Structure):
    _fields_ = _memcpy_side()


class _Memcpy3D(ctypes.Structure):           # CUDA_MEMCPY3D
    _fields_ = [("src", _MemcpySide), ("dst", _MemcpySide),
                ("width_in_bytes", ctypes.c_size_t),
                ("height", ctypes.c_size_t), ("depth", ctypes.c_size_t)]


_cu: ctypes.CDLL | None = None


def _driver() -> ctypes.CDLL:
    global _cu
    if _cu is None:
        cu = ctypes.CDLL("libcuda.so.1")
        P, S = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        sigs = {
            "cuGraphGetNodes": [P, ctypes.POINTER(P), S],
            "cuGraphNodeGetType": [P, ctypes.POINTER(ctypes.c_int)],
            "cuGraphKernelNodeGetParams_v2": [
                P, ctypes.POINTER(_KernelNodeParams)],
            "cuGraphMemcpyNodeGetParams": [P, ctypes.POINTER(_Memcpy3D)],
            "cuGraphMemsetNodeGetParams": [P, ctypes.POINTER(_MemsetParams)],
            "cuGraphNodeGetDependentNodes": [P, ctypes.POINTER(P), S],
            "cuGraphChildGraphNodeGetGraph": [P, ctypes.POINTER(P)],
            "cuFuncGetName": [ctypes.POINTER(ctypes.c_char_p), P],
            "cuKernelGetName": [ctypes.POINTER(ctypes.c_char_p), P],
            "cuPointerGetAttribute": [P, ctypes.c_int, P],
        }
        for name, args in sigs.items():
            fn = getattr(cu, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _cu = cu
    return _cu


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA driver error {err}")


def _kernel_name(cu, node) -> str:
    p = _KernelNodeParams()
    _check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
           "cuGraphKernelNodeGetParams")
    name = ctypes.c_char_p()
    if p.func and cu.cuFuncGetName(ctypes.byref(name), p.func) == 0:
        return name.value.decode()
    if p.kern and cu.cuKernelGetName(ctypes.byref(name), p.kern) == 0:
        return name.value.decode()
    return "?"


def _on_host(cu, side: _MemcpySide) -> bool:
    if side.memory_type == _MEM_HOST:
        return True
    if side.memory_type != _MEM_UNIFIED:
        return False
    kind = ctypes.c_uint(0)
    err = cu.cuPointerGetAttribute(ctypes.byref(kind),
                                   _POINTER_ATTRIBUTE_MEMORY_TYPE,
                                   side.device)
    return err != 0 or kind.value == _MEM_HOST   # unknown: pageable host


def _memset_detail(cu, node) -> str:
    """A memset node's bytes and value, and the kernel nodes that wait
    for it: what the zeroed buffer is for."""
    m = _MemsetParams()
    _check(cu.cuGraphMemsetNodeGetParams(node, ctypes.byref(m)),
           "cuGraphMemsetNodeGetParams")
    count = ctypes.c_size_t(0)
    _check(cu.cuGraphNodeGetDependentNodes(node, None, ctypes.byref(count)),
           "cuGraphNodeGetDependentNodes")
    after = (ctypes.c_void_p * max(count.value, 1))()
    _check(cu.cuGraphNodeGetDependentNodes(node, after, ctypes.byref(count)),
           "cuGraphNodeGetDependentNodes")
    names = []
    for dep in after[:count.value]:
        t = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(dep, ctypes.byref(t)),
               "cuGraphNodeGetType")
        names.append(_kernel_name(cu, dep) if t.value == 0
                     else _NODE_TYPES[t.value])
    size = m.width * m.element_size * max(m.height, 1)
    return f"{size} B of {m.value}, then {'; '.join(names) or 'nothing'}"


def graph_nodes(raw_graph: int) -> list[tuple[str, str]]:
    """(type, detail) of every node of a ``cudaGraph_t``, child graphs
    walked in: a kernel's detail is its device function's name; a copy's
    says whether an end lies in host memory (``"host"``); a memset's, its
    bytes and the kernels that wait for it."""
    cu = _driver()
    count = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(raw_graph, None, ctypes.byref(count)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    _check(cu.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(count)),
           "cuGraphGetNodes")
    out = []
    for node in nodes[:count.value]:
        t = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(t)),
               "cuGraphNodeGetType")
        kind = (_NODE_TYPES[t.value] if 0 <= t.value < len(_NODE_TYPES)
                else f"type{t.value}")
        detail = ""
        if kind == "kernel":
            detail = _kernel_name(cu, node)
        elif kind == "memcpy":
            m = _Memcpy3D()
            _check(cu.cuGraphMemcpyNodeGetParams(node, ctypes.byref(m)),
                   "cuGraphMemcpyNodeGetParams")
            ends = [e for e, side in (("src", m.src), ("dst", m.dst))
                    if _on_host(cu, side)]
            detail = f"{m.width_in_bytes * max(m.height, 1)} B" + (
                f", host {'+'.join(ends)}" if ends else "")
        elif kind == "memset":
            detail = _memset_detail(cu, node)
        elif kind == "graph":
            child = ctypes.c_void_p()
            _check(cu.cuGraphChildGraphNodeGetGraph(node,
                                                    ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
            out += graph_nodes(child.value)
        out.append((kind, detail))
    return out


def report_from_nodes(nodes: list[tuple[str, str]], dets: Detections
                      ) -> FallbackReport:
    """The fallback report of a graph's ``graph_nodes`` and outputs."""
    by_type: dict[str, int] = {}
    for kind, _ in nodes:
        by_type[kind] = by_type.get(kind, 0) + 1
    names = [d for k, d in nodes if k == "kernel"]
    return FallbackReport(
        host_nodes=[f"{k}: {d}" for k, d in nodes
                    if k == "host" or (k == "memcpy" and "host" in d)],
        dynamic_shapes=[],
        output_bytes=output_bytes(dets),
        kernel_nodes=len(names),
        port_kernels={w: sum(bool(re.search(pat, n)) for n in names)
                      for w, pat in PORT_KERNELS.items()},
        nodes=by_type,
        memsets=[d for k, d in nodes if k == "memset"])


def analyze_graph(graph: torch.cuda.CUDAGraph, dets: Detections
                  ) -> FallbackReport:
    """The fallback report of a graph captured with ``keep_graph=True``."""
    return report_from_nodes(graph_nodes(graph.raw_cuda_graph()), dets)


def _launch_counts() -> dict[str, int]:
    return {k.symbol: k.launches for k in _lib.KERNELS}


class CapturedFrame:
    """``serve`` captured as one CUDA graph over a static uint8 frame.

    Holds ``serve`` (and with it the weights the graph reads), the static
    input ``frame``, the graph, its static outputs ``dets`` and ``packed``
    (``pack_detections(dets)``, captured with it), the dedicated stream it
    was warmed up and captured on, the fallback ``report`` read from the
    graph, the launches of each kernel entry point made while capturing
    (``capture_launches``, by C symbol) and the capture's wall time
    (``capture_s``: warm-up, capture, instantiation, analysis and a first
    replay).

    Calls must come one at a time, on one stream: a replay overwrites the
    static outputs, and the decode kernel's scratch is the capture
    stream's."""

    def __init__(self, serve: Callable[[torch.Tensor], Detections],
                 frame_shape: tuple[int, ...], device,
                 strict: bool = True) -> None:
        t0 = time.perf_counter()
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        self.serve = serve   # the graph reads its weights: keep them
        with torch.inference_mode():
            self.frame = torch.zeros(frame_shape, dtype=torch.uint8,
                                     device=self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))

        def frame_fn():
            dets = serve(self.frame)
            return dets, pack_detections(dets)

        # one-time set-up (the decode kernel's scratch, the kernels'
        # shared-memory attributes, cuBLASLt and cuDNN handles and plans)
        # happens here, on the stream the graph is captured on
        with torch.inference_mode(), torch.cuda.stream(self.stream):
            for _ in range(WARMUP):
                frame_fn()
        self.stream.synchronize()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _launch_counts()
        with torch.inference_mode(), torch.cuda.graph(self.graph,
                                                      stream=self.stream):
            self.dets, self.packed = frame_fn()
        after = _launch_counts()
        self.capture_launches = {s: after[s] - before.get(s, 0)
                                 for s in after
                                 if after[s] != before.get(s, 0)}
        self.graph.instantiate()
        self.report = analyze_graph(self.graph, self.dets)
        print_fallback_report(self.report, strict=strict,
                              log_fn=lambda _msg: None)
        self.replay()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        """Replay the graph on the current stream."""
        self.graph.replay()

    def __call__(self, frame: torch.Tensor) -> Detections:
        """Copy ``frame`` (on the card) into the static input, replay;
        -> the static ``dets``, valid until the next call."""
        with torch.inference_mode():
            self.frame.copy_(frame, non_blocking=True)
        self.replay()
        return self.dets


def capture_serving_fn(serve: Callable[[torch.Tensor], Detections],
                       frame_shape: tuple[int, ...], device,
                       strict: bool = True) -> CapturedFrame:
    """``serve`` (any frame -> Detections function ``runtime/pipeline.py``
    builds: staged frames, or a raw camera frame) captured as one CUDA
    graph over a static uint8 input of ``frame_shape`` on ``device``;
    raises if the graph is not host-fallback-free (``strict``)."""
    return CapturedFrame(serve, frame_shape, device, strict)


def export_serving_artifact(
    model,
    variables: dict[str, Any],
    output_dir: str | Path,
    conf_threshold: float = DEFAULT_CONF_THRESHOLD,
    iou_threshold: float = DEFAULT_IOU_THRESHOLD,
    q_factor: float = DEFAULT_CP_Q,
    max_detections: int = MAX_DETECTIONS,
    strict: bool = True,
    camera: tuple[int, int, str] | None = None,
    batch: int | None = None,
    camera_letterbox: bool = False,
    box_space: str = "model",
) -> Path:
    """Write the artifact directory of ``model`` (the port's detector,
    built from ``variables`` on its device) and ``variables``.

    ``camera=(height, width, format)``: the camera program (raw rgb, bgra
    or nv12 frames at camera resolution); ``batch=N``: the multi-stream
    program taking N frames; mutually exclusive, and a camera does not go
    with a host space-to-depth engine. On the card the serving function is
    captured as one CUDA graph at the artifact's static input shape and
    its fallback report is checked (strict: findings raise); on the CPU
    one eager frame of zeros gives the result size, and the report says no
    graph was taken. Writes ``variables.msgpack`` (the ``params``,
    ``batch_stats`` and ``quant`` collections, keys sorted as the
    reference writes them), ``fallback_report.json`` and ``config.json``
    (the reference's keys with ``"platforms"`` the device the frame ran
    on, plus ``fused_c3k2``, ``fused_head``, ``compute_dtype`` and
    ``quant_mode``, which the reference does not record and from which the
    port rebuilds the model: ``artifact.config_from_artifact``)."""
    cfg = model.config
    model.eval()
    output_dir = Path(output_dir)
    if camera is not None and batch is not None:
        raise ValueError("camera and batch exports are mutually exclusive")
    if cfg.s2d_host and camera is not None:
        raise ValueError(
            "s2d_host is incompatible with camera exports: the camera "
            "frame is resized on the card, so there is no host staging "
            "pass to block it in")
    device = next(model.buffers()).device
    kw = dict(conf_threshold=conf_threshold, iou_threshold=iou_threshold,
              q_factor=q_factor, max_detections=max_detections)
    if camera is not None:
        cam_h, cam_w, cam_fmt = camera
        if cam_fmt not in ("rgb", "bgra", "nv12"):
            raise ValueError(f"unknown camera format {cam_fmt!r}")
        if cam_fmt == "nv12" and (cam_h % 2 or cam_w % 2):
            raise ValueError("NV12 camera dims must be even")
        serve = build_camera_serving_fn(
            model, cfg, cam_h, cam_w, cam_fmt, letterbox=camera_letterbox,
            box_space=box_space, **kw)
        frame_shape = CameraGeometry(cam_h, cam_w, cam_fmt, cfg.input_size,
                                     camera_letterbox).frame_shape
    elif batch is not None:
        serve = build_batch_serving_fn(model, cfg, **kw)
        frame_shape = (batch, *staged_shape(cfg))
    else:
        serve = build_serving_fn(model, cfg, **kw)
        frame_shape = staged_shape(cfg)

    if device.type == "cuda":
        report = capture_serving_fn(serve, frame_shape, device,
                                    strict=strict).report
    else:
        with torch.inference_mode():
            dets = serve(torch.zeros(frame_shape, dtype=torch.uint8))
        report = FallbackReport(host_nodes=[], dynamic_shapes=[],
                                output_bytes=output_bytes(dets),
                                kernel_nodes=0, port_kernels={}, nodes={},
                                captured=False)
    print_fallback_report(report, strict=strict)

    output_dir.mkdir(parents=True, exist_ok=True)
    v = {k: variables[k] for k in ("params", "batch_stats", "quant")
         if k in variables}
    save_msgpack(sorted_tree(v), output_dir / "variables.msgpack")
    (output_dir / "config.json").write_text(json.dumps({
        "num_classes": cfg.num_classes,
        "base_channels": cfg.base_channels,
        "lite_p2": cfg.lite_p2,
        "input_size": cfg.input_size,
        "stem_s2d": cfg.stem_s2d,
        "s2d_host": cfg.s2d_host,
        "stage1_s2d": cfg.stage1_s2d,
        "s2d_merged": cfg.s2d_merged,
        "fused_stem": cfg.fused_stem,
        "merged_head": cfg.merged_head,
        "quantized": "quant" in v,
        "conf_threshold": conf_threshold,
        "iou_threshold": iou_threshold,
        "q_factor": q_factor,
        "max_detections": max_detections,
        "output_bytes": report.output_bytes,
        "platforms": [device.type],
        "camera": ({"height": camera[0], "width": camera[1],
                    "format": camera[2], "letterbox": camera_letterbox,
                    "box_space": box_space} if camera else None),
        "batch": batch,
        "fused_c3k2": cfg.fused_c3k2,
        "fused_head": cfg.fused_head,
        "compute_dtype": str(cfg.compute_dtype).removeprefix("torch."),
        "quant_mode": cfg.quant.mode if cfg.quant is not None else "off",
    }, indent=2))
    (output_dir / "fallback_report.json").write_text(json.dumps(
        dataclasses.asdict(report), indent=2))
    return output_dir
