"""Serving: the per-frame detect step, its export to a self-contained
artifact, and a stateful streaming engine (port of
`leod_tpu/serve.py`).

- `make_serve_step`: reset + backbone step + FPN + head + decode +
  fixed-shape NMS over an explicit LSTM state table. An `active` row
  mask freezes the state of idle stream slots.
- `export_serve_step` / `save_artifact` / `load_artifact`: the step as a
  `torch.export` program with the weights inside, written as `<out>.pt2`
  with a `<out>.pt2.json` sidecar. The artifact carries the op library
  its graph calls (the kernels as custom ops, built from `csrc/`), so a
  serving process deserializes and runs it WITHOUT this package, the
  model code, a checkpoint or the CUDA toolkit: `artifact.py`, which
  imports only torch, loads it (as a lone file too: `python -I
  artifact.py`), and the loaded graph launches the kernels it was
  exported with, whatever edits the sources see later. Loading an
  artifact loads that native library and runs its initialisers, so an
  artifact is trusted as an executable is; a caller pins the library it
  expects with `sha256=` (`artifact.load_ops`).
- `ServingEngine`: a thread-safe micro-batching engine mapping client
  stream ids onto the B state-table slots (LRU eviction -> state reset),
  coalescing concurrent requests into one device step.

`cli/export.py` and `cli/serve.py` are the command-line entry points.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import artifact, resolve_device
from .config import ExperimentConfig, stem_fold_hw
from .models.backbone import reset_states
from .models.detector import Detector
from .ops import _build
from .ops.nms import postprocess

# lowering targets an artifact may name, and the device type each means
PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def make_serve_step(det: Detector, conf_threshold: Optional[float] = None,
                    device="cuda", plain: bool = False) -> Callable:
    """Build `serve_step(states, ev, reset, active)` over `det`'s weights.

      states : tuple of (h, c) per stage, one row per stream slot
      ev     : [B, H, W, C] uint8 event frame, or the host-prefolded
               layout [B, H/4, W/4, 16C] (the stem accepts both)
      reset  : [B] bool — zero a slot's LSTM state BEFORE the step
      active : [B] bool — rows that carry a real frame this tick;
               inactive rows keep their (post-reset) state

    Returns (new_states, dets [B, max_dets, 7], valid [B, max_dets]),
    dets rows (x0, y0, x1, y1, obj_conf, cls_conf, cls_id). `det` must
    live on `device`. plain=True runs the kernels' plain versions (the
    reference a kernel step is held against on the card)."""
    dev = resolve_device(device)
    if det.device.type != dev.type:
        raise ValueError(f"detector is on {det.device}, step asked for {dev}")
    cfg = det.cfg
    pp = cfg.postprocess
    conf = (conf_threshold if conf_threshold is not None
            else pp.confidence_threshold)

    @torch.no_grad()
    def serve_step(states, ev, reset, active):
        states0 = reset_states(states, reset)
        feats, new_states = det.forward_backbone(ev, states0, plain=plain)
        # freeze idle slots: keep the post-reset state so an eviction
        # reset sticks even when the slot sits idle afterwards
        keep = active.reshape(-1, 1, 1, 1)
        new_states = tuple(
            (torch.where(keep, h, h0.to(h.dtype)),
             torch.where(keep, c, c0.to(c.dtype)))
            for (h, c), (h0, c0) in zip(new_states, states0))
        preds, _ = det.forward_detect(feats, train=False)
        dets, valid = postprocess(preds, num_classes=cfg.head.num_classes,
                                  conf_threshold=conf,
                                  nms_threshold=pp.nms_threshold,
                                  pre_topk=pp.pre_nms_topk,
                                  max_dets=pp.max_dets, plain=plain)
        return new_states, dets, valid & active[:, None]

    return serve_step


def serve_input_shape(cfg: ExperimentConfig, batch_size: int,
                      fold: bool = True) -> Tuple[int, ...]:
    """Frame-array shape the serving step expects. fold=True ships the
    host-prefolded space-to-depth layout (when the stem supports it)."""
    h, w = cfg.model.backbone.in_res_hw
    c = cfg.model.backbone.input_channels
    fh, fw = stem_fold_hw(cfg.model) if fold else (1, 1)
    return (batch_size, h // fh, w // fw, fh * fw * c)


# ---------------------------------------------------------------------------
# Export (torch.export)
# ---------------------------------------------------------------------------

class _ServeModule(nn.Module):
    """`make_serve_step` as a module: the detector's weights are its
    parameters (no gradients), so `torch.export` lifts them into the
    program."""

    def __init__(self, det: Detector, conf_threshold: Optional[float]):
        super().__init__()
        self.det = det
        self._step = make_serve_step(det, conf_threshold, device=det.device)

    def forward(self, states, ev, reset, active):
        return self._step(states, ev, reset, active)


def export_platforms(platforms: Optional[Tuple[str, ...]],
                     det: Detector) -> Tuple[str, ...]:
    """The device types an artifact is for: `platforms` ("cuda" or its
    alias "gpu", "cpu"), or the detector's own device type when None.
    The ops dispatch on the device, so one program serves both."""
    if platforms is None:
        return (det.device.type,)
    out = []
    for p in platforms:
        if p.lower() not in PLATFORMS:
            raise ValueError(f"platform {p!r}: the port exports for "
                             f"{sorted(PLATFORMS)} (no TPU)")
        if PLATFORMS[p.lower()] not in out:
            out.append(PLATFORMS[p.lower()])
    return tuple(out)


def export_serve_step(det: Detector, cfg: ExperimentConfig,
                      batch_size: int, *, fold: bool = True,
                      conf_threshold: Optional[float] = None,
                      platforms: Optional[Tuple[str, ...]] = None
                      ) -> torch.export.ExportedProgram:
    """Export the serving step for fixed (batch, resolution) shapes: a
    `torch.export` program over `det`'s weights, traced on `det`'s
    device, whose backbone and NMS are the `leod_tpu_torch::` custom ops.
    `platforms` (see `export_platforms`) is kept as the program's
    `.platforms`, which `save_artifact` writes into the artifact."""
    targets = export_platforms(platforms, det)
    states = det.init_states(batch_size)
    ev = torch.zeros(serve_input_shape(cfg, batch_size, fold),
                     dtype=torch.uint8, device=det.device)
    # reset and active must be two tensors: export would take one tensor
    # passed twice for one input
    reset, active = (torch.zeros(batch_size, dtype=torch.bool,
                                 device=det.device) for _ in range(2))
    # the ops registered before tracing, so the trace holds only the step
    _build.load()
    # traced with gradients off, so the program holds no grad-mode region
    with torch.no_grad():
        exported = torch.export.export(_ServeModule(det, conf_threshold),
                                       (states, ev, reset, active))
    # the traced zeros would be saved with the program, as large as the
    # weights at B = 8; the placeholders keep their shapes and dtypes
    exported.example_inputs = None
    exported.platforms = targets
    return exported


def artifact_meta(cfg: ExperimentConfig, batch_size: int, fold: bool,
                  conf_threshold: Optional[float] = None) -> Dict[str, Any]:
    pp = cfg.model.postprocess
    return {
        "dataset": cfg.dataset.name,
        "classes": list(cfg.dataset.classes),
        "batch_size": batch_size,
        "in_res_hw": list(cfg.model.backbone.in_res_hw),
        "input_channels": cfg.model.backbone.input_channels,
        "fold_hw": list(stem_fold_hw(cfg.model)) if fold else [1, 1],
        "frame_shape": list(serve_input_shape(cfg, batch_size, fold)[1:]),
        "max_dets": pp.max_dets,
        "conf_threshold": (conf_threshold if conf_threshold is not None
                           else pp.confidence_threshold),
        "nms_threshold": pp.nms_threshold,
    }


def save_artifact(exported: torch.export.ExportedProgram, path: str,
                  meta: Dict[str, Any]) -> Dict[str, Any]:
    """Write `<path>` (`torch.export.save` of `export_serve_step`'s
    program, its platforms and the op library it calls inside) and
    `<path>.json` (`meta`, the platforms and the library's record);
    `artifact.save_artifact`. Returns the library's record."""
    return artifact.save_artifact(exported, path, meta)


def load_artifact_exported(path: str, sha256: Optional[str] = None
                           ) -> Tuple[torch.export.ExportedProgram,
                                      Dict[str, Any]]:
    """Load an artifact -> (ExportedProgram, meta), its ops registered
    first (`artifact.load_exported`; an artifact without a library takes
    this package's) and the program's `.platforms` read from it. The
    artifact's library is native code that runs when it loads: trust the
    artifact as an executable, or pin the library's `sha256`."""
    return artifact.load_exported(path, ops_loader=_build.load,
                                  sha256=sha256)


def load_artifact(path: str, device="cuda", sha256: Optional[str] = None
                  ) -> Tuple[Callable, Dict[str, Any]]:
    """Load an artifact -> (step_fn, meta). step_fn(states, ev, reset,
    active) runs the program on `device` (the card unless the caller
    asks for the CPU), which must be one of its platforms; the program
    is moved there if it was traced elsewhere. `sha256` as
    `load_artifact_exported`'s."""
    exported, meta = load_artifact_exported(path, sha256)
    return program_module(exported, device), meta


def program_module(exported: torch.export.ExportedProgram,
                   device) -> nn.Module:
    """The runnable module of a loaded program on `device`
    (`artifact.program_module`)."""
    return artifact.program_module(exported, resolve_device(device))


def zero_states_like(exported: Optional[torch.export.ExportedProgram] = None,
                     det: Optional[Detector] = None,
                     batch_size: Optional[int] = None, device="cuda"):
    """Zero state table matching a program's state inputs (their shapes
    and dtypes from the placeholders; no model code needed) on `device`,
    or from a live Detector."""
    if det is not None:
        return det.init_states(batch_size)
    return artifact.zero_states(exported, resolve_device(device))


def program_inputs(exported: torch.export.ExportedProgram) -> tuple:
    """The program's (states, ev, reset, active) as the shapes and dtypes
    its placeholders carry (fake tensors)."""
    return artifact.program_inputs(exported)


# ---------------------------------------------------------------------------
# Micro-batching engine
# ---------------------------------------------------------------------------

class _Request:
    __slots__ = ("stream", "frame", "event", "result", "error", "t0")

    def __init__(self, stream: str, frame: np.ndarray):
        self.stream = stream
        self.frame = frame
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t0 = time.monotonic()             # enqueue time (latency)


def _to_device(tree, device):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(t, device) for t in tree)
    return torch.as_tensor(tree).to(device)


def _first_leaf(tree):
    while isinstance(tree, (tuple, list)):
        tree = tree[0]
    return tree


class ServingEngine:
    """Thread-safe stateful streaming detector over B slots.

    Maps client stream ids onto the state table's B rows. Concurrent
    `detect` calls coalesce into one device step (up to `max_wait_ms`);
    two frames of the SAME stream never share a step. When all slots are
    taken, the least-recently-used idle stream is evicted and its slot's
    LSTM state reset. `step_fn` has `serve_step`'s signature and takes
    torch tensors on `device`."""

    def __init__(self, step_fn: Callable, zero_states, frame_shape,
                 frame_dtype=np.uint8, max_wait_ms: float = 2.0,
                 device="cuda"):
        self.device = resolve_device(device)
        self._step = step_fn
        self._states = _to_device(zero_states, self.device)
        self.batch_size = int(_first_leaf(self._states).shape[0])
        self.frame_shape = tuple(frame_shape)
        self.frame_dtype = np.dtype(frame_dtype)
        self.max_wait_ms = max_wait_ms
        self._slots: Dict[str, int] = {}       # stream id -> slot row
        self._lru: List[str] = []              # least-recent first
        self._pending: List[_Request] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._steps = 0
        # client-visible latency over the last 4096 requests
        self._lat = collections.deque(maxlen=4096)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- client API ---------------------------------------------------------
    def detect(self, stream: str, frame: np.ndarray,
               timeout: Optional[float] = 60.0) -> np.ndarray:
        """Run one frame of `stream`; returns dets [n, 7]. Blocks until
        the frame's micro-batch ran."""
        frame = np.asarray(frame)
        if frame.shape != self.frame_shape or frame.dtype != self.frame_dtype:
            raise ValueError(
                f"frame must be {self.frame_shape} {self.frame_dtype}, "
                f"got {frame.shape} {frame.dtype}")
        req = _Request(stream, frame)
        with self._lock:
            if self._closed:
                raise RuntimeError("engine closed")
            self._pending.append(req)
            self._wake.notify()
        if not req.event.wait(timeout):
            # withdraw the request if the worker has not taken it yet, so
            # a retry does not advance the stream's state twice
            with self._lock:
                try:
                    self._pending.remove(req)
                except ValueError:
                    pass
            raise TimeoutError(f"stream {stream}: no step within {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    def stats(self) -> Dict[str, Any]:
        """Engine counters plus client-visible latency percentiles (ms)."""
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
            out = {"steps": self._steps, "streams": len(self._slots),
                   "slots": self.batch_size, "pending": len(self._pending),
                   "latency_n": int(lat.size)}
        for name, q in (("latency_ms_p50", 50), ("latency_ms_p95", 95),
                        ("latency_ms_p99", 99)):
            out[name] = (float(np.percentile(lat, q) * 1e3) if lat.size
                         else None)
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._wake.notify()
        self._worker.join()
        for req in self._pending:
            req.error = RuntimeError("engine closed")
            req.event.set()

    # -- worker -------------------------------------------------------------
    def _take_batch(self) -> List[_Request]:
        """Pop at most one pending request per stream (lock held)."""
        taken: List[_Request] = []
        streams = set()
        rest: List[_Request] = []
        for req in self._pending:
            if req.stream in streams or len(taken) >= self.batch_size:
                rest.append(req)
            else:
                streams.add(req.stream)
                taken.append(req)
        self._pending = rest
        return taken

    def _assign_batch(self, batch: List[_Request]) -> List[Tuple[int, bool]]:
        """Slot rows for one micro-batch (lock held). Resident streams are
        assigned before new ones, so a new stream never evicts a resident
        that has a request in this very batch."""
        order = sorted(range(len(batch)),
                       key=lambda i: batch[i].stream not in self._slots)
        rows: List = [None] * len(batch)
        for i in order:
            rows[i] = self._assign_slot(batch[i].stream)
        return rows

    def _assign_slot(self, stream: str) -> Tuple[int, bool]:
        """(slot, is_new); evicts the LRU stream when full (lock held)."""
        if stream in self._slots:
            self._lru.remove(stream)
            self._lru.append(stream)
            return self._slots[stream], False
        if len(self._slots) >= self.batch_size:
            victim = self._lru.pop(0)
            slot = self._slots.pop(victim)
        else:
            slot = min(set(range(self.batch_size)) - set(self._slots.values()))
        self._slots[stream] = slot
        self._lru.append(stream)
        return slot, True

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._wake.wait()
                if self._closed:
                    return
                deadline = time.monotonic() + self.max_wait_ms / 1e3
                while (len({r.stream for r in self._pending})
                       < self.batch_size):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._wake.wait(left)
                    if self._closed:
                        return
                batch = self._take_batch()
                if not batch:
                    continue
                rows = self._assign_batch(batch)
            try:
                ev = np.zeros((self.batch_size,) + self.frame_shape,
                              self.frame_dtype)
                reset = np.zeros(self.batch_size, bool)
                active = np.zeros(self.batch_size, bool)
                for req, (slot, is_new) in zip(batch, rows):
                    ev[slot] = req.frame
                    reset[slot] = is_new
                    active[slot] = True
                dev = self.device
                self._states, dets, valid = self._step(
                    self._states, torch.from_numpy(ev).to(dev),
                    torch.from_numpy(reset).to(dev),
                    torch.from_numpy(active).to(dev))
                dets = torch.as_tensor(dets).cpu().numpy()
                valid = torch.as_tensor(valid).cpu().numpy()
                now = time.monotonic()
                with self._lock:
                    self._steps += 1
                    self._lat.extend(now - r.t0 for r in batch)
                for req, (slot, _) in zip(batch, rows):
                    req.result = dets[slot][valid[slot]]
                    req.event.set()
            except Exception as e:  # propagate to blocked callers
                for req in batch:
                    req.error = e
                    req.event.set()
