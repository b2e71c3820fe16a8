"""The streaming eval step (port of `leod_tpu/train/step.py:60-135,217-234`,
inference branch; the train step comes with training).

The L-timestep backbone loop runs in Python, one backbone step a
timestep, with the stream-slot LSTM states carried in and out of the
step. Labeled frames are harvested on the host into a static budget of
(t, b) pairs; the features of the FPN's stages are gathered along time
only, with the batch axis outermost, and the FPN + head run once over
the gathered frames.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .. import resolve_device
from ..models.backbone import BackboneStates, reset_states
from ..models.detector import Detector


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _gather_frames(feats_seq: Dict[int, torch.Tensor],
                   frame_t: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Per-slot time gather: feats [L, B, h, w, c] + frame_t [B, M] ->
    [B*M, h, w, c] with the batch axis outermost
    (`leod_tpu/train/step.py:125-134`)."""
    rows = torch.arange(frame_t.shape[0], device=frame_t.device)[:, None]

    def one(f):
        g = f[frame_t, rows]                       # [B, M, h, w, c]
        return g.reshape((-1,) + g.shape[2:])
    return {s: one(f) for s, f in feats_seq.items()}


def make_eval_step(det: Detector, plain: bool = False,
                   device="cuda") -> Callable:
    """Returns eval_step(states, batch) -> (new_states, preds [B*M, A, 5+C]
    with sigmoided obj/cls).

    batch: ev [L, B, H, W, C] (or the stem's prefold of it), is_first [B],
    frame_t [B, M], as numpy arrays or tensors. States persist across
    calls per slot and are zeroed where `is_first` (reference:
    modules/detection.py:300-401). `det` must live on `device` (`cuda`
    unless the caller asks for `cpu`; without a card, `cuda` raises).
    plain=True runs the kernels' plain versions (the reference a kernel
    step is held against on the card)."""
    dev = resolve_device(device)
    if det.device.type != dev.type:
        raise ValueError(f"detector is on {det.device}, step asked for {dev}")
    stages = det.cfg.fpn.in_stages

    @torch.no_grad()
    def eval_step(states: BackboneStates, batch) -> tuple:
        ev = _as_tensor(batch["ev"], det.device)
        frame_t = _as_tensor(batch["frame_t"], det.device).long()
        states = reset_states(states, _as_tensor(batch["is_first"],
                                                 det.device))
        # only the FPN's stages are kept over time (not stage 1's map)
        feats_seq = {s: [] for s in stages}
        for t in range(ev.shape[0]):
            feats, states = det.forward_backbone(ev[t], states, plain=plain)
            for s in stages:
                feats_seq[s].append(feats[s])
        feats = _gather_frames(
            {s: torch.stack(f) for s, f in feats_seq.items()}, frame_t)
        preds, _ = det.forward_detect(feats, train=False)
        return states, preds

    return eval_step
