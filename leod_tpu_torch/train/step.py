"""The train and streaming eval steps (port of
`leod_tpu/train/step.py:28-234`).

The L-timestep backbone loop runs in Python, one backbone step a
timestep, with the stream-slot LSTM states carried in and out of the
step. Labeled frames are harvested on the host into a static budget of
(t, b) pairs; the features of the FPN's stages are gathered along time
only, with the batch axis outermost, and the FPN + head run once over
the gathered frames.

Training is truncated backprop through time (TBPTT): the gradient flows
across the L timesteps of a window through (h, c), and the states that
leave the step are detached, so it never crosses windows. The train
step runs the module forwards under autograd (`Detector.
forward_backbone_modules`, `forward_detect(train=True)`), the
counterpart of the JAX package's flax/XLA train path: the hand-written
kernels define no backward, as the Pallas kernels define no VJP. The
eval step runs the kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..convert import jax_paths
from ..models.backbone import BackboneStates, reset_states
from ..models.detector import Detector
from .optim import ClipAdamW


class TrainState(NamedTuple):
    """What a train step carries from one step to the next besides the
    model and the optimizer, which it updates in place (the parameters,
    the BN statistics, the AdamW moments and count)."""
    states: BackboneStates     # stream-slot LSTM table [B_slots, ...]
    step: int                  # optimizer steps taken


# TBPTT rematerialization: "full" recomputes every timestep's forward in
# the backward pass (torch.utils.checkpoint around each timestep), "none"
# stores every activation. The JAX package's "dots" and "stage1"
# policies are not ported (ROADMAP.md A.4).
REMAT_POLICIES = ("full", "none")


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


def _check_remat(remat: str) -> None:
    if remat in ("dots", "stage1"):
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet (ROADMAP.md A.4); the port "
            f"takes {REMAT_POLICIES}")
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat={remat!r}; the port takes {REMAT_POLICIES}")


def _global_norm(grads) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all the tensors together."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


def make_train_step(det: Detector, optimizer: ClipAdamW,
                    remat: str = "full", with_preds: bool = False,
                    gradflow: bool = False) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: ev [L, B, H, W, C] (or the stem's fold of it), is_first [B],
    frame_t [B, M], frame_mask [B, M], labels [B, M, G, 7], as numpy
    arrays or tensors. One call: reset the states of the rows that
    start a sequence, run the backbone over the window through the
    module forwards (each timestep under `torch.utils.checkpoint` where
    remat="full"), gather the labeled frames, run the FPN and head once
    over the B·M frames in train mode (BN on batch statistics, padded
    frames included), `yolox_loss`, backward, clip, AdamW.

    metrics (tensors on the model's device): loss, iou_loss, conf_loss,
    cls_loss, num_fg (l1_loss where the head uses it), grad_norm and
    grad_norm/{backbone,fpn,head}, of the UNCLIPPED gradients, as
    `optax.global_norm(grads)` is taken.

    with_preds: metrics also carry "preds" [B*M, A, 5+C], the head's
    decoded boxes with sigmoided obj/cls, detached, for the train-time
    pred-vs-GT panel (reference: callbacks/detection.py:20-107).
    gradflow: metrics also carry the mean |grad| of every parameter,
    unclipped, under "gradflow/<JAX path>" (the JAX package's dotted
    flax path, e.g. "backbone.stage1.down.conv.kernel"; reference:
    callbacks/gradflow.py:10-27)."""
    if not det.trainable:
        raise ValueError("make_train_step needs a Detector built with "
                         "trainable=True")
    _check_remat(remat)
    stages = det.cfg.fpn.in_stages
    groups = {mod: [p for p in getattr(det, mod).parameters()
                    if p.requires_grad] for mod in ("backbone", "fpn", "head")}
    flow = []
    if gradflow:
        paths = jax_paths(det)
        flow = [("gradflow/" + ".".join(paths[n][1]), p)
                for n, p in det.named_parameters() if p.requires_grad]
        flow_numel = torch.tensor([float(p.numel()) for _, p in flow],
                                  device=det.device)

    def timestep(x_t, states):
        feats, new_states = det.forward_backbone_modules(x_t, states)
        return tuple(feats[s] for s in stages), new_states

    def train_step(state: TrainState, batch) -> tuple:
        dev = det.device
        ev = _as_tensor(batch["ev"], dev)
        frame_t = _as_tensor(batch["frame_t"], dev).long()
        frame_mask = _as_tensor(batch["frame_mask"], dev)
        labels = _as_tensor(batch["labels"], dev)
        states = reset_states(state.states,
                              _as_tensor(batch["is_first"], dev))
        optimizer.zero_grad()
        feats_seq = {s: [] for s in stages}
        for t in range(ev.shape[0]):
            if remat == "full":
                feats, states = checkpoint(timestep, ev[t], states,
                                           use_reentrant=False)
            else:
                feats, states = timestep(ev[t], states)
            for s, f in zip(stages, feats):
                feats_seq[s].append(f)
        feats = _gather_frames(
            {s: torch.stack(f) for s, f in feats_seq.items()}, frame_t)
        out, _ = det.forward_detect(feats, train=True)
        losses = det.loss(out, labels.reshape((-1,) + labels.shape[2:]),
                          frame_mask.reshape(-1))
        losses["loss"].backward()
        grads = optimizer.grads()
        metrics = {k: v.detach() for k, v in losses.items()}
        with torch.no_grad():
            metrics["grad_norm"] = _global_norm(grads)
            for mod, params in groups.items():
                metrics[f"grad_norm/{mod}"] = _global_norm(
                    [p.grad for p in params])
            if flow:
                # sum |grad| of every tensor in a few multi-tensor
                # launches, over its size: the mean |grad|
                l1 = torch._foreach_norm([p.grad for _, p in flow], 1)
                metrics.update(zip((k for k, _ in flow),
                                   (torch.stack(l1) / flow_numel).unbind()))
            if with_preds:
                out = out.detach()
                metrics["preds"] = torch.cat(
                    [out[..., :4], torch.sigmoid(out[..., 4:])], dim=-1)
        optimizer.step()
        new_states = tuple((h.detach(), c.detach()) for h, c in states)
        return TrainState(states=new_states, step=state.step + 1), metrics

    return train_step


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
