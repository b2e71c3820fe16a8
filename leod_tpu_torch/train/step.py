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
step runs the module forwards under autograd (`_scan_backbone` over
`Detector.forward_stage1_pre` and `forward_from_stage1`;
`forward_detect(train=True)`), the
counterpart of the JAX package's flax/XLA train path: the hand-written
kernels define no backward, as the Pallas kernels define no VJP. The
eval step runs the kernels.

On a mesh with a model axis (`parallel/tensor.py`) the steps run inside
`model_shard`: each rank computes its model shard of the transformer
blocks, and the gradients are summed over the ranks that hold the same
shards (the replica group).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device, timing
from ..convert import jax_paths
from ..models.backbone import BackboneStates, reset_states
from ..models.detector import Detector
from ..parallel import distributed as pdist
from ..parallel import space, tensor
from ..parallel.mesh import Mesh, height_slice
from .optim import ClipAdamW


class TrainState(NamedTuple):
    """What a train step carries from one step to the next besides the
    model and the optimizer, which it updates in place (the parameters,
    the BN statistics, the AdamW moments and count)."""
    states: BackboneStates     # stream-slot LSTM table [B_slots, ...]
    step: int                  # optimizer steps taken


# TBPTT rematerialization of the backbone loop, TrainingConfig.remat
# (`leod_tpu/train/step.py:32-58`): "full" recomputes every timestep's
# forward in the backward pass (torch.utils.checkpoint around each
# timestep); "dots" keeps the outputs of the 2-D products (`_dots_policy`)
# and recomputes the rest; "stage1" recomputes only stage 1's downsample
# and block pairs (the bulk of the activation bytes, at 4x resolution)
# and stores stages 2-4; "none" stores every activation.
REMAT_POLICIES = ("full", "dots", "stage1", "none")
# The products "dots" keeps: jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable keeps every dot_general without batch
# dimensions, which in the backbone are the Dense layers and the
# ConvLSTM's split products; F.linear lowers those to mm or addmm.
# Attention's q k^T and p v (bmm), the convolutions, norms and
# elementwise ops are recomputed.
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """x on `device`; a host array's bytes, or a host tensor's that is not
    pinned, count as "h2d.pageable_bytes" (on a card, a pageable copy)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if timing.tracing() and x.device.type == "cpu" and not x.is_pinned():
        timing.count("h2d.pageable_bytes", x.numel() * x.element_size())
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


def check_remat(remat: str) -> None:
    """Raises ValueError unless `remat` names one of REMAT_POLICIES."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat={remat!r}; the port takes {REMAT_POLICIES}")


def _in_shard(fn: Callable) -> Callable:
    """`fn` re-entering the space and model shards active now, if any: a
    remat recompute runs in the backward, on the autograd engine's
    thread, and must issue the halo, exchange and model collectives as
    the forward did."""
    sp, mp = space.active(), tensor.active()
    if sp is None and mp is None:
        return fn

    def run(*args):
        with space.space_shard(sp), tensor.model_shard(mp):
            return fn(*args)
    return run


def _remat(fn: Callable, remat: str) -> Callable:
    """fn under the TBPTT remat policy of a whole timestep: checkpointed
    ("full"), selectively checkpointed ("dots"), or as it is ("none";
    "stage1" checkpoints inside the timestep)."""
    fn = _in_shard(fn)
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    return fn


def _scan_backbone(det: Detector, states0: BackboneStates, ev: torch.Tensor,
                   prebatch_stage1: bool = False, remat: str = "full"
                   ) -> Tuple[BackboneStates, Dict[int, torch.Tensor]]:
    """The backbone over the L timesteps of ev [L, B, ...] through the
    module forwards, differentiable (`leod_tpu/train/step.py:60-122`):
    (final states, {FPN stage: features [L, B, h, w, C]}).

    prebatch_stage1: stage 1's downsample and block pairs run over all
    L*B frames in one call before the loop, which then runs the rest of
    each timestep (`Detector.forward_from_stage1`); their activations
    are stored. "stage1" with prebatch_stage1 or with
    backbone.enable_masking becomes "full": neither has a stage-1
    checkpoint boundary, and storing every activation instead would turn
    the policy around (the JAX package does the same)."""
    check_remat(remat)
    stages = det.cfg.fpn.in_stages
    masking = det.cfg.backbone.enable_masking
    if remat == "stage1" and (masking or prebatch_stage1):
        remat = "full"
    pre, xs = det.forward_stage1_pre, ev
    if prebatch_stage1 and not masking:
        n, b = ev.shape[:2]
        y1 = pre(ev.reshape((n * b,) + ev.shape[2:]))
        pre, xs = (lambda y: y), y1.reshape((n, b) + y1.shape[1:])
    elif remat == "stage1":
        pre = functools.partial(checkpoint, _in_shard(pre),
                                use_reentrant=False)

    def body(x_t, states):
        feats, new_states = det.forward_from_stage1(pre(x_t), states)
        return tuple(feats[s] for s in stages), new_states

    step = _remat(body, remat)
    states = states0
    feats_seq = {s: [] for s in stages}
    for t in range(xs.shape[0]):
        feats, states = step(xs[t], states)
        for s, f in zip(stages, feats):
            feats_seq[s].append(f)
    return states, {s: torch.stack(f) for s, f in feats_seq.items()}


def _global_norm(grads, sharded=(), mesh: Optional[Mesh] = None
                 ) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all the tensors together; the
    squares of the `sharded` ones (flags beside `grads`) summed over the
    model group of `mesh`, so that the norm is the whole parameters'."""
    sq = torch.stack([torch.linalg.vector_norm(g.float()).square()
                      for g in grads])
    if any(sharded):
        mask = torch.tensor(sharded, device=sq.device)
        part = torch.where(mask, sq, torch.zeros_like(sq)).sum().reshape(1)
        torch.distributed.all_reduce(part, group=mesh.model_group)
        return (torch.where(mask, torch.zeros_like(sq), sq).sum()
                + part[0]).sqrt()
    return sq.sum().sqrt()


def sum_gradients(grads, group, scale: float = 1.0) -> None:
    """Every rank's gradients become the SUM of the ranks' (in place),
    times `scale`: one all-reduce of one flat fp32 buffer."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    with torch.no_grad():
        torch._foreach_copy_(list(grads), [
            v.view_as(g) for v, g in zip(flat.split(
                [g.numel() for g in grads]), grads)])


_SUMMED = ("loss", "iou_loss", "conf_loss", "cls_loss", "l1_loss")


def make_train_step(det: Detector, optimizer: ClipAdamW,
                    remat: str = "full", with_preds: bool = False,
                    gradflow: bool = False,
                    prebatch_stage1: bool = False,
                    mesh: Optional[Mesh] = None,
                    timings: Optional[Dict[str, list]] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: ev [L, B, H, W, C] (or the stem's fold of it), is_first [B],
    frame_t [B, M], frame_mask [B, M], labels [B, M, G, 7], as numpy
    arrays or tensors. One call: reset the states of the rows that
    start a sequence, run the backbone over the window through the
    module forwards (`_scan_backbone`, under the remat policy `remat` of
    REMAT_POLICIES, with stage 1 over the whole window first where
    `prebatch_stage1`), gather the labeled frames, run the FPN and head once
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
    callbacks/gradflow.py:10-27).

    mesh (`parallel.mesh.make_mesh`): data parallelism over its ranks,
    each feeding its rows of one global batch, as the JAX step computes
    on a mesh. The forward runs under `parallel.distributed.global_batch`
    over the data group (the loss normalizers and the BN statistics over
    every data shard's rows, so a rank's loss is its data shard's share
    of the global loss) and, on a space axis, under
    `parallel.space.space_shard` (each rank computes on its height slice
    of its shard's frames, `ev` [L, B_local, H, ...] sliced here along
    dim 2, the states being its slice already; the BN statistics over
    data x space; the head's outputs gathered, so the space ranks of a
    shard compute the same loss); after the backward the gradients are
    SUMMED over every rank once (not averaged as DDP does; a space
    rank's gradient is its rows' share), before the gradient metrics,
    the clip and AdamW, so every rank takes the global batch's update;
    the loss terms in the metrics are the sums over the data group.
    On a model axis the forward also runs under
    `parallel.tensor.model_shard` (`det` holding its rank's shards,
    `tensor.shard_params`), the gradients are summed over the replica
    group (the ranks of this model index: a sharded tensor's gradient
    differs between model ranks, a whole one's is the same on each once
    `copy_to_model` summed it, so a sum over the model group would count
    both k times; a whole tensor's gradient is then averaged over the
    model group, which keeps its replicas bit-equal where kernels sum in
    another order on each rank), and the gradient norms and gradflow are the whole
    parameters' (a sharded tensor's squares and |grad| summed over the
    model group). Where `timings` is given, the host ms of that
    reduction (ending in a device synchronize) go under
    "allreduce_ms"."""
    if not det.trainable:
        raise ValueError("make_train_step needs a Detector built with "
                         "trainable=True")
    check_remat(remat)
    group = mesh.replica_group if mesh is not None else None
    data_group = mesh.data_group if mesh is not None else None
    shards = tensor.sharded_tensors(det)
    k = mesh.model if mesh is not None else 1
    named = [(n, p) for n, p in det.named_parameters() if p.requires_grad]
    is_sharded = [n in shards for n, _ in named]
    groups = {mod: ([p for n, p in named if n.startswith(mod + ".")],
                    [n in shards for n, _ in named
                     if n.startswith(mod + ".")])
              for mod in ("backbone", "fpn", "head")}
    flow = []
    if gradflow:
        paths = jax_paths(det)
        flow = [("gradflow/" + ".".join(paths[n][1]), p) for n, p in named]
        # the whole parameter's size: k shards of a sharded one
        flow_numel = torch.tensor([float(p.numel() * (k if n in shards
                                                      else 1))
                                   for n, p in named], device=det.device)
        flow_sharded = torch.tensor(is_sharded, device=det.device)

    def train_step(state: TrainState, batch) -> tuple:
        dev = det.device
        with pdist.global_batch(data_group), space.space_shard(mesh), \
                tensor.model_shard(mesh):
            with timing.span("step.forward"):
                ev = _as_tensor(height_slice(mesh, batch["ev"], 2), dev)
                frame_t = _as_tensor(batch["frame_t"], dev).long()
                frame_mask = _as_tensor(batch["frame_mask"], dev)
                labels = _as_tensor(batch["labels"], dev)
                states = reset_states(state.states,
                                      _as_tensor(batch["is_first"], dev))
                optimizer.zero_grad()
                states, feats_seq = _scan_backbone(det, states, ev,
                                                   prebatch_stage1, remat)
                feats = _gather_frames(feats_seq, frame_t)
                out, _ = det.forward_detect(feats, train=True)
            with timing.span("step.loss"):
                losses = det.loss(out, labels.reshape(
                    (-1,) + labels.shape[2:]), frame_mask.reshape(-1))
        with timing.span("step.backward"):
            losses["loss"].backward()
        with timing.span("step.optimizer"):
            return _update(state, states, out, losses)

    def _update(state: TrainState, states, out, losses) -> tuple:
        """The gradients' reductions and norms, the clip and AdamW."""
        dev = det.device
        grads = optimizer.grads()
        metrics = {k: v.detach() for k, v in losses.items()}
        if group is not None:
            if timings is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            with timing.lap(timings, "allreduce_ms", dev):
                sum_gradients(grads, group)
                if shards:
                    # a whole tensor's gradient is the same on every
                    # model rank up to the summation order of the
                    # kernels that made it (cuDNN's weight gradients,
                    # the loss's scatter-adds may use atomics): their
                    # mean over the model group leaves equal gradients
                    # as they are and keeps the replicas bit-equal
                    sum_gradients([g for g, sh in zip(grads, is_sharded)
                                   if not sh], mesh.model_group, 1.0 / k)
            summed = [k for k in _SUMMED if k in metrics]
            tot = torch.stack([metrics[k] for k in summed])
            torch.distributed.all_reduce(tot, group=data_group)
            metrics.update(zip(summed, tot.unbind()))
        with torch.no_grad():
            metrics["grad_norm"] = _global_norm(grads, is_sharded, mesh)
            for mod, (params, sharded) in groups.items():
                metrics[f"grad_norm/{mod}"] = _global_norm(
                    [p.grad for p in params], sharded, mesh)
            if flow:
                # sum |grad| of every tensor in a few multi-tensor
                # launches (a sharded one's over the model group), over
                # its size: the mean |grad|
                l1 = torch.stack(torch._foreach_norm(
                    [p.grad for _, p in flow], 1))
                if shards:
                    part = torch.where(flow_sharded, l1,
                                       torch.zeros_like(l1))
                    torch.distributed.all_reduce(part, group=mesh.model_group)
                    l1 = torch.where(flow_sharded, part, l1)
                metrics.update(zip((name for name, _ in flow),
                                   (l1 / flow_numel).unbind()))
            if with_preds:
                out = out.detach()
                metrics["preds"] = torch.cat(
                    [out[..., :4], torch.sigmoid(out[..., 4:])], dim=-1)
        optimizer.step()
        new_states = tuple((h.detach(), c.detach()) for h, c in states)
        return TrainState(states=new_states, step=state.step + 1), metrics

    return train_step


def make_eval_step(det: Detector, plain: bool = False,
                   device="cuda", mesh: Optional[Mesh] = None) -> Callable:
    """Returns eval_step(states, batch) -> (new_states, preds [B*M, A, 5+C]
    with sigmoided obj/cls).

    batch: ev [L, B, H, W, C] (or the stem's prefold of it), is_first [B],
    frame_t [B, M], as numpy arrays or tensors. States persist across
    calls per slot and are zeroed where `is_first` (reference:
    modules/detection.py:300-401). `det` must live on `device` (`cuda`
    unless the caller asks for `cpu`; without a card, `cuda` raises).
    plain=True runs the kernels' plain versions (the reference a kernel
    step is held against on the card). On a `mesh` with a space axis the
    step runs under `parallel.space.space_shard`: it takes this rank's
    height slice of `ev` (dim 2), the states are its slice, and the
    preds come back whole on every rank of the space group. On a model
    axis it runs under `parallel.tensor.model_shard`, `det` holding its
    rank's shards."""
    dev = resolve_device(device)
    if det.device.type != dev.type:
        raise ValueError(f"detector is on {det.device}, step asked for {dev}")
    stages = det.cfg.fpn.in_stages

    @torch.no_grad()
    def eval_step(states: BackboneStates, batch) -> tuple:
        with timing.span("step.upload"):
            ev = _as_tensor(height_slice(mesh, batch["ev"], 2), det.device)
            frame_t = _as_tensor(batch["frame_t"], det.device).long()
            is_first = _as_tensor(batch["is_first"], det.device)
        states = reset_states(states, is_first)
        with space.space_shard(mesh), tensor.model_shard(mesh):
            # only the FPN's stages are kept over time (not stage 1's map)
            feats_seq = {s: [] for s in stages}
            for t in range(ev.shape[0]):
                feats, states = det.forward_backbone(ev[t], states,
                                                     plain=plain)
                for s in stages:
                    feats_seq[s].append(feats[s])
            feats = _gather_frames(
                {s: torch.stack(f) for s, f in feats_seq.items()}, frame_t)
            preds, _ = det.forward_detect(feats, train=False)
        return states, preds

    return eval_step
