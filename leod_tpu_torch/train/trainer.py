"""Training orchestration and streaming evaluation (port of
`leod_tpu/train/trainer.py:68-731`).

`Trainer.fit` is a plain loop: a host prefetch thread reads, augments,
collates and harvests train windows and copies them to the device; one
train step (`train/step.py`) carries the stream-state table; streaming
evaluation (`run_streaming_eval`) with the Prophesee/COCO metrics runs
at `val_check_interval` through the kernels, on a bf16 inference copy of
the trained weights; checkpoints are written on a timer, at the end and
on best AP (reference: callbacks/custom.py:9-29), and a SIGTERM makes
fit() checkpoint and return at the next step boundary.

`run_streaming_eval`: a host prefetch thread reads and collates windows;
each batch's labeled frames are harvested into a static budget, the eval
step runs the backbone over the L-frame window on the card, the
fixed-shape NMS runs over the harvested frames, and the Prophesee/COCO
evaluator scores them.

Every `viz_every_steps` steps `fit` writes a pred-vs-GT panel of the
step's first labeled frame to <run_dir>/viz/ (reference:
callbacks/detection.py:20-107); with `training.gradflow` the logged
metrics carry every parameter's mean |grad| (`train/step.py`);
`fit(profile_steps=n)` traces n steps from step 5 with `torch.profiler`
into <run_dir>/profile.

Checkpoints are the port's own (`torch.save` of the model's and the
optimizer's state dicts, ckpt_<name>.pt); the JAX package's orbax
checkpoint directories are not read (`resolve_checkpoint` raises on
one).

Data parallelism (`Trainer(mesh=make_mesh())`, one process a card in one
process group; the JAX package's mesh and multi-host runtime): rank p
feeds global stream slots [p*B_local, (p+1)*B_local) and holds their
LSTM states, every rank holds the whole model (broadcast from rank 0 at
init, restore and weight load) and takes the global batch's update
(`train/step.py`), rank 0 writes the checkpoints and the metrics, the
checkpoint timer and the stop request are decided together every
`multihost_sync_every` steps, and validation is sharded over the ranks
with the evaluators all-gathered (`run_streaming_eval`). On a space axis
(`make_mesh(space=k)`, rank r = d*k + s) the k ranks of data shard d
feed the same slots, each its height slice of every map (the step slices
the window, `train/step.py`), and validate their shard together; the
online SSOD teacher runs the shard's slots at full height on each rank.
On a model axis (`make_mesh(model=k)`, rank r = (d*SP + s)*k + m) the k
ranks of one (data, space) index feed the same rows, each holding model
shard m of the transformer blocks (`parallel/tensor.py`): the whole
weights are replicated from rank 0 and then sharded, the AdamW moments
are made on the shards, a checkpoint holds whole tensors (gathered over
the model group, so that one file serves every mesh and one process),
and a restore or weight load shards them again. Online SSOD raises on a
model axis (ROADMAP.md C.3: the JAX package's teacher takes a shard of
each sharded weight there).
"""
from __future__ import annotations

import copy
import itertools
import json
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device, timing
from ..config import ExperimentConfig, stem_fold_hw
from ..data.loader import (EvalStreamLoader, MixedTrainLoader, Prefetcher,
                           RandomTrainLoader, StreamTrainLoader,
                           harvest_frames, open_split_sequences)
from ..data.sequence import EventSequence
from ..eval.prophesee import PropheseeEvaluator, boxes_to_prophesee
from ..models.detector import Detector
from ..models.layers import unfold_ev_hw, unfold_ev_width
from ..ops.nms import postprocess
from ..parallel import distributed as pdist
from ..parallel import tensor
from ..parallel.mesh import (Mesh, data_axis_size, data_shard, replicate,
                             shard_states)
from ..utils.viz import save_pred_vs_gt_panel
from .optim import make_optimizer
from .step import (TrainState, check_remat, make_eval_step,
                   make_train_step)

def resolve_checkpoint(path: str) -> str:
    """The port's checkpoint file for `path`: the file itself, or
    `path` + ".pt" (so the JAX CLIs' `runs/<exp>/ckpt_last` names
    `ckpt_last.pt`). An orbax checkpoint directory raises."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            f"package?); the port reads its own ckpt_<name>.pt files, or a "
            f"reference PyTorch .ckpt/.pth through --torch-weight / "
            f"--torch-ckpt")
    if not os.path.exists(path) and os.path.exists(path + ".pt"):
        return path + ".pt"
    return path


def load_variables(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Checkpoint -> the model's state dict (parameters and BN
    statistics), for `Detector.load_state_dict` (the counterpart of
    `leod_tpu/train/trainer.py:56` `load_variables`; the payload also
    carries the optimizer, the step and the best-AP state)."""
    return torch.load(resolve_checkpoint(path), map_location=device,
                      weights_only=True)["model"]


def default_frames_per_slot(seq_len: int, use_label_every: int = 1) -> int:
    """Static per-slot harvest budget.

    Real Gen1/Gen4 GT labels arrive at <= 4 Hz vs 20 Hz reprs, so
    ceil(L/5)+1 covers them with slack. When training on pseudo-dense
    datasets with `use_label_every` subsampling, the kept pseudo frames
    are denser: budget additionally covers ceil(L/use_label_every)+1.
    The loader reports dropped_frames when the budget is too small."""
    budget = max(2, (seq_len + 4) // 5 + 1)
    if use_label_every > 1:
        budget = max(budget, -(-seq_len // use_label_every) + 1)
    return budget


@timing.traced
def run_streaming_eval(det: Detector, cfg: ExperimentConfig,
                       split: str = "val", batch_size: Optional[int] = None,
                       frames_per_slot: Optional[int] = None,
                       conf_threshold: Optional[float] = None,
                       max_batches: Optional[int] = None,
                       time_flip: bool = False,
                       shard_index: Optional[int] = None,
                       num_shards: Optional[int] = None,
                       evaluator: Optional[PropheseeEvaluator] = None, *,
                       sequences: Optional[List[EventSequence]] = None,
                       plain: bool = False, device="cuda",
                       on_batch: Optional[Callable] = None,
                       timings: Optional[Dict[str, list]] = None,
                       mesh: Optional[Mesh] = None
                       ) -> Optional[Dict[str, float]]:
    """Full streaming evaluation of a split -> Prophesee COCO metrics
    (reference: modules/detection.py:300-463, val.py).

    The split's sequences are dealt over B stream slots (shard
    `shard_index` of `num_shards`); with several shards, pass one
    `evaluator` per shard and combine them with
    `PropheseeEvaluator.merge`. By default, under a process group, each
    process evaluates its own shard (reference shards by global rank,
    stream_sharded_datapipe.py:88-105) with no collective inside the
    loop, and the evaluators' buffers are all-gathered before the COCO
    eval, so every rank returns identical exact metrics
    (`parallel.distributed.allgather_evaluator`); one process evaluates
    the whole split. `sequences` (already open, e.g.
    `ArrayEventSequence`s) replaces the split's directory. `det` must live
    on `device` (`cuda` unless the caller asks for `cpu`); plain=True
    runs the kernels' plain versions.

    `mesh` with a space axis (`parallel.mesh.make_mesh(space=k)`): the
    ranks of a space group evaluate one shard together, each on its
    height slice (`make_eval_step(mesh=)`), the shards being the data
    shards (`data_shard`) where none is given; the head's outputs come
    back whole on every rank, and only space rank 0 of each data shard
    feeds its evaluator before the all-gather, so no frame counts twice
    (with an explicit shard every rank feeds its own). B stays the slots
    of a shard, as the process shards take it. Without one (or with
    space 1) each process evaluates its own shard. On a model axis the
    ranks of a model group evaluate one shard together, each through
    its model shard of the blocks (`det` sharded by
    `parallel.tensor.shard_params`, or a whole `det`, sharded here in a
    copy), and only model rank 0 feeds the evaluator.

    on_batch(batch_index, harvested, preds, dets, valid) is called after
    the NMS of every batch with labeled frames (dets and valid as numpy).
    `timings`, where given, collects host ms a batch under "harvest_ms",
    "step_ms" (ending in a device synchronize), "postprocess_ms" and
    "bridge_ms", and "evaluate_ms" once, and turns the port's tracer on
    while the loop runs (`timing`): each of those a span under the batch
    index, over the harvest's and the step's own spans."""
    dev = resolve_device(device)
    if det.device.type != dev.type:
        raise ValueError(f"detector is on {det.device}, eval asked for {dev}")
    dst = cfg.dataset
    B = batch_size or cfg.training.batch_size_eval
    seqs = sequences if sequences is not None else open_split_sequences(
        dst, split, seq_ratio={"val": dst.val_ratio,
                               "test": dst.test_ratio}.get(split, -1.0))
    if not seqs:
        return None
    time_flip = time_flip or dst.reverse_event_order
    shard_index, num_shards, sync_metrics = pdist.eval_shard(
        shard_index, num_shards, data_shard(mesh))
    feed = not sync_metrics or mesh is None or (
        mesh.space_index == 0 and mesh.model_index == 0)
    if mesh is not None and mesh.model > 1 and not tensor.is_sharded(det):
        det = copy.deepcopy(det)
        tensor.shard_params(det, mesh)
    B = min(B, len(seqs))
    loader = EvalStreamLoader(seqs, dst, B, time_flip=time_flip,
                              shard_index=shard_index, num_shards=num_shards)
    M = frames_per_slot or default_frames_per_slot(dst.sequence_length)
    pp = cfg.model.postprocess
    conf = conf_threshold if conf_threshold is not None else pp.confidence_threshold

    eval_step = make_eval_step(det, plain=plain, device=dev, mesh=mesh)
    if evaluator is None:
        evaluator = PropheseeEvaluator(dst.name, dst.downsample_by_factor_2)
    states = det.init_states(B, space=mesh.space if mesh is not None else 1)
    n_cls = cfg.model.head.num_classes

    prefetcher = Prefetcher(iter(loader))
    try:
        for bi, batch in enumerate(prefetcher):
            if max_batches is not None and bi >= max_batches:
                break
            with timing.lap(timings, "harvest_ms", batch=bi):
                while True:
                    hb = harvest_frames(batch, M, cfg.model.head.max_gt,
                                        cfg.model.backbone.in_res_hw,
                                        fold_hw=stem_fold_hw(cfg.model))
                    if not hb["dropped_frames"]:
                        break
                    # dropped eval frames would silently bias mAP
                    # (the reference harvests ragged and can never
                    # drop, modules/utils/detection.py:27-58): regrow
                    # the static budget to this batch's demand and
                    # re-harvest
                    M = int(hb["max_slot_frames"])
                    print(f"eval harvest budget grown to {M}/slot",
                          flush=True)
            with timing.lap(timings, "step_ms", det.device, batch=bi):
                states, preds = eval_step(states, hb)
            if hb["num_frames"] == 0:
                continue
            with timing.lap(timings, "postprocess_ms", batch=bi):
                dets, valid = postprocess(preds, num_classes=n_cls,
                                          conf_threshold=conf,
                                          nms_threshold=pp.nms_threshold,
                                          pre_topk=pp.pre_nms_topk,
                                          max_dets=pp.max_dets,
                                          plain=plain)
                dets = dets.cpu().numpy()
                valid = valid.cpu().numpy()
            with timing.lap(timings, "bridge_ms", batch=bi):
                # rows are (b, m) flattened with b outer
                Mslot = hb["frame_t"].shape[1]
                for b in range(len(hb["boxes"]) if feed else 0):
                    for m in range(Mslot):
                        lab = hb["boxes"][b][m]
                        if lab is None:
                            continue
                        row = b * Mslot + m
                        d = dets[row][valid[row]]
                        gt, dt = boxes_to_prophesee(
                            lab, d if len(d) else None)
                        evaluator.add_labels([gt])
                        evaluator.add_predictions([dt])
            if on_batch is not None:
                on_batch(bi, hb, preds, dets, valid)
    finally:
        # join the producer even on an exception path (and on the
        # max_batches early break)
        prefetcher.close()
        for s in seqs:
            s.close()
    if sync_metrics:
        pdist.allgather_evaluator(evaluator)
    t0 = time.perf_counter()
    metrics = evaluator.evaluate()
    if timings is not None:
        timings["evaluate_ms"] = (time.perf_counter() - t0) * 1e3
    return metrics


class MetricLogger:
    """JSONL + stdout metrics with pluggable sinks
    (`leod_tpu/train/trainer.py:84-153`). Each sink is called with the
    plain-float record of every log call; a sink's exception is reported
    and never stops training. Under a process group only rank 0 writes,
    prints and calls the sinks (the records are the same on every rank;
    the reference logs on rank 0 through Lightning)."""

    def __init__(self, path: Optional[str]):
        self._sinks: list = []
        self._f = None
        self._primary = pdist.is_primary()
        if path and self._primary:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._f = open(path, "a")

    def add_sink(self, sink: Callable[[Dict[str, Any]], None]
                 ) -> "MetricLogger":
        self._sinks.append(sink)
        return self

    @staticmethod
    def wandb_sink(project: str, run_name: Optional[str] = None,
                   config: Optional[Dict[str, Any]] = None):
        """WandB adapter (reference: loggers/utils.py:5-24). Raises
        ImportError when wandb is not installed."""
        import wandb

        run = wandb.init(project=project, name=run_name, config=config,
                         resume="allow")

        def sink(record: Dict[str, Any]):
            step = record.get("step")
            run.log({k: v for k, v in record.items() if k != "step"},
                    step=int(step) if step is not None else None)
        return sink

    def close(self):
        """Release the JSONL handle (idempotent)."""
        if self._f:
            self._f.close()
            self._f = None

    def log(self, record: Dict[str, Any]):
        if not self._primary:
            return
        rec = {k: (float(v) if isinstance(v, (torch.Tensor, np.ndarray,
                                              np.floating)) else v)
               for k, v in record.items()}
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        print(line, flush=True)
        for sink in self._sinks:
            try:
                sink(rec)
            except Exception as e:                   # noqa: BLE001
                print(f"metric sink error ({sink}): {e}", flush=True)


_DEVICE_KEYS = ("ev", "is_first", "frame_t", "frame_mask", "labels")


def _start_profile(device: torch.device):
    """A torch profiler of every thread (where the installed torch takes
    `profile_all_threads`; else of the threads it starts in), with
    tracing on until `_stop_profile`, so that the prefetch thread's
    "leod." spans show beside the kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        config = None
    prof = torch.profiler.profile(activities=acts,
                                  experimental_config=config)
    prof.__enter__()
    timing.begin()
    return prof


def _stop_profile(prof, run_dir: str) -> None:
    """End the trace and write it to <run_dir>/profile/trace.json."""
    prof.__exit__(None, None, None)
    timing.end()
    out = os.path.join(run_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    print(f"profile trace -> {out}", flush=True)


class _Uploader:
    """Copies a harvested batch to the device from the prefetch thread:
    on a card, from pinned memory on a side stream, with an event the
    consuming step waits on; on the CPU, a view of the arrays."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def __call__(self, hb: Dict[str, Any]):
        host = {k: torch.from_numpy(np.ascontiguousarray(hb[k]))
                for k in _DEVICE_KEYS}
        if self.stream is None:
            return host, None
        with torch.cuda.stream(self.stream):
            dev = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = self.stream.record_event()
        if timing.tracing():
            timing.count("h2d.pinned_bytes", sum(
                v.numel() * v.element_size() for v in host.values()))
        return dev, done

    def ready(self, dev: Dict[str, torch.Tensor], done) -> None:
        """Make the current stream wait for the copy, and keep the
        tensors' memory from reuse until the current stream is done."""
        if done is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(done)
        for t in dev.values():
            t.record_stream(cur)


class Trainer:
    """Training of `cfg` on one card, or over the ranks of `mesh`
    (`parallel.mesh.make_mesh()`: one process a card; the JAX package's
    `Trainer(mesh=...)` with its data, space and model axes). The
    trainable model (`self.det`, fp32 parameters computing in `dtype`;
    on a model axis this rank's shards, `self.shards` naming the blocks
    sharded and those left whole) and the optimizer are built by
    `init_state` (which `fit` calls when given no state), and updated in
    place by every step and by a restore."""

    def __init__(self, cfg: ExperimentConfig, dtype=torch.bfloat16,
                 device="cuda", mesh: Optional[Mesh] = None):
        if mesh is None and pdist.world_size() > 1:
            raise ValueError(
                f"a process group of {pdist.world_size()} ranks and no "
                f"mesh: pass mesh=make_mesh() to train data-parallel "
                f"(each rank alone would train a model of its own)")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        # batch rows divide this (space ranks share their data shard's rows)
        self.data_degree = data_axis_size(mesh)
        self.run_dir = os.path.join(cfg.save_dir, cfg.exp_name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.logger = MetricLogger(os.path.join(self.run_dir,
                                                "metrics.jsonl"))
        self._stop_requested = False
        # top-2 best-AP retention (reference: callbacks/custom.py:9-29,
        # save_top_k=2): ckpt_best = argmax val/AP, ckpt_best2 = runner-up
        self._best_aps = [-1.0, -1.0]
        self._eval_det: Optional[Detector] = None
        self.det: Optional[Detector] = None
        self.ssod_batcher = None
        self.optimizer = self.schedule = None
        self.shards: Dict[str, list] = {"sharded": [], "replicated": []}

    def close(self):
        """Release the metrics JSONL handle (idempotent)."""
        self.logger.close()

    def request_stop(self):
        """Ask fit() to checkpoint and return at the next step boundary
        (the SIGTERM handler fit() installs calls it; safe from any
        thread)."""
        self._stop_requested = True

    # -- state -------------------------------------------------------------
    def init_state(self, batch_size: int, seed: int = 0) -> TrainState:
        """A fresh model from `seed`, a fresh optimizer, and zero states
        for `batch_size` slots (under a mesh, this rank's rows of the
        global slot table, and rank 0's weights on every rank: whole,
        then, on a model axis, cut to this rank's shards, on which the
        optimizer is made)."""
        self.det = Detector(self.cfg.model, dtype=self.dtype,
                            device=self.device, seed=seed, trainable=True)
        replicate(self.mesh, self.det.state_dict().values())
        self.shards = tensor.shard_params(self.det, self.mesh)
        self.optimizer, self.schedule = make_optimizer(
            self.cfg.training, self.det.parameters())
        return TrainState(states=shard_states(
            self.mesh, self.det.init_states(batch_size)), step=0)

    def _model_axis(self) -> bool:
        return self.mesh is not None and self.mesh.model > 1

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and BN statistics as whole tensors (on a
        model axis gathered over the model group: every rank calls it)."""
        sd = self.det.state_dict()
        if self._model_axis():
            sd = tensor.gather_state(self.det, self.mesh, sd)
        return sd

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Whole tensors (a checkpoint's, or a whole `Detector`'s state
        dict) into this rank's model: its shards of them on a model
        axis."""
        if self._model_axis():
            state = tensor.shard_state(self.det, self.mesh, state)
        self.det.load_state_dict(state)

    def replicate(self) -> None:
        """Rank 0's parameters and BN statistics on every rank of the
        mesh (no-op without one); on a model axis rank 0's whole tensors,
        gathered, broadcast and cut to each rank's shards again."""
        if not self._model_axis():
            replicate(self.mesh, self.det.state_dict().values())
            return
        whole = self.full_state_dict()
        replicate(self.mesh, whole.values())
        self.load_state(whole)

    def _ckpt_path(self, name: str) -> str:
        return os.path.join(self.run_dir, f"ckpt_{name}.pt")

    def save_checkpoint(self, state: TrainState, name: str = "last"):
        """Write ckpt_<name>.pt: the model's parameters and BN statistics,
        the optimizer's moments and count, the step and the best-AP
        retention state. Written to a temporary file and renamed, so a
        checkpoint on disk is never half written. Under a mesh every rank
        calls it: rank 0 writes, then all pass a barrier; on a model axis
        the parameters and the moments are first gathered whole, so that
        the file is the one a single process writes."""
        model = self.full_state_dict()
        opt = self.optimizer.state_dict()
        if self._model_axis():
            opt = tensor.gather_optimizer(self.det, self.mesh, opt)
        if pdist.is_primary():
            path = self._ckpt_path(name)
            payload = {"model": model, "optimizer": opt,
                       "step": int(state.step),
                       "best_aps": list(self._best_aps)}
            torch.save(payload, path + ".tmp")
            os.replace(path + ".tmp", path)
        pdist.barrier()

    def _checkpoint_candidates(self) -> List[str]:
        """All checkpoint files in the run dir, newest first."""
        cands = [os.path.join(self.run_dir, f)
                 for f in os.listdir(self.run_dir)
                 if f.startswith("ckpt_") and f.endswith(".pt")]
        return sorted(cands, key=os.path.getmtime, reverse=True)

    def _load(self, path: str) -> Dict[str, Any]:
        return torch.load(resolve_checkpoint(path), map_location=self.device,
                          weights_only=True)

    def latest_checkpoint(self) -> Optional[str]:
        """Newest checkpoint in the run dir that loads; unreadable ones
        are skipped (reference: train.py:71-95)."""
        for path in self._checkpoint_candidates():
            try:
                self._load(path)
                return path
            except Exception as e:                     # noqa: BLE001
                print(f"skipping corrupted checkpoint {path}: {e}")
        return None

    def restore_latest(self, state: TrainState):
        """Full resume from the newest RESTORABLE checkpoint, falling back
        past ones that do not load or restore (reference:
        train.py:85-92). Returns (state, path-or-None). Rank 0 picks the
        file and every other rank restores that one (no rank races rank
        0's writes)."""
        path = step = None
        if pdist.is_primary():
            for cand in self._checkpoint_candidates():
                try:
                    step = self._restore_local(cand)
                    path = cand
                    break
                except Exception as e:                 # noqa: BLE001
                    print(f"restore failed for {cand}, falling back: {e}")
        path = pdist.broadcast_object(path)
        if path is None:
            return state, None
        if not pdist.is_primary():
            step = self._restore_local(path)
        self.replicate()
        return TrainState(states=state.states, step=step), path

    def restore_checkpoint(self, path: str, state: TrainState) -> TrainState:
        """Full resume: weights, BN statistics, optimizer, step and the
        best-AP retention state; the stream states stay `state`'s."""
        step = self._restore_local(path)
        self.replicate()
        return TrainState(states=state.states, step=step)

    def _restore_local(self, path: str) -> int:
        """This rank's part of a restore: its model, optimizer and best-AP
        state from `path` (its shards of them on a model axis); returns
        the checkpoint's step."""
        payload = self._load(path)
        self.load_state(payload["model"])
        opt = payload["optimizer"]
        if self._model_axis():
            opt = tensor.shard_optimizer(self.det, self.mesh, opt)
        self.optimizer.load_state_dict(opt)
        self._best_aps = [float(v) for v in payload["best_aps"]]
        return int(payload["step"])

    def load_weights(self, path: str, state: TrainState) -> TrainState:
        """Weight-only resume (reference: modules/detection.py:583-594)."""
        self.load_state(load_variables(path, self.device))
        self.replicate()
        return state

    def _save_best(self, ap: float, state: TrainState) -> None:
        """Keep the TWO best-AP checkpoints: a new best demotes
        ckpt_best -> ckpt_best2; an AP beating only the runner-up
        overwrites ckpt_best2. Under a mesh `ap` is the same on every
        rank (the evaluators are all-gathered); rank 0 moves the
        files."""
        if ap > self._best_aps[0]:
            best = self._ckpt_path("best")
            if self._best_aps[0] >= 0 and pdist.is_primary() and \
                    os.path.exists(best):
                os.replace(best, self._ckpt_path("best2"))
            self._best_aps = [ap, self._best_aps[0]]
            self.save_checkpoint(state, "best")
        elif ap > self._best_aps[1]:
            self._best_aps[1] = ap
            self.save_checkpoint(state, "best2")

    # -- data ---------------------------------------------------------------
    def make_train_loader(self, seed: int = 0,
                          sequences: Optional[List[EventSequence]] = None):
        """Returns (loader, global batch size). `sequences` (already open,
        e.g. `ArrayEventSequence`s) replaces the train split's directory.
        Under several processes each builds only its slice of the global
        slot table: data shard p (`data_shard`: the process, or the
        mesh's data index, which the ranks of a space group share) feeds
        global slots [p*B_local, (p+1)*B_local) with stream seeds no
        other shard has (reference shards by rank*num_workers+worker,
        stream_sharded_datapipe.py:88-105); a mixed loader splits into
        its stream and random-access halves per shard."""
        cfg = self.cfg
        dst = cfg.dataset
        B = cfg.training.batch_size_train
        p, n = data_shard(self.mesh)
        rows = pdist.local_batch_slice(B, (p, n))
        b_local = rows.stop - rows.start
        seqs = sequences if sequences is not None else open_split_sequences(
            dst, "train", seq_ratio=dst.train_ratio)
        if cfg.training.ssod_online.enabled:
            # online SSOD needs continuous streams (the EMA teacher's
            # LSTM state tracks the weak view across windows)
            return StreamTrainLoader(seqs, dst, b_local, seed,
                                     slot_offset=rows.start, ssod=True), B
        mode = dst.train_sampling
        if mode == "stream":
            return StreamTrainLoader(seqs, dst, b_local, seed,
                                     slot_offset=rows.start), B
        if mode == "random":
            return RandomTrainLoader(seqs, dst, b_local, seed,
                                     slot_offset=rows.start), B
        if mode != "mixed":
            raise ValueError(f"train_sampling {mode!r}: 'stream', 'random' "
                             f"or 'mixed'")
        b_stream = max(b_local // 2, 1)
        b_rand = max(b_local - b_stream, 1)
        return MixedTrainLoader(
            StreamTrainLoader(seqs, dst, b_stream, seed,
                              slot_offset=p * b_stream),
            RandomTrainLoader(seqs, dst, b_rand, seed,
                              slot_offset=p * b_rand)), (b_stream + b_rand) * n

    # -- validation ----------------------------------------------------------
    def eval_detector(self) -> Detector:
        """The inference `Detector` (weights in the compute dtype, kernels
        on the card) holding the trained weights and BN statistics (this
        rank's shards of them on a model axis)."""
        if self._eval_det is None:
            self._eval_det = Detector(self.cfg.model, dtype=self.dtype,
                                      device=self.device)
            tensor.shard_params(self._eval_det, self.mesh)
        self._eval_det.load_state_dict(self.det.state_dict())
        return self._eval_det

    def validate(self, split: str = "val",
                 sequences: Optional[List[EventSequence]] = None
                 ) -> Optional[Dict[str, float]]:
        return run_streaming_eval(self.eval_detector(), self.cfg, split,
                                  sequences=sequences, device=self.device,
                                  mesh=self.mesh)

    # -- visualization -------------------------------------------------------
    def _viz_payload(self, hb: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Host-side data for one pred-vs-GT panel: the first harvested
        labeled frame of the batch (its event frame unfolded to
        [H, W, C], its GT boxes, and its row in the train step's
        preds)."""
        mask = hb["frame_mask"]
        rows = np.argwhere(mask)
        if len(rows) == 0:
            return None
        b, m = (int(v) for v in rows[0])
        t = int(hb["frame_t"][b, m])
        ev = np.asarray(hb["ev"][t, b])
        c = self.cfg.model.backbone.input_channels
        if ev.shape[-1] == 16 * c:             # stem-folded (harvest fold_hw)
            ev = unfold_ev_hw(ev)
        elif ev.shape[-1] != c:
            ev = unfold_ev_width(ev)
        return {"ev": ev.copy(), "gt": hb["boxes"][b][m],
                "row": b * mask.shape[1] + m}

    def _write_viz_panel(self, step: int, viz: Dict[str, Any],
                         preds: torch.Tensor) -> None:
        """Render pred (green) vs GT (black) boxes on the event frame
        into <run_dir>/viz/step<step>.png (reference:
        callbacks/detection.py:20-107); the postprocess runs on the
        model's device."""
        pp = self.cfg.model.postprocess
        dets, valid = postprocess(
            preds[viz["row"]][None].float(),
            num_classes=self.cfg.model.head.num_classes,
            conf_threshold=pp.confidence_threshold,
            nms_threshold=pp.nms_threshold,
            pre_topk=pp.pre_nms_topk, max_dets=pp.max_dets)
        d = dets[0][valid[0]].cpu().numpy()
        path = os.path.join(self.run_dir, "viz", f"step{step:08d}.png")
        if save_pred_vs_gt_panel(path, viz["ev"], d, viz["gt"]):
            print(f"viz panel -> {path}", flush=True)

    # -- loop ---------------------------------------------------------------
    @timing.traced
    def fit(self, max_steps: Optional[int] = None, seed: int = 0,
            eval_split: str = "val", state: Optional[TrainState] = None,
            log_every: int = 50, profile_steps: int = 0, *,
            sequences: Optional[List[EventSequence]] = None,
            val_sequences: Optional[List[EventSequence]] = None,
            timings: Optional[Dict[str, list]] = None) -> TrainState:
        """Train to `max_steps` (default `training.max_steps`) from
        `state` (default: `init_state`). profile_steps > 0 traces that
        many steps, from step 5, with `torch.profiler` into
        <run_dir>/profile (a Chrome trace of every thread, with the
        port's spans on while it runs). `sequences` / `val_sequences`
        replace the train / `eval_split` directories. `timings`, where
        given, collects host ms a step under "step_ms" (the step, ending
        in a device synchronize) and "wait_ms" (waiting for the
        prefetch thread), and seconds a validation under "val_s"; under
        online SSOD also "teacher_update_ms" (the EMA update and the
        refresh of the teacher's inference weights, ending in a device
        synchronize); and the port's tracer is on while fit runs
        (`timing`): each of those is a span, over the step's phases
        (`make_train_step`), and the prefetch thread records its
        "load", "harvest" and "upload" spans under the number of the
        step that consumes the batch.

        With `training.ssod_online.enabled`, an EMA teacher
        (`selftrain/online.py`, `self.ssod_batcher`) pseudo-labels the
        weak view of every batch in the prefetch thread, the student
        trains on the strong view, the harvest budget defaults to the
        whole window, and the teacher is updated after every step; its
        burn-in counter starts at the restored step.

        `training.remat` picks the TBPTT remat policy of the steps
        (`step.REMAT_POLICIES`); an unknown one raises here, before the
        loaders start.

        Under a mesh every rank calls fit: "frames_per_s" counts the
        global batch's frames, panels are off, the profiler traces rank
        0 only, the online SSOD teacher runs on
        the rank's own rows, the checkpoint timer (rank 0's clock) and
        the stop request (any rank's) are exchanged every
        `training.multihost_sync_every` steps so that all ranks
        checkpoint and leave together, and `timings` also collects the
        gradient all-reduce's ms a step under "allreduce_ms"."""
        cfg = self.cfg
        check_remat(cfg.training.remat)
        if cfg.training.ssod_online.enabled and self._model_axis():
            raise NotImplementedError(
                "online SSOD on a mesh with a model axis: the JAX package's "
                "teacher takes the first shard of each tensor-parallel "
                "weight there and fails (ROADMAP.md C.3)")
        total = max_steps or cfg.training.max_steps
        loader, B = self.make_train_loader(seed, sequences)
        if state is None:
            state = self.init_state(B, seed)
        ssod_batcher = None
        if cfg.training.ssod_online.enabled:
            # the teacher starts as a copy of the student; on resume it
            # re-initializes from the restored student (the EMA catches
            # up within ~1/(1-alpha) steps, so teacher state is not
            # checkpointed separately)
            from ..selftrain.online import OnlineSSODBatcher
            # the loader yields this rank's rows of the global batch;
            # the teacher's slot/state table matches them
            ssod_batcher = OnlineSSODBatcher(loader, self.det, cfg,
                                             B // self.data_degree,
                                             start_step=int(state.step))
            loader = ssod_batcher
        self.ssod_batcher = ssod_batcher
        # a panel reads one row of the step's preds: one data shard only,
        # drawn by rank 0 (a space rank's preds are whole)
        viz_every = (cfg.training.viz_every_steps
                     if self.data_degree == 1 and pdist.is_primary() else 0)
        train_step = make_train_step(self.det, self.optimizer,
                                     remat=cfg.training.remat,
                                     with_preds=viz_every > 0,
                                     gradflow=cfg.training.gradflow,
                                     mesh=self.mesh, timings=timings)
        M = (cfg.training.max_det_frames or
             (cfg.dataset.sequence_length if ssod_batcher is not None else
              default_frames_per_slot(cfg.dataset.sequence_length,
                                      cfg.model.use_label_every)))
        upload = _Uploader(self.device)
        last_ckpt_time = time.time()
        prev_handler = None
        try:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda sig, frame: self.request_stop())
        except ValueError:                          # not the main thread
            pass
        t0 = time.time()
        frames_seen = 0
        dropped_total = 0
        step = int(state.step)
        step0 = step
        profiler = None

        def device_batches():
            """Reads, harvest and the host-to-device copy, in the prefetch
            thread, so that they overlap the steps; each traced under
            the number of the step that consumes its batch."""
            batches = iter(loader)
            for i in itertools.count():
                # batch i is consumed by step (step0 + i + 1)
                n = step0 + i + 1
                with timing.span("load", batch=n):
                    batch = next(batches, None)
                if batch is None:
                    return
                with timing.span("harvest", batch=n):
                    hb = harvest_frames(
                        batch, M, cfg.model.head.max_gt,
                        cfg.model.backbone.in_res_hw,
                        use_label_every=cfg.model.use_label_every,
                        ignore_label=cfg.model.head.ignore_label,
                        ignore_image=cfg.model.ignore_image,
                        fold_hw=stem_fold_hw(cfg.model))
                with timing.span("upload", batch=n):
                    dev, done = upload(hb)
                meta = {"frames": batch["ev"].shape[0] * batch["ev"].shape[1],
                        "dropped_frames": hb["dropped_frames"]}
                if viz_every and n % viz_every == 0:
                    meta["viz"] = self._viz_payload(hb)
                yield dev, done, meta

        stopped = False
        prefetcher = Prefetcher(device_batches(), depth=3)
        try:
            it = iter(prefetcher)
            while step < total:
                with timing.lap(timings, "wait_ms", batch=step + 1):
                    item = next(it, None)
                    if item is not None:
                        dev, done, meta = item
                        upload.ready(dev, done)
                        if profile_steps and step == 5 and \
                                pdist.is_primary():
                            profiler = _start_profile(self.device)
                if item is None:
                    break
                with timing.lap(timings, "step_ms", self.device,
                                batch=step + 1):
                    state, metrics = train_step(state, dev)
                step += 1
                if ssod_batcher is not None:
                    with timing.lap(timings, "teacher_update_ms",
                                    self.device, batch=step):
                        ssod_batcher.update_teacher(self.det, step)
                preds = metrics.pop("preds", None)
                if meta.get("viz") is not None and preds is not None:
                    self._write_viz_panel(step, meta["viz"], preds)
                if profiler is not None and step == 5 + profile_steps:
                    profiler = _stop_profile(profiler, self.run_dir)
                # local frames x data shards = the global batch's frames
                frames_seen += meta["frames"] * self.data_degree
                dropped_total += meta["dropped_frames"]
                if step % log_every == 0 or step == 1:
                    dt = time.time() - t0
                    rec = {"step": step,
                           "lr": (self.schedule(step - 1)
                                  if callable(self.schedule)
                                  else self.schedule),
                           "frames_per_s": frames_seen / max(dt, 1e-6),
                           **{k: float(v) for k, v in metrics.items()}}
                    if dropped_total:
                        rec["dropped_frames_total"] = dropped_total
                    self.logger.log(rec)
                # the time-triggered checkpoint and the stop are
                # RANK-CONSISTENT: a rank that leaves the loop (or writes)
                # alone would wait forever in the others' next collective.
                # Under a mesh they are exchanged every
                # multihost_sync_every steps: rank 0's clock binds
                # everyone, any rank's stop request stops everyone
                ckpt_due = ((time.time() - last_ckpt_time) / 60
                            >= cfg.training.ckpt_every_min)
                stop = self._stop_requested
                if self.mesh is not None and self.mesh.world > 1:
                    if step % cfg.training.multihost_sync_every == 0:
                        ckpt_due, stop = pdist.any_all(
                            [ckpt_due, stop], self.mesh.group,
                            first_from_primary=(0,))
                    else:
                        ckpt_due = stop = False
                if ckpt_due or stop:
                    self.save_checkpoint(state, "last")
                    last_ckpt_time = time.time()
                if stop:
                    print(f"stop requested: checkpointed at step {step}, "
                          f"exiting fit()", flush=True)
                    stopped = True
                    break
                if (cfg.training.val_check_interval and step %
                        cfg.training.val_check_interval == 0):
                    tv = time.perf_counter()
                    m = self.validate(eval_split, val_sequences)
                    if timings is not None:
                        timings.setdefault("val_s", []).append(
                            time.perf_counter() - tv)
                    if m:
                        self.logger.log(
                            {"step": step,
                             **{f"val/{k}": v for k, v in m.items()}})
                        self._save_best(float(m["AP"]), state)
            # the stop path already wrote ckpt_last
            if not stopped:
                self.save_checkpoint(state, "last")
        finally:
            prefetcher.close()
            if profiler is not None:
                _stop_profile(profiler, self.run_dir)
            # consume the stop request and restore the handler, so that
            # a stale flag or a leaked handler cannot touch the NEXT fit()
            self._stop_requested = False
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        return state
