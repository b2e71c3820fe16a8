"""Training orchestration and streaming evaluation (port of
`leod_tpu/train/trainer.py:68-731`, single device).

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
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import ExperimentConfig, stem_fold_hw
from ..data.loader import (EvalStreamLoader, MixedTrainLoader, Prefetcher,
                           RandomTrainLoader, StreamTrainLoader,
                           harvest_frames, open_split_sequences)
from ..data.sequence import EventSequence
from ..eval.prophesee import PropheseeEvaluator, boxes_to_prophesee
from ..models.detector import Detector
from ..models.layers import unfold_ev_hw, unfold_ev_width
from ..ops.nms import postprocess
from ..timing import lap
from ..utils.viz import save_pred_vs_gt_panel
from .optim import make_optimizer
from .step import TrainState, make_eval_step, make_train_step

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


def run_streaming_eval(det: Detector, cfg: ExperimentConfig,
                       split: str = "val", batch_size: Optional[int] = None,
                       frames_per_slot: Optional[int] = None,
                       conf_threshold: Optional[float] = None,
                       max_batches: Optional[int] = None,
                       time_flip: bool = False,
                       shard_index: int = 0, num_shards: int = 1,
                       evaluator: Optional[PropheseeEvaluator] = None, *,
                       sequences: Optional[List[EventSequence]] = None,
                       plain: bool = False, device="cuda",
                       on_batch: Optional[Callable] = None,
                       timings: Optional[Dict[str, list]] = None
                       ) -> Optional[Dict[str, float]]:
    """Full streaming evaluation of a split -> Prophesee COCO metrics
    (reference: modules/detection.py:300-463, val.py).

    The split's sequences are dealt over B stream slots (shard
    `shard_index` of `num_shards`); with several shards, pass one
    `evaluator` per shard and combine them with
    `PropheseeEvaluator.merge`. `sequences` (already open, e.g.
    `ArrayEventSequence`s) replaces the split's directory. `det` must live
    on `device` (`cuda` unless the caller asks for `cpu`); plain=True
    runs the kernels' plain versions.

    on_batch(batch_index, harvested, preds, dets, valid) is called after
    the NMS of every batch with labeled frames (dets and valid as numpy).
    `timings`, where given, collects host ms a batch under "harvest_ms",
    "step_ms" (ending in a device synchronize), "postprocess_ms" and
    "bridge_ms", and "evaluate_ms" once."""
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
    B = min(B, len(seqs))
    loader = EvalStreamLoader(seqs, dst, B, time_flip=time_flip,
                              shard_index=shard_index, num_shards=num_shards)
    M = frames_per_slot or default_frames_per_slot(dst.sequence_length)
    pp = cfg.model.postprocess
    conf = conf_threshold if conf_threshold is not None else pp.confidence_threshold

    eval_step = make_eval_step(det, plain=plain, device=dev)
    if evaluator is None:
        evaluator = PropheseeEvaluator(dst.name, dst.downsample_by_factor_2)
    states = det.init_states(B)
    n_cls = cfg.model.head.num_classes

    prefetcher = Prefetcher(iter(loader))
    try:
        for bi, batch in enumerate(prefetcher):
            if max_batches is not None and bi >= max_batches:
                break
            t0 = time.perf_counter()
            while True:
                hb = harvest_frames(batch, M, cfg.model.head.max_gt,
                                    cfg.model.backbone.in_res_hw,
                                    fold_hw=stem_fold_hw(cfg.model))
                if not hb["dropped_frames"]:
                    break
                # dropped eval frames would silently bias mAP (the
                # reference harvests ragged and can never drop,
                # modules/utils/detection.py:27-58): regrow the static
                # budget to this batch's demand and re-harvest
                M = int(hb["max_slot_frames"])
                print(f"eval harvest budget grown to {M}/slot", flush=True)
            t0 = lap(timings, "harvest_ms", t0)
            states, preds = eval_step(states, hb)
            t0 = lap(timings, "step_ms", t0, det.device)
            if hb["num_frames"] == 0:
                continue
            dets, valid = postprocess(preds, num_classes=n_cls,
                                      conf_threshold=conf,
                                      nms_threshold=pp.nms_threshold,
                                      pre_topk=pp.pre_nms_topk,
                                      max_dets=pp.max_dets, plain=plain)
            dets = dets.cpu().numpy()
            valid = valid.cpu().numpy()
            t0 = lap(timings, "postprocess_ms", t0)
            # rows are (b, m) flattened with b outer
            Mslot = hb["frame_t"].shape[1]
            for b in range(len(hb["boxes"])):
                for m in range(Mslot):
                    lab = hb["boxes"][b][m]
                    if lab is None:
                        continue
                    row = b * Mslot + m
                    d = dets[row][valid[row]]
                    gt, dt = boxes_to_prophesee(lab, d if len(d) else None)
                    evaluator.add_labels([gt])
                    evaluator.add_predictions([dt])
            lap(timings, "bridge_ms", t0)
            if on_batch is not None:
                on_batch(bi, hb, preds, dets, valid)
    finally:
        # join the producer even on an exception path (and on the
        # max_batches early break)
        prefetcher.close()
        for s in seqs:
            s.close()
    t0 = time.perf_counter()
    metrics = evaluator.evaluate()
    if timings is not None:
        timings["evaluate_ms"] = (time.perf_counter() - t0) * 1e3
    return metrics


class MetricLogger:
    """JSONL + stdout metrics with pluggable sinks
    (`leod_tpu/train/trainer.py:84-153`, one process). Each sink is
    called with the plain-float record of every log call; a sink's
    exception is reported and never stops training."""

    def __init__(self, path: Optional[str]):
        self._sinks: list = []
        self._f = None
        if path:
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
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, run_dir: str) -> None:
    """End the trace and write it to <run_dir>/profile/trace.json."""
    prof.__exit__(None, None, None)
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
    """Single-device training of `cfg` (the JAX package's `Trainer`
    without a mesh). The trainable model (`self.det`, fp32 parameters
    computing in `dtype`) and the optimizer are built by `init_state`
    (which `fit` calls when given no state), and updated in place by
    every step and by a restore."""

    def __init__(self, cfg: ExperimentConfig, dtype=torch.bfloat16,
                 device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
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
        for `batch_size` slots."""
        self.det = Detector(self.cfg.model, dtype=self.dtype,
                            device=self.device, seed=seed, trainable=True)
        self.optimizer, self.schedule = make_optimizer(
            self.cfg.training, self.det.parameters())
        return TrainState(states=self.det.init_states(batch_size), step=0)

    def _ckpt_path(self, name: str) -> str:
        return os.path.join(self.run_dir, f"ckpt_{name}.pt")

    def save_checkpoint(self, state: TrainState, name: str = "last"):
        """Write ckpt_<name>.pt: the model's parameters and BN statistics,
        the optimizer's moments and count, the step and the best-AP
        retention state. Written to a temporary file and renamed, so a
        checkpoint on disk is never half written."""
        path = self._ckpt_path(name)
        payload = {"model": self.det.state_dict(),
                   "optimizer": self.optimizer.state_dict(),
                   "step": int(state.step),
                   "best_aps": list(self._best_aps)}
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

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
        past ones that do not load (reference: train.py:85-92). Returns
        (state, path-or-None)."""
        for path in self._checkpoint_candidates():
            try:
                return self.restore_checkpoint(path, state), path
            except Exception as e:                     # noqa: BLE001
                print(f"restore failed for {path}, falling back: {e}")
        return state, None

    def restore_checkpoint(self, path: str, state: TrainState) -> TrainState:
        """Full resume: weights, BN statistics, optimizer, step and the
        best-AP retention state; the stream states stay `state`'s."""
        payload = self._load(path)
        self.det.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self._best_aps = [float(v) for v in payload["best_aps"]]
        return TrainState(states=state.states, step=int(payload["step"]))

    def load_weights(self, path: str, state: TrainState) -> TrainState:
        """Weight-only resume (reference: modules/detection.py:583-594)."""
        self.det.load_state_dict(load_variables(path, self.device))
        return state

    def _save_best(self, ap: float, state: TrainState) -> None:
        """Keep the TWO best-AP checkpoints: a new best demotes
        ckpt_best -> ckpt_best2; an AP beating only the runner-up
        overwrites ckpt_best2."""
        if ap > self._best_aps[0]:
            best = self._ckpt_path("best")
            if self._best_aps[0] >= 0 and os.path.exists(best):
                os.replace(best, self._ckpt_path("best2"))
            self._best_aps = [ap, self._best_aps[0]]
            self.save_checkpoint(state, "best")
        elif ap > self._best_aps[1]:
            self._best_aps[1] = ap
            self.save_checkpoint(state, "best2")

    # -- data ---------------------------------------------------------------
    def make_train_loader(self, seed: int = 0,
                          sequences: Optional[List[EventSequence]] = None):
        """Returns (loader, batch size). `sequences` (already open, e.g.
        `ArrayEventSequence`s) replaces the train split's directory."""
        cfg = self.cfg
        dst = cfg.dataset
        B = cfg.training.batch_size_train
        seqs = sequences if sequences is not None else open_split_sequences(
            dst, "train", seq_ratio=dst.train_ratio)
        if cfg.training.ssod_online.enabled:
            # online SSOD needs continuous streams (the EMA teacher's
            # LSTM state tracks the weak view across windows)
            return StreamTrainLoader(seqs, dst, B, seed, ssod=True), B
        mode = dst.train_sampling
        if mode == "stream":
            return StreamTrainLoader(seqs, dst, B, seed), B
        if mode == "random":
            return RandomTrainLoader(seqs, dst, B, seed), B
        if mode != "mixed":
            raise ValueError(f"train_sampling {mode!r}: 'stream', 'random' "
                             f"or 'mixed'")
        b_stream = max(B // 2, 1)
        b_rand = max(B - b_stream, 1)
        return MixedTrainLoader(
            StreamTrainLoader(seqs, dst, b_stream, seed),
            RandomTrainLoader(seqs, dst, b_rand, seed)), b_stream + b_rand

    # -- validation ----------------------------------------------------------
    def eval_detector(self) -> Detector:
        """The inference `Detector` (weights in the compute dtype, kernels
        on the card) holding the trained weights and BN statistics."""
        if self._eval_det is None:
            self._eval_det = Detector(self.cfg.model, dtype=self.dtype,
                                      device=self.device)
        self._eval_det.load_state_dict(self.det.state_dict())
        return self._eval_det

    def validate(self, split: str = "val",
                 sequences: Optional[List[EventSequence]] = None
                 ) -> Optional[Dict[str, float]]:
        return run_streaming_eval(self.eval_detector(), self.cfg, split,
                                  sequences=sequences, device=self.device)

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
    def fit(self, max_steps: Optional[int] = None, seed: int = 0,
            eval_split: str = "val", state: Optional[TrainState] = None,
            log_every: int = 50, profile_steps: int = 0, *,
            sequences: Optional[List[EventSequence]] = None,
            val_sequences: Optional[List[EventSequence]] = None,
            timings: Optional[Dict[str, list]] = None) -> TrainState:
        """Train to `max_steps` (default `training.max_steps`) from
        `state` (default: `init_state`). profile_steps > 0 traces that
        many steps, from step 5, with `torch.profiler` into
        <run_dir>/profile (a Chrome trace). `sequences` / `val_sequences`
        replace the train / `eval_split` directories. `timings`, where
        given, collects host ms a step under "step_ms" (the step, ending
        in a device synchronize) and "wait_ms" (waiting for the
        prefetch thread), and seconds a validation under "val_s"; under
        online SSOD also "teacher_update_ms" (the EMA update and the
        refresh of the teacher's inference weights, ending in a device
        synchronize).

        With `training.ssod_online.enabled`, an EMA teacher
        (`selftrain/online.py`, `self.ssod_batcher`) pseudo-labels the
        weak view of every batch in the prefetch thread, the student
        trains on the strong view, the harvest budget defaults to the
        whole window, and the teacher is updated after every step; its
        burn-in counter starts at the restored step."""
        cfg = self.cfg
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
            ssod_batcher = OnlineSSODBatcher(loader, self.det, cfg, B,
                                             start_step=int(state.step))
            loader = ssod_batcher
        self.ssod_batcher = ssod_batcher
        viz_every = cfg.training.viz_every_steps
        train_step = make_train_step(self.det, self.optimizer,
                                     remat=cfg.training.remat,
                                     with_preds=viz_every > 0,
                                     gradflow=cfg.training.gradflow)
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
            """Harvest and the host-to-device copy, in the prefetch
            thread, so that they overlap the steps."""
            for i, batch in enumerate(loader):
                hb = harvest_frames(batch, M, cfg.model.head.max_gt,
                                    cfg.model.backbone.in_res_hw,
                                    use_label_every=cfg.model.use_label_every,
                                    ignore_label=cfg.model.head.ignore_label,
                                    ignore_image=cfg.model.ignore_image,
                                    fold_hw=stem_fold_hw(cfg.model))
                dev, done = upload(hb)
                meta = {"frames": batch["ev"].shape[0] * batch["ev"].shape[1],
                        "dropped_frames": hb["dropped_frames"]}
                # batch i is consumed by step (step0 + i + 1)
                if viz_every and (step0 + i + 1) % viz_every == 0:
                    meta["viz"] = self._viz_payload(hb)
                yield dev, done, meta

        stopped = False
        prefetcher = Prefetcher(device_batches(), depth=3)
        try:
            it = iter(prefetcher)
            while step < total:
                tw = time.perf_counter()
                item = next(it, None)
                if item is None:
                    break
                dev, done, meta = item
                upload.ready(dev, done)
                if profile_steps and step == 5:
                    profiler = _start_profile(self.device)
                ts = lap(timings, "wait_ms", tw)
                state, metrics = train_step(state, dev)
                ts = lap(timings, "step_ms", ts, self.device)
                step += 1
                if ssod_batcher is not None:
                    ssod_batcher.update_teacher(self.det, step)
                    lap(timings, "teacher_update_ms", ts, self.device)
                preds = metrics.pop("preds", None)
                if meta.get("viz") is not None and preds is not None:
                    self._write_viz_panel(step, meta["viz"], preds)
                if profiler is not None and step == 5 + profile_steps:
                    profiler = _stop_profile(profiler, self.run_dir)
                frames_seen += meta["frames"]
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
                ckpt_due = ((time.time() - last_ckpt_time) / 60
                            >= cfg.training.ckpt_every_min)
                stop = self._stop_requested
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
