"""Online SSOD: an EMA teacher on weak views supervises the student on
strong views, within one training loop (port of
`leod_tpu/selftrain/online.py`).

`StreamTrainLoader(ssod=True)` yields weak/strong paired batches;
`OnlineSSODBatcher` runs the teacher on the weak view inside the
prefetch thread and emits ordinary train batches in the strong view with
pseudo+GT merged labels, and `Trainer.fit` EMA-updates the teacher after
every optimizer step (reference EMA semantics incl. the true-average
warm-up: modules/utils/ssod.py:429-460).

The teacher keeps an fp32 master copy of the student's parameters and
BN statistics, so that a slow EMA (1 - alpha = 1e-3) is not rounded
away, and an inference `Detector` holding them in the compute dtype,
whose eval step runs the block, ConvLSTM and NMS kernels on the card.
The inference copy is refreshed after every update. The teacher runs in
the prefetch thread on the same CUDA stream as the student's step: the
stream orders the refresh after the teacher's reads that were enqueued
before it (a lock keeps the two host sections apart), and the teacher's
work does not overlap the student's on the card.

Under data parallelism each rank keeps its own teacher: it runs on the
rank's card over the rank's rows of the global batch (B_local slots,
`Trainer.fit`), and takes its EMA from the rank's replicated student, so
the ranks' teachers stay equal and no collective runs in the prefetch
thread.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.augment import weak_to_strong_boxes
from ..models.detector import Detector
from ..ops.nms import postprocess
from ..train.step import make_eval_step
from .filters import pred_to_label
from .runner import harvest_all_frames

TeacherState = Dict[str, torch.Tensor]


def make_teacher_update(method: str = "ema", alpha: float = 0.999):
    """-> update(teacher, student, step) -> teacher, on state dicts
    ({name: tensor}); the fp32 teacher is updated in place.

    'ema': exponential moving average with the SoftTeacher/3DIoUMatch
    true-average warm-up alpha_t = min(1 - 1/(step+1), alpha), in fp32.
    'every-N': hard copy of the student every N steps.
    Entries that are not floating point (BN's batch counters) are copied.
    (reference: modules/utils/ssod.py:429-460)
    """
    method = method.lower()
    if method == "ema":
        @torch.no_grad()
        def update(teacher: TeacherState, student: TeacherState, step: int):
            one = np.float32(1.0)
            a = np.minimum(one - one / (np.float32(step) + one),
                           np.float32(alpha))
            floats = []
            for k, t in teacher.items():
                if t.is_floating_point():
                    floats.append(k)
                else:
                    t.copy_(student[k])
            if not floats:
                return teacher
            # every leaf at once, in a few launches: a * t + (1 - a) * s
            # rounded as XLA's fused multiply-add rounds it: (1 - a) * s
            # to fp32, then a * t exactly (an fp32 product fits a
            # double), one rounding of the sum
            ts = [teacher[k] for k in floats]
            t_all = torch.cat([t.reshape(-1) for t in ts])
            s_all = torch.cat([student[k].reshape(-1).float() for k in floats])
            new = (t_all.double() * float(a)
                   + (s_all * float(one - a)).double()).float()
            torch._foreach_copy_(ts, [v.view_as(t) for v, t in zip(
                new.split([t.numel() for t in ts]), ts)])
            return teacher
        return update
    if method.startswith("every-"):
        n = int(method.split("-")[-1])

        @torch.no_grad()
        def update(teacher: TeacherState, student: TeacherState, step: int):
            if (int(step) + 1) % n == 0:
                for k, t in teacher.items():
                    t.copy_(student[k])
            return teacher
        return update
    raise ValueError(f"unknown teacher update method: {method}")


class OnlineSSODBatcher:
    """Wraps an ssod=True stream loader into a plain train-batch source.

    For each paired batch: run the (frozen-this-step) EMA teacher over
    the weak view at every timestep, threshold-filter the detections
    into pseudo boxes, map them into the strong view's coordinate space
    (augment.weak_to_strong_boxes), merge with the strong view's GT
    (GT wins on its frames), and yield the strong batch. The output has
    exactly the collate() schema, so the trainer's harvest/device path
    is unchanged.

    Teacher LSTM state tracks the weak stream continuously from step 0
    (slots are infinite streams — skipping inference during burn-in
    would leave the teacher cold at the handover), but pseudo labels
    only merge once `burn_in_steps` batches have been consumed.

    `merged` holds the number of pseudo boxes merged into each batch
    yielded (0 during burn-in), `teacher_ms` the host ms of each batch's
    teacher pass (harvest, eval step, NMS, to numpy).
    """

    def __init__(self, loader, det: Detector, cfg: ExperimentConfig,
                 batch_size: int, start_step: int = 0):
        """`det`: the student (its state dict seeds the teacher);
        `batch_size`: the loader's slots (a rank's B_local under data
        parallelism)."""
        oc = cfg.training.ssod_online
        self.loader = loader
        self.cfg = cfg
        self.oc = oc
        self.teacher: TeacherState = {
            k: (v.detach().float().clone() if v.is_floating_point()
                else v.detach().clone())
            for k, v in det.state_dict().items()}
        self.teacher_det = Detector(cfg.model, dtype=det.dtype,
                                    device=det.device)
        self.teacher_det.load_state_dict(self.teacher)
        self._eval_step = make_eval_step(self.teacher_det,
                                         device=det.device)
        self._update = make_teacher_update(oc.update_method, oc.alpha)
        self.states = self.teacher_det.init_states(batch_size)
        self.lens = np.zeros(batch_size, np.int64)
        # burn-in is counted in batches == optimizer steps; seed from the
        # restored step so a resumed run does not re-impose the full
        # GT-only burn-in after every preemption
        self.batches_out = int(start_step)
        self.merged: List[int] = []
        self.teacher_ms: List[float] = []
        # teacher inference runs in the prefetch thread, the EMA update
        # and the refresh of the inference weights in the fit loop
        self._teacher_lock = threading.Lock()

    # -- teacher maintenance (called by the fit loop after each step) ----
    def update_teacher(self, student: Detector, step: int):
        with self._teacher_lock:
            self._update(self.teacher, student.state_dict(), step)
            self.teacher_det.load_state_dict(self.teacher)

    # -- batch production ------------------------------------------------
    def _teacher_dets(self, weak: Dict[str, Any]):
        cfg = self.cfg
        hb = harvest_all_frames(weak, cfg)
        with self._teacher_lock:
            self.states, preds = self._eval_step(self.states, hb)
        pp = cfg.model.postprocess
        dets, valid = postprocess(preds,
                                  num_classes=cfg.model.head.num_classes,
                                  conf_threshold=pp.confidence_threshold,
                                  nms_threshold=pp.nms_threshold,
                                  pre_topk=pp.pre_nms_topk,
                                  max_dets=pp.max_dets)
        return dets.cpu().numpy(), valid.cpu().numpy()

    def _merge(self, pair: Dict[str, Any], dets, valid) -> Dict[str, Any]:
        cfg, oc = self.cfg, self.oc
        weak, strong = pair["weak"], pair["strong"]
        dst = cfg.dataset
        hw = dst.loading_hw
        L, B = weak["ev"].shape[:2]
        labels: List[List[Optional[Any]]] = [list(row)
                                             for row in strong["labels"]]
        for b in range(B):
            for t in range(L):
                if strong["is_padded"][b, t]:
                    continue
                if labels[t][b] is not None and oc.use_gt:
                    continue                      # GT wins on its frames
                if self.lens[b] + t < oc.skip_first_t:
                    continue                      # cold RNN after reset
                d = dets[b * L + t][valid[b * L + t]]
                pseudo = pred_to_label(
                    d if len(d) else None, hw,
                    obj_thresh=oc.obj_thresh, cls_thresh=oc.cls_thresh,
                    dataset=dst.name,
                    downsampled_by_2=dst.downsample_by_factor_2)
                if len(pseudo) == 0:
                    continue
                mapped = weak_to_strong_boxes(pseudo,
                                              pair["weak_params"][b],
                                              pair["strong_applied"][b])
                labels[t][b] = mapped if len(mapped) else None
        out = dict(strong)
        out["labels"] = labels
        return out

    def __iter__(self):
        for pair in self.loader:
            weak = pair["weak"]
            self.lens[np.asarray(weak["is_first"], bool)] = 0
            t0 = time.perf_counter()
            dets, valid = self._teacher_dets(weak)
            self.teacher_ms.append((time.perf_counter() - t0) * 1e3)
            if self.batches_out >= self.oc.burn_in_steps:
                batch = self._merge(pair, dets, valid)
            else:
                batch = pair["strong"]
            self.merged.append(sum(
                len(lab) for row, srow in zip(batch["labels"],
                                              pair["strong"]["labels"])
                for lab, slab in zip(row, srow)
                if lab is not None and lab is not slab))
            self.lens += weak["ev"].shape[0]
            self.batches_out += 1
            yield batch
