"""Pseudo-label generation: LEOD's core self-training loop (port of
`leod_tpu/selftrain/pseudo_labeler.py`).

Reference: modules/pseudo_labeler.py — the teacher model streams the
training split, predicts boxes on every frame without a kept GT label,
filters them by per-class confidence + geometry, optionally merges
h-flip / t-flip TTA views by NMS, runs the offline linear tracker
forward (and backward) to mark short-tracklet boxes as ignore and to
inpaint tracker-predicted ignore boxes at missed frames, and writes a
new dataset (labels.npz + index maps, event h5 symlinked) in the exact
native format so the student re-trains on it unchanged.

One seam against the JAX package: a recorder takes its source sequence
(`source=`), and `save` counts the frames by the source's `num_ev_repr`
instead of opening the h5 (a machine may lack `h5py`). The h5 is
symlinked, and the split's val/test linked at the root, only where the
source has a file; an array-backed source (`ArrayEventSequence`) gets
the same `labels.npz` and `objframe_idx_2_repr_idx.npy`, and
`load_pseudo_sequences` pairs them with its frames again.
"""
from __future__ import annotations

import dataclasses
import os
import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DatasetConfig, PostprocessConfig
from ..data.labels import BBOX_DTYPE, Boxes
from ..data.sequence import (ArrayEventSequence, EventSequence, ev_h5_path,
                             ev_repr_dir, labels_npz_path, list_sequence_dirs)
from ..ops.nms import batched_nms_numpy
from .tracker import LinearTracker


@dataclass(frozen=True)
class PseudoLabelConfig:
    """(reference: config/model/pseudo_labeler.yaml)"""
    skip_first_t: int = 0
    obj_thresh: Tuple[float, ...] = (0.6, 0.3)
    cls_thresh: Tuple[float, ...] = (0.6, 0.3)
    min_track_len: int = 6
    track_method: str = "forward or backward"
    inpaint: bool = True
    ignore_label: int = 1024
    tta_hflip: bool = False
    tta_tflip: bool = False
    use_gt: bool = True


def tta_merge_nms(labels: List[Optional[Boxes]], conf_threshold: float,
                  nms_threshold: float) -> List[Optional[Boxes]]:
    """Merge aggregated TTA predictions per frame by NMS; frames holding
    any GT box pass through untouched (reference: pseudo_labeler.py:37-91)."""
    out: List[Optional[Boxes]] = []
    for lab in labels:
        if lab is None or len(lab) == 0:
            out.append(lab)
            continue
        if lab.is_gt().any():
            out.append(lab)
            continue
        score = lab.objectness * lab.class_confidence
        keep = score >= conf_threshold
        sel = lab.select(keep)
        if len(sel) == 0:
            out.append(Boxes.empty(lab.size_hw))
            continue
        kept = batched_nms_numpy(sel.xyxy(),
                                 sel.objectness * sel.class_confidence,
                                 sel.class_id, nms_threshold)
        out.append(sel.select(kept))
    return out


class SequenceRecorder:
    """Accumulates per-frame labels of one sequence across streaming
    windows and TTA views (reference: EventSeqData, pseudo_labeler.py:94-407)."""

    def __init__(self, seq_dir: str, scale_ratio: float,
                 cfg: PseudoLabelConfig, postproc: PostprocessConfig,
                 source: Optional[EventSequence] = None):
        """`source`: the sequence the labels belong to (its frame count,
        and its h5 where it has one); without it, `save` opens
        `seq_dir` from disk."""
        self.seq_dir = seq_dir
        self.source = source
        self.scale_ratio = scale_ratio
        self.cfg = cfg
        self.postproc = postproc
        self.frame_labels: Dict[int, Boxes] = {}
        self.ended = False
        self.augmented = False

    def update(self, labels: Sequence[Optional[Boxes]], ev_idx: Sequence[int],
               is_last_sample: bool, is_padded: Sequence[bool],
               is_hflip: bool, is_tflip: bool, tflip_offset: int):
        self.ended = self.ended or is_last_sample
        if is_hflip or is_tflip:
            self.augmented = True
        for t, (lab, fi) in enumerate(zip(labels, ev_idx)):
            if fi < 0 or lab is None or len(lab) == 0:
                continue
            assert not is_padded[t]
            frame = int(fi) + (tflip_offset if is_tflip else 0)
            lab = lab.flip_lr() if is_hflip else lab.copy()
            # labels saved at original (undownsampled) resolution
            if self.scale_ratio != 1:
                lab = lab.scale(self.scale_ratio)
            if frame in self.frame_labels:
                existing = self.frame_labels[frame]
                if lab.is_gt().any():
                    continue        # GT recorded once; other views dropped
                if existing.is_gt().any():
                    continue
                self.frame_labels[frame] = existing.concat(lab)
            else:
                self.frame_labels[frame] = lab

    # -- aggregation ----------------------------------------------------------
    def _aggregate(self, num_frames: int):
        idx = sorted(i for i in self.frame_labels if 0 <= i < num_frames)
        self.frame_idx = idx
        self.labels = [self.frame_labels[i] for i in idx]
        if self.augmented:
            self.labels = tta_merge_nms(self.labels,
                                        self.postproc.confidence_threshold,
                                        self.postproc.nms_threshold)
        # drop frames that became empty
        keep = [i for i, l in enumerate(self.labels)
                if l is not None and len(l) > 0]
        self.frame_idx = [self.frame_idx[i] for i in keep]
        self.labels = [self.labels[i] for i in keep]

    def _run_tracker(self, labels: List[Boxes], frame_idx: List[int],
                     inpaint: bool):
        """Track, return (remove set of global bbox indices, inpaint dict)
        (reference: pseudo_labeler.py:201-266)."""
        if not labels:
            return set(), {}
        tracker = LinearTracker(img_hw=labels[0].size_hw)
        fset = {f: i for i, f in enumerate(frame_idx)}
        for f in range(max(frame_idx) + 1):
            if f not in fset:
                tracker.update(f, np.zeros((0, 5)))
                continue
            lab = labels[fset[f]]
            dets = np.stack([lab.x + lab.w / 2, lab.y + lab.h / 2,
                             lab.w, lab.h, lab.class_id], -1)
            tracker.update(f, dets, lab.is_gt())
        tracker.finish()
        remove = set()
        bi = 0
        min_len = self.cfg.min_track_len
        for lab in labels:
            for _ in range(len(lab)):
                trk = tracker.tracklet_of_bbox(bi)
                if trk.done and not trk.is_gt and trk.hits < min_len:
                    remove.add(bi)
                bi += 1
        inpainted: Dict[int, List[np.ndarray]] = {}
        if inpaint:
            for trk in tracker.finished:
                if trk.done and not trk.is_gt and trk.hits < min_len:
                    continue
                for f, bbox in trk.missed_bbox.items():
                    inpainted.setdefault(f, []).append(bbox)
        return remove, inpainted

    def _track_filter(self):
        """Forward (+ backward) track filtering + inpainting
        (reference: pseudo_labeler.py:268-333)."""
        cfg = self.cfg
        if not self.labels or cfg.min_track_len <= 0:
            return
        remove, inpainted = self._run_tracker(self.labels, self.frame_idx,
                                              inpaint=cfg.inpaint)
        if "backward" in cfg.track_method:
            rev_labels = [Boxes(l.arr[::-1].copy(), l.size_hw)
                          for l in self.labels[::-1]]
            top = max(self.frame_idx)
            rev_idx = [top - i for i in self.frame_idx[::-1]]
            bwd_remove, _ = self._run_tracker(rev_labels, rev_idx,
                                              inpaint=False)
            n = sum(len(l) for l in self.labels)
            bwd_remove = {n - i - 1 for i in bwd_remove}
            remove &= bwd_remove        # ignore only if short in BOTH passes
        # mark removed boxes with the ignore class
        bi = 0
        for lab in self.labels:
            for r in range(len(lab)):
                if bi in remove:
                    assert lab.is_pseudo().all(), "ignoring a GT box"
                    lab.arr[r, 5] = cfg.ignore_label
                bi += 1
        # inpaint tracker-predicted boxes at missed frames as ignore regions
        for f, boxes in sorted(inpainted.items()):
            arr = np.zeros((len(boxes), 8), np.float32)
            b = np.stack(boxes)          # [n, 5] center xywh + cls
            arr[:, 1] = b[:, 0] - b[:, 2] / 2
            arr[:, 2] = b[:, 1] - b[:, 3] / 2
            arr[:, 3] = b[:, 2]
            arr[:, 4] = b[:, 3]
            arr[:, 5] = cfg.ignore_label
            lab = Boxes(arr, self.labels[0].size_hw)
            if f in self.frame_idx:
                i = self.frame_idx.index(f)
                assert self.labels[i].is_pseudo().all(), \
                    "inpainting into a GT frame"
                self.labels[i] = self.labels[i].concat(lab)
            else:
                self.frame_idx.append(f)
                self.labels.append(lab)
        order = np.argsort(self.frame_idx, kind="stable")
        self.frame_idx = [self.frame_idx[i] for i in order]
        self.labels = [self.labels[i] for i in order]

    def _summarize(self):
        rows, f2l, f2r = [], [], []
        count = 0
        for lab, f in zip(self.labels, self.frame_idx):
            f2l.append(count)
            count += len(lab)
            rows.append(lab.to_structured())
            f2r.append(f)
        labels = (np.concatenate(rows) if rows
                  else np.zeros((0,), BBOX_DTYPE))
        return labels, np.asarray(f2l, np.int64), np.asarray(f2r, np.int64)

    def save(self, save_dir: str, dst: DatasetConfig):
        """Write the pseudo dataset sequence (reference:
        pseudo_labeler.py:335-397): symlink the h5 where the source has
        one, write labels + index maps; symlink val/test at the dataset
        root once."""
        assert self.ended, "sequence did not reach end-of-stream"
        source = self.source
        if source is None:
            source = EventSequence(self.seq_dir, dst)
            source.close()
        num_frames = int(source.num_ev_repr)
        # realpath resolves relative link targets against the link's own
        # directory (raw readlink would resolve them against the cwd)
        src_h5 = getattr(source, "h5_path", None)
        src_h5 = osp.realpath(src_h5) if src_h5 else None

        new_seq_dir = osp.join(save_dir, "train", osp.basename(
            self.seq_dir.rstrip("/")))
        new_ev_dir = ev_repr_dir(new_seq_dir, dst.ev_repr_name)
        new_npz = labels_npz_path(new_seq_dir)
        os.makedirs(new_ev_dir, exist_ok=False)
        os.makedirs(osp.dirname(new_npz), exist_ok=False)
        if src_h5:
            os.symlink(osp.abspath(src_h5), ev_h5_path(
                new_seq_dir, dst.ev_repr_name, dst.downsample_by_factor_2))

        self._aggregate(num_frames)
        self._track_filter()
        labels, f2l, f2r = self._summarize()
        np.save(osp.join(new_ev_dir, "objframe_idx_2_repr_idx.npy"), f2r)
        np.savez(new_npz, labels=labels, objframe_idx_2_label_idx=f2l)

        if not src_h5:
            return
        # link val/test splits once at the dataset root
        base = osp.dirname(self.seq_dir.rstrip("/"))
        orig_root = osp.dirname(base)
        for split in ("val", "test"):
            src = osp.realpath(osp.join(orig_root, split))
            dst_link = osp.join(save_dir, split)
            if osp.exists(src) and not osp.lexists(dst_link):
                try:
                    os.symlink(osp.abspath(src), dst_link)
                except FileExistsError:   # another shard linked it first
                    pass


def rerun_track_filter(src_root: str, save_dir: str, dst: DatasetConfig,
                       pl_cfg: PseudoLabelConfig,
                       postproc: Optional[PostprocessConfig] = None):
    """Tracking-only post-processing: re-run the track filter over an
    EXISTING pseudo dataset's labels without any model inference
    (reference: predict.py:129-162 tracking-only mode with
    dataset.only_load_labels=True).

    Labels are processed at their stored (full) resolution."""
    postproc = postproc or PostprocessConfig()
    src_dst = dataclasses.replace(dst, path=src_root, ratio=-1.0,
                                  train_ratio=-1.0)
    os.makedirs(osp.join(save_dir, "train"), exist_ok=True)
    n = 0
    for seq_dir in list_sequence_dirs(src_root, "train"):
        seq = EventSequence(seq_dir, src_dst)
        rec = SequenceRecorder(seq_dir, 1.0, pl_cfg, postproc, source=seq)
        labels = []
        for obj_idx in range(len(seq.frame_labels)):
            lab = seq.frame_labels[obj_idx]
            if seq.frame_labels.downsample_factor:
                lab = lab.scale(seq.frame_labels.downsample_factor)
            labels.append(lab)
        rec.update(labels, seq.objframe_idx_2_repr_idx.tolist(),
                   is_last_sample=True,
                   is_padded=[False] * len(labels),
                   is_hflip=False, is_tflip=False, tflip_offset=0)
        rec.save(save_dir, dst)
        seq.close()
        n += 1
    return n


def pseudo_dataset_config(dst: DatasetConfig, pse_root: str
                          ) -> DatasetConfig:
    """The dataset config a pseudo dataset at `pse_root` is read with:
    every labeled frame kept, every sequence used."""
    return dataclasses.replace(dst, path=pse_root, ratio=-1.0,
                               train_ratio=-1.0)


def load_pseudo_sequences(save_dir: str, sources: Sequence[EventSequence],
                          dst: DatasetConfig) -> List[EventSequence]:
    """The written pseudo train split as sequences, in `sources`' order
    (those the split holds): an array-backed source's frames paired with
    the labels and index map written for it (`ArrayEventSequence`), a
    disk-backed one's written directory (`EventSequence`, its h5
    symlinked). Each is read with `pseudo_dataset_config`, and named by
    its written directory."""
    pse_dst = pseudo_dataset_config(dst, save_dir)
    out: List[EventSequence] = []
    for src in sources:
        seq_dir = osp.join(save_dir, "train",
                           osp.basename(src.seq_dir.rstrip("/")))
        if not osp.isdir(seq_dir):
            continue
        if not isinstance(src, ArrayEventSequence):
            out.append(EventSequence(seq_dir, pse_dst))
            continue
        lab = np.load(labels_npz_path(seq_dir))
        f2r = np.load(osp.join(ev_repr_dir(seq_dir, dst.ev_repr_name),
                               "objframe_idx_2_repr_idx.npy"))
        out.append(ArrayEventSequence(
            src.frames, lab["labels"], lab["objframe_idx_2_label_idx"], f2r,
            pse_dst, seq_dir=seq_dir))
    return out
