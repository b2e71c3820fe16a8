"""Generated-dataset verification and label-quality scoring (host only;
port of `leod_tpu/selftrain/verify.py`).

Covers two reference passes:
  * predict.py:67-116 `verify_data` — re-read a fraction of the generated
    sequences and assert: index maps sorted/in-range, GT frames retained
    bit-exact, pseudo-only frames contain no GT, scores in [0, 1]
  * val_dst.py — score filtered pseudo labels against the withheld
    (subsampled-away) GT with AR/AP@{25, 50, 75}

Both read a pseudo dataset written under `pse_root` and the split it was
made from: `dst.path`'s directory, or the source sequences themselves
where `sequences=` is given (array-backed ones too, paired with their
written labels by `load_pseudo_sequences`).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DatasetConfig
from ..data.labels import Boxes
from ..data.sequence import EventSequence, list_sequence_dirs
from .filters import evaluate_pseudo_labels, filter_with_thresholds
from .pseudo_labeler import (PseudoLabelConfig, load_pseudo_sequences,
                             pseudo_dataset_config)


def _pairs(pse_root: str, dst: DatasetConfig,
           sequences: Optional[Sequence[EventSequence]]
           ) -> List[Tuple[str, Optional[EventSequence]]]:
    """(written sequence dir, its source or None to open from disk) for
    every sequence of the pseudo train split, in name order."""
    dirs = list_sequence_dirs(pse_root, "train")
    if sequences is None:
        return [(d, None) for d in dirs]
    by_name = {os.path.basename(s.seq_dir.rstrip("/")): s for s in sequences}
    return [(d, by_name[os.path.basename(d)]) for d in dirs]


def _open(pse_root: str, dst: DatasetConfig, seq_dir: str,
          source: Optional[EventSequence]
          ) -> Tuple[EventSequence, EventSequence]:
    """(pseudo sequence, original sequence with the WSOD ratio applied)."""
    if source is None:
        pse = EventSequence(seq_dir, pseudo_dataset_config(dst, pse_root))
        orig_dir = os.path.join(dst.path, "train", os.path.basename(seq_dir))
        return pse, EventSequence(orig_dir, dst, label_ratio=dst.ratio)
    return load_pseudo_sequences(pse_root, [source], dst)[0], source


def verify_pseudo_dataset(pse_root: str, dst: DatasetConfig,
                          sample_frac: float = 0.1,
                          use_gt: bool = True, *,
                          sequences: Optional[Sequence[EventSequence]] = None
                          ) -> int:
    """Assert structural integrity of a generated dataset. Returns the
    number of sequences checked."""
    pairs = _pairs(pse_root, dst, sequences)
    assert pairs, f"no sequences in {pse_root}/train"
    step = max(int(1 / sample_frac), 1)
    checked = 0
    for d, source in pairs[::step]:
        pse, orig = _open(pse_root, dst, d, source)

        f2r = pse.objframe_idx_2_repr_idx
        f2l = pse.frame_labels.frame_to_label_idx
        assert np.all(np.diff(f2r) > 0), "repr idx map not increasing"
        assert np.all(np.diff(f2l) > 0), "label idx map not increasing"
        assert f2r.min() >= 0 and f2r.max() < pse.num_ev_repr

        for obj_idx, repr_idx in enumerate(f2r):
            lab = pse.frame_labels[obj_idx]
            assert np.all(lab.class_confidence >= 0) and \
                np.all(lab.class_confidence <= 1), "scores out of [0,1]"
            gt_lab, kept = orig.labels_at_repr_idx(int(repr_idx))
            if use_gt and gt_lab is not None and kept:
                # GT frames retained bit-exact (predict.py:114-115);
                # compare as unordered sets of rows. Both readers return
                # labels at loading resolution (FrameLabels downsamples
                # stored full-res labels on access).
                a = np.sort(lab.arr, axis=0)
                b = np.sort(gt_lab.arr, axis=0)
                assert a.shape == b.shape, "GT frame box count changed"
                assert np.abs(a - b).max() < 1e-3, "GT labels not retained"
            else:
                assert lab.is_pseudo().all(), "pseudo frame contains GT"
        pse.close()
        if source is None:
            orig.close()
        checked += 1
    return checked


def score_pseudo_dataset(pse_root: str, dst: DatasetConfig,
                         pl_cfg: PseudoLabelConfig,
                         num_classes: int, classes, *,
                         sequences: Optional[Sequence[EventSequence]] = None
                         ) -> Dict[str, float]:
    """AR/AP of the generated labels vs withheld GT (reference: val_dst.py).

    Applies the pseudo-label confidence thresholds + ignore filter before
    comparison (val_dst.py:36-45)."""
    gts, preds = [], []
    for d, source in _pairs(pse_root, dst, sequences):
        pse, orig = _open(pse_root, dst, d, source)
        for obj_idx, repr_idx in enumerate(orig.objframe_idx_2_repr_idx):
            lab, kept = orig.labels_at_repr_idx(int(repr_idx))
            if lab is None or kept:        # only withheld GT frames
                continue
            p_obj = pse.repr_idx_2_objframe_idx.get(int(repr_idx))
            if p_obj is None:
                pse_lab = Boxes.empty(lab.size_hw)
            else:
                # FrameLabels already rescales to loading resolution
                pse_lab = pse.frame_labels[p_obj]
                keep = (filter_with_thresholds(
                            pse_lab.objectness, pse_lab.class_id,
                            tuple(pl_cfg.obj_thresh))
                        & filter_with_thresholds(
                            pse_lab.class_confidence, pse_lab.class_id,
                            tuple(pl_cfg.cls_thresh))
                        & ~pse_lab.is_ignore(pl_cfg.ignore_label))
                pse_lab = pse_lab.select(keep)
            gts.append(lab)
            preds.append(pse_lab)
        pse.close()
        if source is None:
            orig.close()
    if not gts:
        return {}
    return evaluate_pseudo_labels(gts, preds, [True] * len(gts),
                                  num_classes, classes, prefix="ssod/")
