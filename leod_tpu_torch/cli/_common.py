"""What the CLIs share: the device, the synthetic frame store, the split
opener over it, and the inference detector's weights."""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..config import DatasetConfig, ModelConfig
from ..convert import load_reference_checkpoint
from ..data.loader import open_split_sequences
from ..data.sequence import EventSequence
from ..data.synthetic import render_dataset_frames
from ..models.detector import Detector
from ..train.trainer import load_variables

Frames = Optional[Mapping[str, np.ndarray]]


def device_of(args) -> str:
    return "cpu" if args.cpu else "cuda"


def dtype_of(args) -> torch.dtype:
    return torch.float32 if args.fp32 else torch.bfloat16


def synthetic_frames(path: Optional[str], seed: int = 0,
                     announce: bool = False):
    """(root, frame store) of the JAX CLIs' `--synthetic` split
    (`generate_dataset(root, num_train=4, num_val=2, num_test=2,
    num_reprs=64, seed=seed)`): the label and index files under `path`
    (a new temporary directory when None), the frames in memory."""
    root = path or tempfile.mkdtemp(prefix="leod_synth_")
    if announce and not os.path.isdir(os.path.join(root, "train")):
        print(f"generating synthetic dataset at {root}")
    return root, render_dataset_frames(root, num_train=4, num_val=2,
                                       num_test=2, num_reprs=64, seed=seed)


def open_split(dst: DatasetConfig, split: str, frames: Frames,
               **kwargs) -> Optional[List[EventSequence]]:
    """The split's sequences over the frame store, or None (the caller
    then opens the split's directory itself, h5 files and all)."""
    if frames is None:
        return None
    return open_split_sequences(dst, split, frames=frames, **kwargs)


def load_detector(model: ModelConfig, dtype: torch.dtype, device: str,
                  ckpt: Optional[str] = None,
                  torch_ckpt: Optional[str] = None) -> Detector:
    """An inference `Detector` with the weights of the port's checkpoint
    `ckpt` (`train/trainer.py` `load_variables`), of a reference
    PyTorch .ckpt/.pth `torch_ckpt` (`convert.py`), or, with neither,
    made from seed 0."""
    det = Detector(model, dtype=dtype, device=device, seed=0)
    if ckpt:
        det.load_state_dict(load_variables(ckpt, det.device))
    elif torch_ckpt:
        load_reference_checkpoint(det, torch_ckpt)
    return det


def ratio_of(dst: DatasetConfig, split: str) -> float:
    """The every-k sequence subsample `run_streaming_eval` applies to
    an eval split."""
    return {"val": dst.val_ratio, "test": dst.test_ratio}.get(split, -1.0)


def dump_json(path: str, obj: Dict) -> None:
    import json
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=float)
