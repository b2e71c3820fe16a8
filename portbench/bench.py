"""The harness's shared parts: finding a cell's files by name, the
port's configuration from a configuration file, the seeded weights, the
result line and its checks.

A cell (an entry of `workloads` in `BENCHMARK.json`) names a
configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); the mix's `kind` names the generator
(`generators/<kind>.py`) that generates its load; `limits/<workload>.json`
holds the limits its correctness numbers are held to; each metric is
read by `metrics/<name>.py`. Nothing here names a cell.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "leod_tpu")


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A harness file loaded by its path (metric and generator files are
    named after metrics and kinds, which may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload with everything found by its names."""
    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: str

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metric_path(self, name: str) -> str:
        return os.path.join(self.root, "portbench", "metrics", f"{name}.py")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(root: str, workload: str) -> Cell:
    """The cell named `workload` of `<root>/BENCHMARK.json` with its
    configuration, traffic and limits, and the metrics it reports."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(os.path.join(root, configs[entry["config"]]["file"]))
    pb = os.path.join(root, "portbench")
    traffic = read_json(os.path.join(pb, "traffic", entry["traffic"] + ".json"))
    limits = read_json(os.path.join(pb, "limits", workload + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(workload, entry, config, traffic, limits, e2e, per_layer,
                root)


def generator(cell: Cell):
    return load_module(os.path.join(cell.root, "portbench", "generators",
                                    cell.traffic["kind"] + ".py"),
                       "portbench_generator_" + cell.traffic["kind"])


# ---------------------------------------------------------------------------
# The port's configuration
# ---------------------------------------------------------------------------

def port_config(config: Dict[str, Any], save_dir: str):
    """The port's `ExperimentConfig` for a configuration file: the preset
    it names at the file's dataset geometry, with the file's training
    settings. Raises where a number
    of the file's `model` block differs from the preset's, so that a
    change of the program's preset cannot pass unseen."""
    from dataclasses import replace

    from leod_tpu_torch.config import derive, experiment_preset
    p, d = config["preset"], config["dataset"]
    cfg = experiment_preset(p["dataset"], p["size"])
    # the file's dataset geometry; the port derives padding and partition
    cfg = derive(replace(cfg, dataset=replace(
        cfg.dataset, resolution_hw=tuple(d["resolution_hw"]),
        downsample_by_factor_2=d["downsample_by_factor_2"],
        sequence_length=d["sequence_length"])))
    bb, head, fpn = cfg.model.backbone, cfg.model.head, cfg.model.fpn
    have = {"input_channels": bb.input_channels, "embed_dim": bb.embed_dim,
            "dim_multiplier": list(bb.dim_multiplier),
            "num_blocks": list(bb.num_blocks), "dim_head": bb.dim_head,
            "mlp_ratio": bb.mlp_ratio, "partition_size": list(bb.partition_size),
            "in_res_hw": list(bb.in_res_hw), "fpn_depth": fpn.depth,
            "fpn_in_stages": list(fpn.in_stages),
            "num_classes": head.num_classes, "strides": list(head.strides),
            "max_gt": head.max_gt}
    for k, v in have.items():
        if config["model"][k] != v:
            raise ValueError(f"configuration {k} = {config['model'][k]}, the "
                             f"program's preset has {v}")
    t = config["training"]
    tr = replace(cfg.training, learning_rate=t["learning_rate"],
                 max_steps=t["max_steps"], weight_decay=t["weight_decay"],
                 gradient_clip_val=t["gradient_clip_val"], remat=t["remat"],
                 precision=t["precision"], batch_size_train=t["batch_size"],
                 lr_scheduler=replace(cfg.training.lr_scheduler,
                                      pct_start=t["pct_start"],
                                      div_factor=t["div_factor"],
                                      final_div_factor=t["final_div_factor"]),
                 # nothing but steps inside the window: no validation,
                 # panel or timed checkpoint
                 val_check_interval=0, viz_every_steps=0,
                 ckpt_every_min=1e9)
    ds = replace(cfg.dataset, train_sampling=t["train_sampling"])
    pp = config["postprocess"]
    post = replace(cfg.model.postprocess,
                   confidence_threshold=pp["confidence_threshold"],
                   nms_threshold=pp["nms_threshold"],
                   max_dets=pp["max_dets"], pre_nms_topk=pp["pre_nms_topk"])
    model = replace(cfg.model, postprocess=post)
    return replace(cfg, training=tr, dataset=ds, model=model,
                   save_dir=save_dir, exp_name="portbench")


def compute_dtype(config: Dict[str, Any]):
    import torch
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[
        config["training"]["precision"]]


# ---------------------------------------------------------------------------
# Seeded weights
# ---------------------------------------------------------------------------

def seeded_state(model, seed: int, spec: Dict[str, Any], device):
    """A state dict for `model`'s keys drawn from `seed` on `device` in a
    few large calls: matrices and kernels N(0, 1/fan_in), LayerScale
    U(spec["layerscale"]), the obj and class predictions' bias at
    spec["pred_bias"] and their kernels times spec["pred_gain"], the box
    regression's kernels times spec.get("reg_gain", 1), norms
    at unit scale and zero shift, BN statistics at (0, 1)."""
    import torch
    from portbench.reference.model import lecun_std
    gen = torch.Generator(device=device).manual_seed(seed)
    sd = model.state_dict()
    mats = [k for k, v in sd.items() if v.dim() > 1]
    ls = [k for k in sd if k.endswith((".ls1", ".ls2"))]
    noise = torch.randn(sum(sd[k].numel() for k in mats), generator=gen,
                        device=device)
    lo, hi = spec["layerscale"]
    lsv = torch.rand(sum(sd[k].numel() for k in ls), generator=gen,
                     device=device) * (hi - lo) + lo
    out, i, j = {}, 0, 0
    for k, v in sd.items():
        n = v.numel()
        if k in mats:
            w = noise[i:i + n].view(v.shape) * lecun_std(v.shape)
            if ".cls_pred" in k or ".obj_pred" in k:
                w = w * spec["pred_gain"]
            elif ".reg_pred" in k:
                w = w * spec.get("reg_gain", 1.0)
            out[k] = w
            i += n
        elif k in ls:
            out[k] = lsv[j:j + n].view(v.shape)
            j += n
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros_like(v, device=device)
        elif k.endswith(("running_var",)) or (
                k.endswith(".weight") and ("norm" in k or ".bn." in k)):
            out[k] = torch.ones(v.shape, device=device)
        elif (".cls_pred" in k or ".obj_pred" in k) and k.endswith(".bias"):
            out[k] = torch.full(v.shape, float(spec["pred_bias"]),
                                device=device)
        else:
            out[k] = torch.zeros(v.shape, device=device)
    return out


def settle_bn(model, state: Dict[str, Any], frames, steps: int, device):
    """Sets the BN statistics of `state` to those of the reference's
    training forward over `frames` [N, C, H, W] (uint8, one row a slot)
    after `steps` timesteps, as a trained model's running statistics
    match its activations; `state` is changed in place."""
    import torch
    from portbench.reference.model import (Anchors, ConvBN, Numerics,
                                           fold_frames)
    m = model.m
    model.load_state_dict(state)
    nm = Numerics("fp32")
    x = fold_frames(frames.to(device), m["in_res_hw"])
    with torch.no_grad():
        st = model.zero_states(x.shape[0], device)
        for _ in range(steps):
            feats, st = model.backbone_step(x, st, nm)
        model.detect(feats, Anchors(m["in_res_hw"], m["strides"], device),
                     nm, train=True, sigmoid=True)
    for name, mod in model.named_modules():
        if isinstance(mod, ConvBN):
            state[f"{name}.bn.running_mean"] = mod.seen[0].clone()
            state[f"{name}.bn.running_var"] = mod.seen[1].clone()


def reference_model(config: Dict[str, Any], device):
    import torch
    from portbench.reference.model import RVTDetector
    with torch.device("meta"):
        m = RVTDetector(config["model"])
    return m.to_empty(device=device)


# ---------------------------------------------------------------------------
# The run and its result
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What a generator hands back: the window, its counts, the readings
    of its correctness numbers, and what the traced run recorded."""
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    values: Dict[str, float] = field(default_factory=dict)
    checks: List[Tuple[str, float]] = field(default_factory=list)
    trace: Dict[str, Any] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    device: Dict[str, Any] = field(default_factory=dict)


def judge(run: Run, limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number compared at or
    under its limit and finite; a number without a limit fails."""
    rows = []
    ok = bool(run.checks)
    for name, value in run.checks:
        lim = limits.get(name)
        good = (lim is not None and value is not None and math.isfinite(value)
                and value <= lim)
        ok = ok and good
        rows.append((name, value, lim))
    return ok, rows


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


class Clock:
    """perf_counter seconds since the process began the run."""

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.perf_counter() if t0 is None else t0

    def now(self) -> float:
        return time.perf_counter() - self.t0


def read_metric(cell: Cell, name: str, run: Run) -> Optional[float]:
    reader: Callable = load_module(cell.metric_path(name),
                                   "portbench_metric_" + name.replace(".", "_")
                                   ).read
    return reader(run)
