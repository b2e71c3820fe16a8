"""Weight bridge from the JAX package to the port: JAX tree -> port.

`load_jax_variables(detector, variables)` fills the port's `Detector`,
inference (weights in its compute dtype) or trainable (fp32 parameters
and BN statistics), from the variables of the JAX `Detector.init`
(`leod_tpu/models/detector.py:70-76`: `params/{backbone,fpn,head}` and
`batch_stats/{fpn,head}`), given as nested dicts of numpy arrays. The
port names its modules as the flax modules, so each leaf's path names
its module; the leaf name and the module's type pick the mapping:

  Dense kernel [in, out]            -> Linear.weight [out, in]
  Conv kernel HWIO (incl. the S2D stem [7, 7, Cin, Cout] and the LSTM
    gates [1, 1, 2C, 4C])           -> weight OIHW
  LayerNorm scale / bias            -> weight / bias
  BatchNorm scale / bias, mean / var -> weight / bias, running_mean / var
  ls1, ls2, mask_token              -> the parameter of the same name

Every leaf must be consumed and every port tensor filled; anything left
over raises.

`jax_paths(detector)` runs the same rules backwards: each port tensor's
collection, JAX path and JAX shape (the gradflow metric's names, and
the tree a converted checkpoint is checked against).

Reference PyTorch checkpoints (a copy of `leod_tpu/convert.py`'s numpy
converter): `convert_torch_state_dict` maps the reference
`YoloXDetector` state_dict namespace (reference:
models/detection/yolox_extension/models/detector.py:18-91,
recurrent_backbone/maxvit_rnn.py:23-201, yolox_extension/models/
yolo_pafpn.py:30-106, yolox/models/yolo_head.py:46-145,
models/layers/rnn.py:21-35, models/layers/maxvit/maxvit.py:85-360) onto
the JAX tree, and `load_reference_checkpoint` takes a .ckpt/.pth through
it and `load_jax_variables` into the port's `Detector`:
    torch Conv2d weight [O, I, kh, kw] -> kernel [kh, kw, I, O]
    torch Linear weight [O, I]         -> kernel [I, O]
    torch BatchNorm weight/bias/running_mean/running_var
        -> bn scale/bias (params) + mean/var (batch_stats)
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from .models.layers import _S2DStemConv, _SplitGateConv

_CONV_TYPES = (nn.Conv2d, _S2DStemConv, _SplitGateConv)
_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _target(module: nn.Module, leaf: str, arr: np.ndarray):
    """(port tensor name on `module`, array in the port's layout)."""
    if leaf == "kernel":
        if isinstance(module, nn.Linear):
            return "weight", arr.T
        if isinstance(module, _CONV_TYPES):
            return "weight", arr.transpose(3, 2, 0, 1)
        raise KeyError(f"kernel on a {type(module).__name__}")
    return _RENAME.get(leaf, leaf), arr


_LEAF = {v: k for k, v in _RENAME.items()}


def _source(module: nn.Module, name: str, shape: Tuple[int, ...]
            ) -> Tuple[str, Tuple[int, ...]]:
    """`_target` backwards: (JAX leaf name, JAX shape) of the port
    tensor `name` of `module` with `shape`."""
    if name == "weight" and isinstance(module, nn.Linear):
        return "kernel", shape[::-1]
    if name == "weight" and isinstance(module, _CONV_TYPES):
        o, i, kh, kw = shape
        return "kernel", (kh, kw, i, o)
    return _LEAF.get(name, name), shape


def jax_paths(detector: nn.Module
              ) -> Dict[str, Tuple[str, Tuple[str, ...], Tuple[int, ...]]]:
    """{port tensor name: (collection, JAX path, JAX shape)} for every
    parameter and BN statistic of `detector`: "params" or "batch_stats",
    and the path under it, e.g. ("backbone", "stage1", "down", "conv",
    "kernel"). Each entry is checked to map back through `_target`."""
    out = {}
    for full, tensor in list(detector.named_parameters()) + \
            list(detector.named_buffers()):
        if full.endswith("num_batches_tracked"):
            continue
        mod_path, _, name = full.rpartition(".")
        module = detector.get_submodule(mod_path)
        leaf, shape = _source(module, name, tuple(tensor.shape))
        back, arr = _target(module, leaf, np.empty(shape, np.float32))
        assert back == name and arr.shape == tuple(tensor.shape), full
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        out[full] = (coll, tuple(mod_path.split(".")) + (leaf,), shape)
    return out


@torch.no_grad()
def load_jax_variables(detector: nn.Module, variables: Dict[str, Any]) -> None:
    """Copy a JAX `Detector.init` tree into the port's `detector`."""
    filled = set()
    leftover = []
    for coll in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(coll, {})):
            mod_path, leaf = ".".join(path[:-1]), path[-1]
            try:
                module = detector.get_submodule(mod_path)
                name, value = _target(module, leaf, arr)
                tensor = getattr(module, name)
            except (AttributeError, KeyError):
                leftover.append("/".join((coll,) + path))
                continue
            if not isinstance(tensor, torch.Tensor) or \
                    tuple(tensor.shape) != value.shape:
                raise ValueError(f"{'/'.join(path)}: shape {value.shape} "
                                 f"does not fit {mod_path}.{name}")
            tensor.copy_(torch.from_numpy(np.array(value)))
            filled.add(f"{mod_path}.{name}" if mod_path else name)
    if leftover:
        raise ValueError(f"JAX leaves with no port tensor: {leftover}")
    missing = [n for n, _ in detector.named_parameters() if n not in filled]
    missing += [n for n, _ in detector.named_buffers()
                if n not in filled and not n.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"port tensors the JAX tree did not fill: {missing}")


# ---------------------------------------------------------------------------
# Reference PyTorch checkpoints -> the JAX tree (numpy)
# ---------------------------------------------------------------------------

Params = Dict[str, Any]


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _conv(w) -> np.ndarray:
    """[O, I, kh, kw] -> [kh, kw, I, O] (also correct for grouped/depthwise:
    torch [O, I/g, kh, kw] -> flax [kh, kw, I/g, O])."""
    return _f32(w).transpose(2, 3, 1, 0)


def _dense(w) -> np.ndarray:
    return _f32(w).T


class _SD:
    """state_dict view that strips the Lightning `mdl.` prefix and tracks
    consumed keys so namespace drift fails loudly."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = {re.sub(r"^mdl\.", "", k): v for k, v in sd.items()}
        self.used: set = set()

    def __call__(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"reference checkpoint is missing {key!r}")
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def leftovers(self) -> list:
        return sorted(k for k in self.sd
                      if k not in self.used
                      and not k.endswith("num_batches_tracked"))

    def indices(self, pattern: str) -> list:
        """Sorted unique integers captured by `pattern` over all keys."""
        rx = re.compile(pattern)
        out = set()
        for k in self.sd:
            m = rx.match(k)
            if m:
                out.add(int(m.group(1)))
        return sorted(out)


def _convbn(sd: _SD, src: str) -> Tuple[Params, Params]:
    """BaseConv (conv+BN+act): params, batch_stats
    (reference: network_blocks.py:29-54)."""
    params = {"conv": {"kernel": _conv(sd(f"{src}.conv.weight"))},
              "bn": {"scale": _f32(sd(f"{src}.bn.weight")),
                     "bias": _f32(sd(f"{src}.bn.bias"))}}
    stats = {"bn": {"mean": _f32(sd(f"{src}.bn.running_mean")),
                    "var": _f32(sd(f"{src}.bn.running_var"))}}
    return params, stats


def _conv_block(sd: _SD, src: str) -> Tuple[Params, Params]:
    """BaseConv or DWConv(dconv+pconv), detected from the keys."""
    if sd.has(f"{src}.dconv.conv.weight"):
        dp, ds = _convbn(sd, f"{src}.dconv")
        pp, ps = _convbn(sd, f"{src}.pconv")
        return {"dconv": dp, "pconv": pp}, {"dconv": ds, "pconv": ps}
    return _convbn(sd, src)


def _bottleneck(sd: _SD, src: str) -> Tuple[Params, Params]:
    p1, s1 = _convbn(sd, f"{src}.conv1")
    p2, s2 = _conv_block(sd, f"{src}.conv2")
    return {"conv1": p1, "conv2": p2}, {"conv1": s1, "conv2": s2}


def _csp(sd: _SD, src: str) -> Tuple[Params, Params]:
    """CSPLayer (reference: network_blocks.py:104-142)."""
    params, stats = {}, {}
    for name in ("conv1", "conv2", "conv3"):
        params[name], stats[name] = _convbn(sd, f"{src}.{name}")
    for i in sd.indices(re.escape(src) + r"\.m\.(\d+)\."):
        params[f"m{i}"], stats[f"m{i}"] = _bottleneck(sd, f"{src}.m.{i}")
    return params, stats


def _partition_attention(sd: _SD, src: str, skip_first_norm: bool) -> Params:
    """PartitionAttentionCl (reference: maxvit.py:185-270)."""
    p: Params = {}
    if not skip_first_norm:
        p["norm1"] = {"scale": _f32(sd(f"{src}.norm1.weight")),
                      "bias": _f32(sd(f"{src}.norm1.bias"))}
    p["attn"] = {
        "qkv": {"kernel": _dense(sd(f"{src}.self_attn.qkv.weight")),
                "bias": _f32(sd(f"{src}.self_attn.qkv.bias"))},
        "proj": {"kernel": _dense(sd(f"{src}.self_attn.proj.weight")),
                 "bias": _f32(sd(f"{src}.self_attn.proj.bias"))}}
    if sd.has(f"{src}.ls1.gamma"):
        p["ls1"] = _f32(sd(f"{src}.ls1.gamma"))
        p["ls2"] = _f32(sd(f"{src}.ls2.gamma"))
    p["norm2"] = {"scale": _f32(sd(f"{src}.norm2.weight")),
                  "bias": _f32(sd(f"{src}.norm2.bias"))}
    if sd.has(f"{src}.mlp.net.0.proj.weight"):        # gated GLU variant
        p["mlp"] = {
            "proj_in": {"kernel": _dense(sd(f"{src}.mlp.net.0.proj.weight")),
                        "bias": _f32(sd(f"{src}.mlp.net.0.proj.bias"))},
            "proj_out": {"kernel": _dense(sd(f"{src}.mlp.net.2.weight")),
                         "bias": _f32(sd(f"{src}.mlp.net.2.bias"))}}
    else:
        p["mlp"] = {
            "proj_in": {"kernel": _dense(sd(f"{src}.mlp.net.0.0.weight")),
                        "bias": _f32(sd(f"{src}.mlp.net.0.0.bias"))},
            "proj_out": {"kernel": _dense(sd(f"{src}.mlp.net.2.weight")),
                         "bias": _f32(sd(f"{src}.mlp.net.2.bias"))}}
    return p


def _stage(sd: _SD, k: int) -> Params:
    """RNNDetectorStage (reference: maxvit_rnn.py:142-201)."""
    src = f"backbone.stages.{k}"
    p: Params = {"down": {"conv": {"kernel": _conv(
        sd(f"{src}.downsample_cf2cl.conv.weight"))}}}
    if sd.has(f"{src}.downsample_cf2cl.norm.weight"):
        p["down"]["norm"] = {
            "scale": _f32(sd(f"{src}.downsample_cf2cl.norm.weight")),
            "bias": _f32(sd(f"{src}.downsample_cf2cl.norm.bias"))}
    for i in sd.indices(re.escape(src) + r"\.att_blocks\.(\d+)\."):
        for kind in ("window", "grid"):
            p[f"block{i}_{kind}"] = _partition_attention(
                sd, f"{src}.att_blocks.{i}.att_{kind}",
                skip_first_norm=(i == 0 and kind == "window"))
    p["lstm"] = {"gates": {"kernel": _conv(sd(f"{src}.lstm.conv1x1.weight")),
                           "bias": _f32(sd(f"{src}.lstm.conv1x1.bias"))}}
    if sd.has(f"{src}.lstm.conv3x3_dws.weight"):
        p["lstm"]["dws"] = {
            "kernel": _conv(sd(f"{src}.lstm.conv3x3_dws.weight")),
            "bias": _f32(sd(f"{src}.lstm.conv3x3_dws.bias"))}
    if sd.has(f"{src}.mask_token"):
        p["mask_token"] = _f32(sd(f"{src}.mask_token"))
    return p


_FPN_CONVBN = ("lateral_conv0", "reduce_conv1")
_FPN_CONVBLOCK = ("bu_conv1", "bu_conv2")
_FPN_CSP = ("C3_p4", "C3_p3", "C3_n3", "C3_n4")


def convert_torch_state_dict(sd: Mapping[str, Any],
                             strict: bool = True) -> Dict[str, Any]:
    """Reference state_dict (flat torch names, `mdl.` prefix optional) ->
    {"params": ..., "batch_stats": ...} for `Detector`. Structure is
    inferred from the keys; `strict` fails on unconsumed keys."""
    s = _SD(sd)

    backbone: Params = {}
    for k in s.indices(r"backbone\.stages\.(\d+)\."):
        backbone[f"stage{k + 1}"] = _stage(s, k)

    fpn_p: Params = {}
    fpn_s: Params = {}
    for name in _FPN_CONVBN:
        fpn_p[name], fpn_s[name] = _convbn(s, f"fpn.{name}")
    for name in _FPN_CONVBLOCK:
        fpn_p[name], fpn_s[name] = _conv_block(s, f"fpn.{name}")
    for name in _FPN_CSP:
        fpn_p[name], fpn_s[name] = _csp(s, f"fpn.{name}")

    head_p: Params = {}
    head_s: Params = {}
    for k in s.indices(r"yolox_head\.stems\.(\d+)\."):
        head_p[f"stem{k}"], head_s[f"stem{k}"] = _convbn(
            s, f"yolox_head.stems.{k}")
        for j in (0, 1):
            head_p[f"cls_conv{k}_{j}"], head_s[f"cls_conv{k}_{j}"] = \
                _conv_block(s, f"yolox_head.cls_convs.{k}.{j}")
            head_p[f"reg_conv{k}_{j}"], head_s[f"reg_conv{k}_{j}"] = \
                _conv_block(s, f"yolox_head.reg_convs.{k}.{j}")
        for pred in ("cls_pred", "reg_pred", "obj_pred"):
            head_p[f"{pred}{k}"] = {
                "kernel": _conv(s(f"yolox_head.{pred}s.{k}.weight")),
                "bias": _f32(s(f"yolox_head.{pred}s.{k}.bias"))}

    left = s.leftovers()
    if left and strict:
        raise ValueError(
            f"{len(left)} unconsumed reference keys (namespace drift?): "
            f"{left[:10]}...")
    return {"params": {"backbone": backbone, "fpn": fpn_p, "head": head_p},
            "batch_stats": {"fpn": fpn_s, "head": head_s}}


def load_torch_checkpoint(path: str, strict: bool = True) -> Dict[str, Any]:
    """Load a reference .ckpt/.pth and convert. Accepts raw state_dicts
    and Lightning checkpoints ({'state_dict': {'mdl.*': ...}})
    (reference: modules/detection.py:583-594 load_weight)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    return convert_torch_state_dict(sd, strict=strict)


def _flat_shapes(tree: Mapping) -> Dict[str, Tuple[int, ...]]:
    return {"/".join(path): arr.shape for path, arr in _leaves(tree)}


def check_compatible(converted: Dict[str, Any], detector: nn.Module) -> None:
    """Assert the converted tree matches `detector`'s JAX tree
    (`jax_paths`) in structure and shapes; raises with the full diff
    list."""
    conv_flat = _flat_shapes(converted)
    init_flat = {"/".join((coll,) + path): shape
                 for coll, path, shape in jax_paths(detector).values()}
    problems = []
    for k in sorted(set(conv_flat) | set(init_flat)):
        a, b = conv_flat.get(k), init_flat.get(k)
        if a != b:
            problems.append(f"{k}: converted={a} model={b}")
    if problems:
        raise ValueError("converted checkpoint does not match the model:\n"
                         + "\n".join(problems))


def load_reference_checkpoint(detector: nn.Module, path: str,
                              strict: bool = True) -> None:
    """Fill `detector` from a reference LEOD/RVT .ckpt/.pth:
    `load_torch_checkpoint`, `check_compatible`, `load_jax_variables`."""
    converted = load_torch_checkpoint(path, strict=strict)
    check_compatible(converted, detector)
    load_jax_variables(detector, converted)
