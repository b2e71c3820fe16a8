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
"""
from __future__ import annotations

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
