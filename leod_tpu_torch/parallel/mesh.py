"""The data-parallel mesh over the process group (port of the data axis
of `leod_tpu/parallel/mesh.py`).

The reference's only parallelism is DDP over NCCL (reference:
train.py:126-133; SURVEY.md section 2.6), and the JAX package's is a
`jax.sharding.Mesh` whose `data` axis shards the batch (= stream slot)
axis and the recurrent state table, with the parameters replicated. The
port's mesh is that axis over the ranks of the default process group,
one card each: rank p holds global stream slots [p*B_local,
(p+1)*B_local) and their LSTM states, every rank holds the whole model,
and `train/step.py` sums the ranks' gradients once a step.

The JAX mesh's other two axes are not ported: `space` (the image
height sharded with conv halo exchanges, `mesh.py:9-17`) and `model`
(tensor parallelism over attention heads, `mesh.py:19-26, 135-173`).
`make_mesh` raises for either, naming its ROADMAP.md item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from . import distributed as pdist


@dataclass(frozen=True)
class Mesh:
    """`size` ranks along the data axis; `group` is their process group
    (None for a mesh of one process without a group)."""
    size: int
    group: Any = None

    @property
    def rank(self) -> int:
        return pdist.rank(self.group) if self.group is not None else 0


def make_mesh(num_devices: Optional[int] = None, space: int = 1,
              model: int = 1) -> Mesh:
    """The data axis over every rank of the default process group (one
    card a rank). `num_devices` must be the world size: a mesh of fewer
    ranks would silently train at a smaller parallel degree than asked
    (as `leod_tpu/parallel/mesh.py:60-65` refuses). space > 1 and
    model > 1 raise: their axes are not ported."""
    if space > 1:
        raise NotImplementedError(
            f"space={space}: the height-sharded (space) mesh axis is not "
            f"ported yet (ROADMAP.md A.2, the space axis)")
    if model > 1:
        raise NotImplementedError(
            f"model={model}: the tensor-parallel (model) mesh axis is not "
            f"ported yet (ROADMAP.md A.3, the model axis)")
    n = pdist.world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(
            f"mesh wants {num_devices} ranks, the process group has {n} — "
            f"start one process a rank (torchrun --nproc_per_node "
            f"{num_devices}); training at another parallel degree would "
            f"misreport the recipe")
    return Mesh(size=n, group=dist.group.WORLD if dist.is_initialized()
                else None)


def data_axis_size(mesh: Optional[Mesh]) -> int:
    """Batch rows must divide THIS."""
    return mesh.size if mesh is not None else 1


def replicate(mesh: Optional[Mesh], tensors: Iterable[torch.Tensor]) -> None:
    """Make every rank's `tensors` rank 0's, in place: one broadcast of
    a flat buffer per dtype and device."""
    if mesh is None or mesh.group is None or mesh.size <= 1:
        return
    buckets = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = _flatten_dense_tensors([t.detach() for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        with torch.no_grad():
            for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(v)


def shard_states(mesh: Optional[Mesh], states: Any) -> Any:
    """This rank's rows [p*B_local, (p+1)*B_local) of a global LSTM state
    table ((h, c) a stage, [B, h, w, C] each): the state rows a rank owns
    are exactly its batch slots (`Trainer.make_train_loader`)."""
    n = data_axis_size(mesh)
    if n <= 1:
        return states
    p = mesh.rank

    def rows(v):
        if v.shape[0] % n:
            raise ValueError(f"{v.shape[0]} state rows over {n} ranks")
        b = v.shape[0] // n
        return v[p * b:(p + 1) * b].clone()
    return tuple((rows(h), rows(c)) for h, c in states)
