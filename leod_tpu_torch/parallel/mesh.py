"""The (data, space) mesh over the process group (port of the data and
space axes of `leod_tpu/parallel/mesh.py`).

The reference's only parallelism is DDP over NCCL (reference:
train.py:126-133; SURVEY.md section 2.6), and the JAX package's is a
`jax.sharding.Mesh` whose `data` axis shards the batch (= stream slot)
axis and the recurrent state table, with the parameters replicated, and
whose optional `space` axis shards the image height of the activations
and of the state table (`mesh.py:9-17`). The port's mesh lays the ranks
of the default process group out as the JAX package lays its devices
out, `devices.reshape(data, space)`: rank r = d * space + s holds global
stream slots [d*B_local, (d+1)*B_local), their LSTM states, and rows
[s*h/space, (s+1)*h/space) of every activation and state map; every rank
holds the whole model, and `train/step.py` sums the ranks' gradients
once a step. The halo exchanges and reshards that XLA inserts for the
space axis are written out in `parallel/space.py`.

The JAX mesh's `model` axis (tensor parallelism over attention heads,
`mesh.py:19-26, 135-173`) is not ported: `make_mesh` raises for it,
naming its ROADMAP.md item.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from . import distributed as pdist


@dataclass(frozen=True)
class Mesh:
    """`size` ranks along the data axis, `space` along the space axis.
    `group` holds every rank (None for a mesh of one process without a
    group); `data_group` the ranks of this rank's space index (one per
    data shard: the loss normalizers' group), `space_group` the ranks of
    this rank's data shard (the halo exchanges' group). With space 1 the
    data group is `group` and there is no space group."""
    size: int
    group: Any = None
    space: int = 1
    data_group: Any = None
    space_group: Any = None

    @property
    def rank(self) -> int:
        return pdist.rank(self.group) if self.group is not None else 0

    @property
    def world(self) -> int:
        return self.size * self.space

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space


def make_mesh(num_devices: Optional[int] = None, space: int = 1,
              model: int = 1) -> Mesh:
    """The (data, space) mesh over every rank of the default process
    group (one card a rank): data = world / space. `num_devices` must be
    the world size: a mesh of fewer ranks would silently train at a
    smaller parallel degree than asked (as
    `leod_tpu/parallel/mesh.py:60-65` refuses). With space > 1 every
    rank creates every data and space group, in one order. model > 1
    raises: that axis is not ported."""
    if model > 1:
        raise NotImplementedError(
            f"model={model}: the tensor-parallel (model) mesh axis is not "
            f"ported yet (ROADMAP.md A.1, the model axis)")
    n = pdist.world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(
            f"mesh wants {num_devices} ranks, the process group has {n} — "
            f"start one process a rank (torchrun --nproc_per_node "
            f"{num_devices}); training at another parallel degree would "
            f"misreport the recipe")
    if space < 1 or n % space:
        raise ValueError(f"space={space} does not divide the {n} ranks of "
                         f"the process group")
    world = dist.group.WORLD if dist.is_initialized() else None
    if space == 1:
        return Mesh(size=n, group=world, data_group=world)
    data = n // space
    me = pdist.rank()
    timeout = datetime.timedelta(seconds=pdist.group_timeout_s())
    data_group = space_group = None
    for s in range(space):
        g = dist.new_group([d * space + s for d in range(data)],
                           timeout=timeout)
        if me % space == s:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * space + s for s in range(space)],
                           timeout=timeout)
        if me // space == d:
            space_group = g
    return Mesh(size=data, group=world, space=space, data_group=data_group,
                space_group=space_group)


def data_axis_size(mesh: Optional[Mesh]) -> int:
    """Batch rows must divide THIS (space shards hold whole rows)."""
    return mesh.size if mesh is not None else 1


def data_shard(mesh: Optional[Mesh]) -> tuple:
    """(data index, data degree) of this rank: the shard of the stream
    slots and of the sequences it feeds; without a mesh, this process's
    shard of the group (`distributed.process_shard`)."""
    if mesh is None:
        return pdist.process_shard()
    return mesh.data_index, mesh.size


def replicate(mesh: Optional[Mesh], tensors: Iterable[torch.Tensor]) -> None:
    """Make every rank's `tensors` rank 0's, in place: one broadcast of
    a flat buffer per dtype and device."""
    if mesh is None or mesh.group is None or mesh.world <= 1:
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


def height_slice(mesh: Optional[Mesh], v, dim: int):
    """This rank's rows [s*h/space, (s+1)*h/space) of `v` along `dim`
    (a tensor or a numpy array; `v` itself without a space axis)."""
    k = mesh.space if mesh is not None else 1
    if k <= 1:
        return v
    h = v.shape[dim]
    if h % k:
        raise ValueError(f"height {h} does not split over {k} space ranks")
    s, n = mesh.space_index, h // k
    idx = [slice(None)] * v.ndim
    idx[dim] = slice(s * n, (s + 1) * n)
    return v[tuple(idx)]


def shard_states(mesh: Optional[Mesh], states: Any) -> Any:
    """This rank's part of a global LSTM state table ((h, c) a stage,
    [B, h, w, C] each): rows [d*B_local, (d+1)*B_local) of its data
    shard (the state rows a rank owns are exactly its batch slots,
    `Trainer.make_train_loader`) and, on a space axis, its height slice
    [B_local, h/space, w, C] (no resharding at the scan carry)."""
    n = data_axis_size(mesh)
    if mesh is None or mesh.world <= 1:
        return states
    p = mesh.data_index

    def rows(v):
        if v.shape[0] % n:
            raise ValueError(f"{v.shape[0]} state rows over {n} ranks")
        b = v.shape[0] // n
        return height_slice(mesh, v[p * b:(p + 1) * b], 1).clone()
    return tuple((rows(h), rows(c)) for h, c in states)
