"""The (data, space, model) mesh over the process group (port of
`leod_tpu/parallel/mesh.py`).

The reference's only parallelism is DDP over NCCL (reference:
train.py:126-133; SURVEY.md section 2.6), and the JAX package's is a
`jax.sharding.Mesh` whose `data` axis shards the batch (= stream slot)
axis and the recurrent state table, whose optional `space` axis shards
the image height of the activations and of the state table, and whose
optional `model` axis shards the transformer blocks' attention heads and
MLP inner dimension (`mesh.py:9-26`). The port's mesh lays the ranks of
the default process group out as the JAX package lays its devices out,
`devices.reshape(data, space, model)`: rank r = (d * space + s) * model
+ m holds global stream slots [d*B_local, (d+1)*B_local), their LSTM
states, rows [s*h/space, (s+1)*h/space) of every activation and state
map, and model shard m of each tensor-parallel weight (every other
weight whole); `train/step.py` sums the gradients over the ranks of one
model index once a step. The halo exchanges and reshards that XLA
inserts for the space axis are written out in `parallel/space.py`, the
model axis's all-reduces in `parallel/tensor.py`.

`mesh_layout` gives each group's rank lists without a process group.
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
    """`size` ranks along the data axis, `space` along the space axis,
    `model` along the model axis. `group` holds every rank (None for a
    mesh of one process without a group); `data_group` the ranks of this
    rank's (space, model) index, one a data shard (the loss normalizers'
    group); `space_group` the ranks of this rank's (data, model) index
    (the halo exchanges' group); `model_group` the ranks of this rank's
    (data, space) index (the block halves' all-reduces); `replica_group`
    the ranks of this rank's model index over data x space, which hold
    the same shards (the gradient sum and the BN statistics). A degree
    of 1 leaves its space or model group None; with space and model 1
    the data and replica groups are `group`."""
    size: int
    group: Any = None
    space: int = 1
    data_group: Any = None
    space_group: Any = None
    model: int = 1
    model_group: Any = None
    replica_group: Any = None

    @property
    def rank(self) -> int:
        return pdist.rank(self.group) if self.group is not None else 0

    @property
    def world(self) -> int:
        return self.size * self.space * self.model

    @property
    def data_index(self) -> int:
        return self.rank // (self.space * self.model)

    @property
    def space_index(self) -> int:
        return self.rank // self.model % self.space

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def mesh_layout(data: int, space: int = 1, model: int = 1) -> dict:
    """The ranks of a (data, space, model) mesh, rank = (d * space + s) *
    model + m as `devices.reshape(data, space, model)`: "grid"
    [data][space][model], and each group kind's rank lists in the order
    `make_mesh` creates them: "data" (one a (space, model) index),
    "space" (one a (data, model)), "model" (one a (data, space)) and
    "replica" (one a model index, over data x space)."""
    def r(d, s, m):
        return (d * space + s) * model + m
    D, S, M = range(data), range(space), range(model)
    return {
        "grid": [[[r(d, s, m) for m in M] for s in S] for d in D],
        "data": [[r(d, s, m) for d in D] for s in S for m in M],
        "space": [[r(d, s, m) for s in S] for d in D for m in M],
        "model": [[r(d, s, m) for m in M] for d in D for s in S],
        "replica": [[r(d, s, m) for d in D for s in S] for m in M],
    }


def make_mesh(num_devices: Optional[int] = None, space: int = 1,
              model: int = 1) -> Mesh:
    """The (data, space, model) mesh over every rank of the default
    process group (one card a rank): data = world / (space * model).
    `num_devices` must be the world size: a mesh of fewer ranks would
    silently train at a smaller parallel degree than asked (as
    `leod_tpu/parallel/mesh.py:60-65` refuses). With space or model > 1
    every rank creates every group of `mesh_layout`, in one order (the
    space and model groups only where their degree is above 1)."""
    n = pdist.world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(
            f"mesh wants {num_devices} ranks, the process group has {n} — "
            f"start one process a rank (torchrun --nproc_per_node "
            f"{num_devices}); training at another parallel degree would "
            f"misreport the recipe")
    if space < 1 or model < 1 or n % (space * model):
        raise ValueError(f"space={space} x model={model} does not divide "
                         f"the {n} ranks of the process group")
    world = dist.group.WORLD if dist.is_initialized() else None
    if space == 1 and model == 1:
        return Mesh(size=n, group=world, data_group=world,
                    replica_group=world)
    me = pdist.rank()
    timeout = datetime.timedelta(seconds=pdist.group_timeout_s())
    layout = mesh_layout(n // (space * model), space, model)
    made, mine = {}, {}
    for kind, degree in (("data", 0), ("space", space), ("model", model),
                         ("replica", 0)):
        if degree == 1:
            continue
        for ranks in layout[kind]:
            key = tuple(ranks)
            if key not in made:
                made[key] = (world if len(ranks) == n else
                             dist.new_group(ranks, timeout=timeout))
            if me in ranks:
                mine[kind] = made[key]
    return Mesh(size=n // (space * model), group=world, space=space,
                data_group=mine["data"], space_group=mine.get("space"),
                model=model, model_group=mine.get("model"),
                replica_group=mine["replica"])


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
    a flat buffer per dtype and device. On a model axis the tensors must
    be whole (rank 0 holds model shard 0 of a sharded one): the trainer
    replicates the full weights before it shards them."""
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
