"""Multi-process runtime over `torch.distributed` (port of
`leod_tpu/parallel/distributed.py`).

The reference runs DDP over NCCL across GPUs and shards evaluation by
global rank (reference: train.py:126-133,
data/utils/stream_sharded_datapipe.py:88-105). The JAX package's
counterpart is one `jax.distributed.initialize()` a host and loaders
that deal sequences by `jax.process_index()`; here it is one process a
card in one process group, and the same helpers over its ranks.

Every helper degrades to the one-process case when no group exists.

What one global batch needs from the group (`global_batch`): the loss
normalizers (`global_sum`) and the BN batch statistics
(`all_reduce_sum`, differentiable) are taken over every rank's rows, so
that each rank's loss is its share of the global loss and the sum of
the ranks' gradients is the global gradient (`train/step.py`).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import threading
from typing import Any, List, Optional

import torch
import torch.distributed as dist

# the process group of the ranks that hold one global batch, while a
# train step's forward runs in this thread (`global_batch`)
_active = threading.local()

DEFAULT_TIMEOUT_S = 600.0
# the timeout the default group was created with, for the groups made
# after it (`parallel/mesh.py` `make_mesh`)
_timeout = {"s": DEFAULT_TIMEOUT_S}


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group when running several processes.

    The arguments fall back to torchrun's environment (`WORLD_SIZE`,
    `RANK`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and to the JAX
    package's `LEOD_NUM_PROCESSES`. A no-op for one process, and when a
    group exists already. `coordinator_address` is "host:port" or an
    init method URL ("tcp://...", "file://...").

    The backend is NCCL where a card is present and gloo on the CPU.
    Rank r takes card `LOCAL_RANK`; a node with fewer cards than local
    ranks raises, unless the caller asked for `backend="gloo"`: only
    then do ranks share cards (card LOCAL_RANK mod the cards)."""
    if dist.is_initialized():
        return
    env = os.environ
    n = (num_processes if num_processes is not None else
         int(env.get("WORLD_SIZE", env.get("LEOD_NUM_PROCESSES", "1"))))
    if n <= 1 and coordinator_address is None:
        return
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", rank))
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env['MASTER_PORT']}")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    shared = backend == "gloo"
    if backend is None:
        backend = "nccl" if cards else "gloo"
    if cards:
        if local_rank >= cards and not shared:
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own ({cards} "
                f"on this node); pass backend='gloo' to share cards")
        torch.cuda.set_device(local_rank % cards)
    _timeout["s"] = timeout_s
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def group_timeout_s() -> float:
    """The seconds a collective of the default group may wait."""
    return _timeout["s"]


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 of the default group (or no group): the process that
    writes the run's files."""
    return rank() == 0


def process_shard() -> tuple:
    """(shard_index, num_shards) for host-side data sharding."""
    return rank(), world_size()


def local_batch_slice(global_batch: int,
                      shard: Optional[tuple] = None) -> slice:
    """The rows of the global batch this process feeds: those of its
    `shard` (index, count), by default its process shard.

    Stream-slot identity stays global: shard p owns slots
    [p*B_local, (p+1)*B_local)."""
    p, n = shard if shard is not None else process_shard()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} processes")
    b_local = global_batch // n
    return slice(p * b_local, (p + 1) * b_local)


def eval_shard(shard_index: Optional[int], num_shards: Optional[int],
               default: Optional[tuple] = None) -> tuple:
    """(shard_index, num_shards, gather) of an eval over a split: the
    caller's shard where it names one, else `default` (index, count) or
    this process's shard of the group, whose evaluators are then
    all-gathered (gather True)."""
    if shard_index is None and num_shards is None:
        return (*(default or process_shard()), True)
    return shard_index or 0, num_shards or 1, False


def barrier(group=None) -> None:
    if world_size(group) > 1:
        dist.barrier(group)


def broadcast_object(obj: Any, group=None) -> Any:
    """Rank 0's `obj` on every rank."""
    if world_size(group) <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def any_all(flags: List[bool], group=None, first_from_primary=()) -> list:
    """Each flag OR-ed over the ranks, except those whose index is in
    `first_from_primary`, which take rank 0's value: one all-reduce."""
    if world_size(group) <= 1:
        return list(flags)
    me = rank(group)
    # NCCL takes only tensors on the card
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([float(f) if (i not in first_from_primary or me == 0)
                      else 0.0 for i, f in enumerate(flags)], device=dev)
    dist.all_reduce(t, group=group)
    return [bool(v > 0) for v in t.tolist()]


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group; the gradient of every rank's input is the SUM
    of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable SUM of `x` over the group's ranks."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(row: torch.Tensor, group=None) -> torch.Tensor:
    """[world, *row.shape]: every rank's `row`, in rank order,
    differentiable, through one all-reduce of rows that are zero but for
    each rank's own (an exact gather: adding zeros rounds nothing; gloo
    takes CUDA tensors for all-reduce but not for all-gather)."""
    n, me = world_size(group), rank(group)
    zero = torch.zeros_like(row)
    return all_reduce_sum(torch.stack([row if r == me else zero
                                       for r in range(n)]), group)


@contextlib.contextmanager
def global_batch(group):
    """Within it, in this thread, `global_sum` and the train-mode BN
    (`models/layers.py` `batch_norm_train`) take their sums over
    `group`'s ranks, whose rows together are one batch. `group` None
    (one process) changes nothing. A context rather than an argument:
    the BN layers and the loss sit deep in the model's modules, whose
    forwards the eval and serve paths share; the SSOD teacher's eval in
    the prefetch thread never sees it."""
    prev = getattr(_active, "group", None)
    _active.group = group
    try:
        yield
    finally:
        _active.group = prev


def data_group():
    """The group of `global_batch` in this thread, or None."""
    return getattr(_active, "group", None)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` (sums that no gradient flows through) summed over the ranks of
    the active `global_batch`; `x` itself outside one."""
    group = data_group()
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def _pack_buffers(evaluator) -> bytes:
    return pickle.dumps((evaluator.labels, evaluator.predictions))


def _unpack_into(evaluator, blob: bytes) -> None:
    labels, preds = pickle.loads(blob)
    evaluator.labels.extend(labels)
    evaluator.predictions.extend(preds)


def allgather_evaluator(evaluator) -> None:
    """Every process's `PropheseeEvaluator` buffers, in rank order, in
    the local one, so that each rank computes identical exact COCO
    metrics (replaces the reference's rank-averaged
    `log_dict(sync_dist=True)`, modules/detection.py:451-456). No-op for
    one process. The buffers are ragged host lists: they travel as
    pickled blobs through `all_gather_object`."""
    n = world_size()
    if n <= 1:
        return
    blobs: List[Optional[bytes]] = [None] * n
    dist.all_gather_object(blobs, _pack_buffers(evaluator))
    del evaluator.labels[:], evaluator.predictions[:]
    for blob in blobs:
        _unpack_into(evaluator, blob)
