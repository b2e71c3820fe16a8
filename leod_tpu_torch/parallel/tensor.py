"""The model mesh axis: Megatron-style tensor parallelism over the
transformer blocks' attention heads and MLP inner dimension (port of the
`model` axis of `leod_tpu/parallel/mesh.py`, where GSPMD propagates the
parameter shardings `_TP_RULES` (`mesh.py:142-149`) and inserts one
all-reduce a block half; here each piece is written out).

Rank m of a model group of k (`parallel/mesh.py`: the k ranks of one
(data, space) index, which hold the same rows of the same frames) keeps,
of every block whose heads and MLP inner dimension k divides
(`shard_params`):

- the qkv rows of heads [m*H/k, (m+1)*H/k): one contiguous block, the
  projection being packed head-major (`models/layers.py`
  `SelfAttention`), and their bias (column-parallel, as `qkv.kernel`
  P(None, model));
- the out-projection's input columns of those heads (row-parallel, as
  `proj.kernel` P(model, None)); its bias stays whole;
- the MLP's inner units [m*I/k, (m+1)*I/k) of `proj_in` and their bias,
  of both halves [value | gate] of a gated MLP, and those columns of
  `proj_out` (its bias whole).

Every other weight (convolutions, norms, LayerScale, LSTM, FPN, head) is
whole on every rank. A block that k does not divide stays whole (GSPMD
reshards such a block and computes the same numbers,
`leod_tpu/parallel/mesh.py:136-141`); `shard_params` names it.

Within `model_shard(mesh)` (a thread-local context, as
`space.space_shard`; the serve path and the online SSOD teacher in the
prefetch thread never enter it) a sharded block computes its rank's
heads and units between Megatron's conjugate pair: `copy_to_model`
(identity forward, all-reduce backward: the gradient reaching LN1 and
LN2 is a partial sum on each rank) before the column-parallel products,
and `reduce_from_model` (all-reduce forward, identity backward) after
the row-parallel ones, whose bias is added once, after the sum
(`row_parallel`). The partials are real sums: they are added in fp32.
Every rank of a model group issues the same all-reduces in the same
order, in the forward, in a remat recompute and in the backward.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import timing

_active = threading.local()

# `_TP_RULES` on the port's parameters: (path in a block, the dim of the
# torch tensor that is sharded). A flax kernel [in, out] is the torch
# weight [out, in] transposed, so P(None, model) shards the weight's
# rows and P(model, None) its columns.
TP_RULES = (("attn.qkv.weight", 0), ("attn.qkv.bias", 0),
            ("attn.proj.weight", 1), ("mlp.proj_in.weight", 0),
            ("mlp.proj_in.bias", 0), ("mlp.proj_out.weight", 1))

# the AdamW state of a parameter that has its shape
_MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


@contextlib.contextmanager
def model_shard(mesh):
    """Within it, in this thread, a block whose weights `shard_params`
    sharded computes its rank's heads and units and sums the partials
    over `mesh`'s model group; a mesh without a model axis (or None)
    changes nothing."""
    prev = getattr(_active, "mesh", None)
    _active.mesh = mesh if mesh is not None and mesh.model > 1 else None
    try:
        yield
    finally:
        _active.mesh = prev


def active():
    """The mesh of the active `model_shard` in this thread, or None."""
    return getattr(_active, "mesh", None)


def _mesh():
    mesh = active()
    if mesh is None:
        raise RuntimeError(
            "a block whose weights are sharded over the model axis runs "
            "outside model_shard(mesh): its partial sums would not be added")
    return mesh


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

def _all_reduce(buf: torch.Tensor, group, exact: bool = False) -> None:
    """SUM `buf` (contiguous) over `group` in place; `exact`: add its
    bytes as integers (each element has one non-zero contributor, so
    the sum is that element in any dtype). Traced as the span
    "collective.model" (host time, on a card with the wait for the
    queued work) and the counter "collective.model.bytes"."""
    with timing.span("collective.model"):
        if exact:
            flat = buf.view(-1)
            nbytes = flat.numel() * flat.element_size()
            dist.all_reduce(flat.view(torch.int32 if nbytes % 4 == 0
                                      else torch.uint8), group=group)
        else:
            dist.all_reduce(buf, group=group)
    if timing.tracing():
        timing.count("collective.model.bytes",
                     buf.numel() * buf.element_size())


def _sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the model group, in fp32, in x's dtype."""
    buf = x.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    _all_reduce(buf, mesh.model_group)
    return buf.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; its backward sums the gradient over the model group.
    Before a column-parallel product, inside `model_shard`."""
    return _CopyToModel.apply(x, _mesh())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over the model group (in fp32); its backward is the
    identity. After a row-parallel product, inside `model_shard`."""
    return _ReduceFromModel.apply(x, _mesh())


def row_parallel(x: torch.Tensor, weight: torch.Tensor,
                 bias=None) -> torch.Tensor:
    """`F.linear(x_full, weight_full, bias)` from this rank's columns of
    x [..., K/k] and of weight [N, K/k]: the partial product, kept in
    fp32 (the operands rounded to x's dtype first, as autocast casts
    them), summed over the model group, the bias added once, and one
    rounding to x's dtype, as the one-process product rounds once."""
    dt = x.dtype
    with torch.autocast(x.device.type, enabled=False):
        part = F.linear(x.float(), weight.to(dt).float())
    y = reduce_from_model(part)
    if bias is not None:
        y = y + bias.to(dt).float()
    return y.to(dt)


# ---------------------------------------------------------------------------
# The weights
# ---------------------------------------------------------------------------

def _get(module: nn.Module, path: str):
    for name in path.split("."):
        module = getattr(module, name, None)
    return module


def _blocks(det: nn.Module):
    """(name, block) of every transformer block: a module with an
    `attn` and an `mlp` that can be sharded."""
    for name, mod in det.named_modules():
        if hasattr(getattr(mod, "attn", None), "model_shards") and \
                hasattr(getattr(mod, "mlp", None), "model_shards"):
            yield name, mod


def _rules(blk: nn.Module):
    """(path, dim, gated halves) of each sharded tensor a block has."""
    for path, dim in TP_RULES:
        if _get(blk, path) is not None:
            yield path, dim, path.startswith("mlp.proj_in") and blk.mlp.gated


def can_shard(blk: nn.Module, k: int) -> bool:
    """Whether k divides the block's heads and MLP inner dimension."""
    heads = blk.attn.dim // blk.attn.dim_head
    inner = blk.mlp.proj_out.weight.shape[1] * blk.mlp.model_shards
    return heads % k == 0 and inner % k == 0


def sharded_tensors(det: nn.Module) -> Dict[str, Tuple[int, bool]]:
    """{state-dict name: (sharded dim, gated halves)} of the tensors
    `shard_params` sharded in `det`."""
    out = {}
    for name, blk in _blocks(det):
        if blk.attn.model_shards > 1:
            pre = f"{name}." if name else ""
            out.update((pre + path, (dim, gated))
                       for path, dim, gated in _rules(blk))
    return out


def is_sharded(det: nn.Module) -> bool:
    return any(blk.attn.model_shards > 1 for _, blk in _blocks(det))


def shard_tensor(full: torch.Tensor, dim: int, gated: bool, index: int,
                 k: int) -> torch.Tensor:
    """Shard `index` of k of a whole tensor along `dim` (of each of its
    two halves where `gated`)."""
    if gated:
        return torch.cat([shard_tensor(h, dim, False, index, k)
                          for h in full.chunk(2, dim)], dim)
    n = full.shape[dim] // k
    return full.narrow(dim, index * n, n)


def gather_tensor(t: torch.Tensor, dim: int, gated: bool,
                  mesh) -> torch.Tensor:
    """The whole tensor from every model rank's shard `t` (exact: one
    all-reduce of a buffer that is zero but for each rank's part)."""
    if gated:
        return torch.cat([gather_tensor(h, dim, False, mesh)
                          for h in t.chunk(2, dim)], dim)
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * mesh.model
    buf = t.new_zeros(shape)
    buf.narrow(dim, mesh.model_index * n, n).copy_(t)
    _all_reduce(buf, mesh.model_group, exact=True)
    return buf


def shard_params(det: nn.Module, mesh) -> Dict[str, list]:
    """Keep this rank's shard of each tensor-parallel weight of `det` (in
    place, as new parameters: build the optimizer after it), on a mesh
    with a model axis. Returns the blocks {"sharded": [...],
    "replicated": [...]} by name; those k does not divide stay whole."""
    out = {"sharded": [], "replicated": []}
    k = mesh.model if mesh is not None else 1
    if k <= 1:
        return out
    for name, blk in _blocks(det):
        if blk.attn.model_shards > 1:
            raise ValueError(f"{name} is sharded already")
        if not can_shard(blk, k):
            out["replicated"].append(name)
            continue
        with torch.no_grad():
            for path, dim, gated in _rules(blk):
                mod_path, attr = path.rsplit(".", 1)
                mod = _get(blk, mod_path)
                p = getattr(mod, attr)
                setattr(mod, attr, nn.Parameter(
                    shard_tensor(p.detach(), dim, gated, mesh.model_index,
                                 k).clone(),
                    requires_grad=p.requires_grad))
        blk.attn.model_shards = blk.mlp.model_shards = k
        out["sharded"].append(name)
    return out


def gather_state(det: nn.Module, mesh, state: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """`state` ({name: tensor} in `det`'s names, e.g. its state dict)
    with each sharded tensor gathered whole over the model group; every
    model rank calls it."""
    shards = sharded_tensors(det)
    return {n: (gather_tensor(v, *shards[n], mesh) if n in shards else v)
            for n, v in state.items()}


def shard_state(det: nn.Module, mesh, state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """`state` of whole tensors (a checkpoint's) with each tensor that
    `det` holds sharded cut to this rank's shard."""
    shards = sharded_tensors(det)
    return {n: (shard_tensor(v, *shards[n], mesh.model_index, mesh.model)
                if n in shards else v) for n, v in state.items()}


def _map_moments(det: nn.Module, opt_state: dict, fn) -> dict:
    """A copy of `ClipAdamW.state_dict()` whose moments of the sharded
    parameters went through fn(tensor, dim, gated); the AdamW state is
    keyed by the index of the parameter among those that take gradients
    (`ClipAdamW.params`)."""
    shards = sharded_tensors(det)
    names = [n for n, p in det.named_parameters() if p.requires_grad]
    adamw = dict(opt_state["adamw"])
    state = {}
    for i, st in adamw["state"].items():
        spec = shards.get(names[int(i)])
        state[i] = st if spec is None else {
            key: (fn(v, *spec) if key in _MOMENTS else v)
            for key, v in st.items()}
    adamw["state"] = state
    return {**opt_state, "adamw": adamw}


def gather_optimizer(det: nn.Module, mesh, opt_state: dict) -> dict:
    """`opt_state` with the sharded parameters' moments gathered whole."""
    return _map_moments(det, opt_state,
                        lambda v, dim, gated: gather_tensor(v, dim, gated,
                                                            mesh))


def shard_optimizer(det: nn.Module, mesh, opt_state: dict) -> dict:
    """`opt_state` of whole moments cut to this rank's shards."""
    return _map_moments(det, opt_state,
                        lambda v, dim, gated: shard_tensor(
                            v, dim, gated, mesh.model_index, mesh.model))
