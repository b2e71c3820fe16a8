"""The space mesh axis: the image height of every activation and LSTM
state map sharded over the ranks of a space group (port of the `space`
axis of `leod_tpu/parallel/mesh.py`, whose halo exchanges and reshards
XLA's GSPMD inserts; here each one is written out).

Rank s of a space group of k holds rows [s*h/k, (s+1)*h/k) of every map
[B, h, w, C] of its data shard (`parallel/mesh.py`). Within
`space_shard(mesh)` (a thread-local context, as `distributed.
global_batch`; the serve path and the SSOD teacher in the prefetch
thread never enter it) the layers consult it:

- every convolution whose kernel spans rows (`space_conv2d`) pads the
  height by a halo of its neighbours' edge rows (`halo_rows`), zero rows
  at the image's top and bottom edges, which equal the zero padding of
  the unsharded convolution;
- the window half of a block pair runs on the local rows, and the grid
  half between an exchange of rows and its inverse (`grid_half`): after
  the exchange rank s holds the cell rows [s*H/(ph*k), (s+1)*H/(ph*k))
  of all ph grid rows, an NHWC map of H/k rows whose own grid partition
  gives exactly those groups, so the unchanged modules and kernels run
  on it. Where a stage's local height is not a multiple of the
  partition, the block half runs on the whole map, gathered over the
  space group, and each rank keeps its rows (the gather path, what
  XLA's reshard does; counted in COUNTS);
- the head's outputs are gathered whole (`gather_height`) before the
  box decode and the loss, which every rank of the group then computes
  alike;
- the train-mode BN takes its statistics over every rank of the mesh
  that holds this rank's model shard (data x space, `bn_group`).

Every collective is one all-reduce over the space group of a buffer
that is zero but for each rank's own part (the route of
`distributed.all_gather_rows`): it runs over gloo on the CPU and on one
card (gloo takes CUDA tensors for all-reduce and broadcast, not
all-gather) and over NCCL across cards through one code path. Where
each element has one contributor (the gathers, the exchanges and the
halos, both ways) the all-reduce adds the buffer's bytes as integers:
adding zeros to one value is then exact in any dtype. Only the gather
path's backward sums real gradients (in fp32). Every rank issues the
same collectives in the same order, in the forward, in a remat
recompute (`train/step.py` re-enters the context there) and in the
backward.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import timing

_active = threading.local()

KINDS = ("halo", "exchange", "gather", "head")
# block halves by route: local window, exchanged grid, gather path
COUNTS = {"window_local": 0, "grid_exchange": 0, "window_gather": 0,
          "grid_gather": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@contextlib.contextmanager
def space_shard(mesh):
    """Within it, in this thread, the layers compute on this rank's
    height slice of `mesh`'s space axis; a mesh without one (or None)
    changes nothing."""
    prev = getattr(_active, "mesh", None)
    _active.mesh = mesh if mesh is not None and mesh.space > 1 else None
    try:
        yield
    finally:
        _active.mesh = prev


def active():
    """The mesh of the active `space_shard` in this thread, or None."""
    return getattr(_active, "mesh", None)


def bn_group():
    """The group the train-mode BN takes its statistics over inside a
    space shard: the ranks of this rank's model index over data x space
    (every rank of the mesh without a model axis); else None."""
    mesh = active()
    return mesh.replica_group if mesh is not None else None


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

def _all_reduce(buf: torch.Tensor, group, kind: str, exact: bool) -> None:
    """SUM `buf` (contiguous) over `group` in place; `exact`: add its
    bytes as integers (each element has one non-zero contributor).
    Traced as the span "collective.<kind>" (host time, on a card with
    its wait for the queued work) and the counter
    "collective.<kind>.bytes"."""
    with timing.span("collective." + kind):
        if exact:
            flat = buf.view(-1)
            nbytes = flat.numel() * flat.element_size()
            flat = flat.view(torch.int32 if nbytes % 4 == 0 else torch.uint8)
            dist.all_reduce(flat, group=group)
        else:
            dist.all_reduce(buf, group=group)
    if timing.tracing():
        timing.count(f"collective.{kind}.bytes",
                     buf.numel() * buf.element_size())


def _own(full: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's rows of a whole map along `dim`."""
    h = full.shape[dim] // mesh.space
    return full.narrow(dim, mesh.space_index * h, h)


def _gather(x: torch.Tensor, dim: int, mesh, kind: str) -> torch.Tensor:
    """Every space rank's `x` in rank order along `dim` (exact)."""
    h = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = h * mesh.space
    buf = x.new_zeros(shape)
    buf.narrow(dim, mesh.space_index * h, h).copy_(x)
    _all_reduce(buf, mesh.space_group, kind, exact=True)
    return buf


def _scatter(full: torch.Tensor, dim: int, mesh, kind: str) -> torch.Tensor:
    """This rank's rows of the SUM over the space ranks of `full`, summed
    in fp32 in a buffer of its own."""
    buf = full.to(torch.float32, memory_format=torch.contiguous_format,
                  copy=True)
    _all_reduce(buf, mesh.space_group, kind, exact=False)
    return _own(buf, dim, mesh).to(full.dtype).contiguous()


class _GatherRows(torch.autograd.Function):
    """Forward: the whole map, every space rank's rows in rank order.
    Backward: with `reduce`, the SUM over the ranks of the whole map's
    gradient, this rank's rows (each rank used the whole map for its own
    rows); else this rank's rows of its own gradient (every rank
    computed the same function of the whole map)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, kind, reduce):
        ctx.args = (dim, mesh, kind, reduce)
        return _gather(x, dim, mesh, kind)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, kind, reduce = ctx.args
        if reduce:
            g = _scatter(g, dim, mesh, kind)
        else:
            g = _own(g, dim, mesh).contiguous()
        return g, None, None, None, None


def gather_height(x: torch.Tensor) -> torch.Tensor:
    """NHWC x [B, h/k, w, C] -> the whole map [B, h, w, C] inside a space
    shard (`x` itself outside one), differentiable: its backward returns
    this rank's slice of the gradient, never a sum over the ranks, since
    every rank of the group computes the same loss from the whole map
    (a sum would count the head's gradient k times)."""
    mesh = active()
    if mesh is None:
        return x
    return _GatherRows.apply(x, 1, mesh, "head", False)


# ---------------------------------------------------------------------------
# Halos and the convolutions
# ---------------------------------------------------------------------------

def _halo(x: torch.Tensor, top: int, bottom: int, dim: int, mesh,
          grad: bool) -> torch.Tensor:
    """Forward (grad False): x with the previous rank's last `top` rows
    above it and the next rank's first `bottom` rows below it (zeros
    beyond the image). Backward (grad True, x the padded map's
    gradient): the gradient of the unpadded map, the halo rows' parts
    returned to the ranks that own them and added there."""
    k, s, e = mesh.space, mesh.space_index, top + bottom
    h = x.shape[dim] - (e if grad else 0)
    shape = list(x.shape)
    shape[dim] = k * e
    buf = x.new_zeros(shape)
    # slot r holds [rank r's first `bottom` rows | its last `top` rows]
    if not grad:
        mine = buf.narrow(dim, s * e, e)
        mine.narrow(dim, 0, bottom).copy_(x.narrow(dim, 0, bottom))
        mine.narrow(dim, bottom, top).copy_(x.narrow(dim, h - top, top))
    else:
        if s < k - 1:
            buf.narrow(dim, (s + 1) * e, bottom).copy_(
                x.narrow(dim, top + h, bottom))
        if s > 0:
            buf.narrow(dim, (s - 1) * e + bottom, top).copy_(
                x.narrow(dim, 0, top))
    _all_reduce(buf, mesh.space_group, "halo", exact=True)
    if grad:
        gx = x.narrow(dim, top, h).clone()
        mine = buf.narrow(dim, s * e, e)
        gx.narrow(dim, 0, bottom).add_(mine.narrow(dim, 0, bottom))
        gx.narrow(dim, h - top, top).add_(mine.narrow(dim, bottom, top))
        return gx

    def zeros(n):
        z = list(x.shape)
        z[dim] = n
        return x.new_zeros(z)
    above = (buf.narrow(dim, (s - 1) * e + bottom, top) if s > 0
             else zeros(top))
    below = buf.narrow(dim, (s + 1) * e, bottom) if s < k - 1 else zeros(bottom)
    return torch.cat([above, x, below], dim)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, dim, mesh):
        ctx.args = (top, bottom, dim, mesh)
        return _halo(x, top, bottom, dim, mesh, grad=False)

    @staticmethod
    def backward(ctx, g):
        top, bottom, dim, mesh = ctx.args
        return _halo(g, top, bottom, dim, mesh, grad=True), None, None, \
            None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int,
              dim: int = 1) -> torch.Tensor:
    """Inside a space shard: x with `top` rows of the previous space rank
    above it and `bottom` rows of the next one below it along `dim`
    (NHWC: 1, NCHW: 2), zero rows at the global top and bottom edges;
    differentiable."""
    mesh = active()
    h = x.shape[dim]
    if top > h or bottom > h:
        raise ValueError(f"a halo of ({top}, {bottom}) rows from "
                         f"neighbours of {h} rows")
    if top == bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, dim, mesh)


def conv_halo(kernel: int, stride: int, pad_top: int, pad_bottom: int,
              h_local: int, k: int) -> Tuple[int, int]:
    """(top, bottom) halo rows a shard of `h_local` rows of a height
    convolution (kernel, stride, zero pad) needs so that its output is
    its h_local/stride rows of the unsharded output. Raises unless the
    unsharded output has h/stride rows and the stride divides the local
    height (else the stride's phase would shift between shards)."""
    h = h_local * k
    top, bottom = pad_top, max(kernel - stride - pad_top, 0)
    if (h_local % stride or (h + pad_top + pad_bottom - kernel) // stride
            + 1 != h // stride
            or (top + h_local + bottom - kernel) // stride + 1
            != h_local // stride):
        raise ValueError(
            f"a height convolution (kernel {kernel}, stride {stride}, pad "
            f"({pad_top}, {pad_bottom})) on {h_local} local rows of {h} "
            f"does not shard over {k} space ranks: the stride must divide "
            f"the local height and the output keep h / stride rows")
    return top, bottom


def space_conv2d(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, stride=1, padding=0,
                 groups: int = 1) -> torch.Tensor:
    """`F.conv2d` of NCHW x zero-padded by `padding`: an int, an (H, W)
    pair, or (top, bottom, left, right). Inside a space shard the height
    is padded by the halo only (`conv_halo`, `halo_rows`) and the width
    as before; outside one, exactly the unsharded convolution."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    if isinstance(padding, int):
        padding = (padding, padding)
    if len(padding) == 2:
        padding = (padding[0], padding[0], padding[1], padding[1])
    pt, pb, pl, pr = padding
    mesh = active()
    if mesh is None:
        if pt == pb and pl == pr:
            return F.conv2d(x, weight, bias, (sh, sw), (pt, pl), 1, groups)
        return F.conv2d(F.pad(x, (pl, pr, pt, pb)), weight, bias, (sh, sw),
                        0, 1, groups)
    top, bottom = conv_halo(weight.shape[2], sh, pt, pb, x.shape[2],
                            mesh.space)
    x = halo_rows(x, top, bottom, dim=2)
    if pl == pr:
        return F.conv2d(x, weight, bias, (sh, sw), (0, pl), 1, groups)
    return F.conv2d(F.pad(x, (pl, pr)), weight, bias, (sh, sw), 0, 1, groups)


# ---------------------------------------------------------------------------
# The block pair's halves
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _exchange_plan(h: int, ph: int, k: int, s: int, inverse: bool, device):
    """Rank s's index lists of the grid exchange of a map of h rows (or of
    its inverse). Before it rank t holds rows [t*h/k, (t+1)*h/k); after
    it, cell rows [t*h/(ph*k), (t+1)*h/(ph*k)) of each of the ph grid
    rows, grid row outermost. Only rows that change rank travel, each in
    its own slot of one buffer. Returns (positions of the rows that stay,
    in the source and in the destination layout; source positions of the
    rows that leave and their slots; slots of the rows that arrive and
    their destination positions; the number of slots)."""
    hl, hc = h // k, h // (ph * k)
    blocks = [range(t * hl, (t + 1) * hl) for t in range(k)]
    grid = [[a * (h // ph) + t * hc + j for a in range(ph) for j in range(hc)]
            for t in range(k)]
    src, dst = (grid, blocks) if inverse else (blocks, grid)
    owner = {r: t for t in range(k) for r in src[t]}
    slot = {r: i for i, r in enumerate(
        r for t in range(k) for r in dst[t] if owner[r] != t)}
    at = {r: i for i, r in enumerate(src[s])}
    stay = [(at[r], p) for p, r in enumerate(dst[s]) if owner[r] == s]
    arrive = [(slot[r], p) for p, r in enumerate(dst[s]) if owner[r] != s]
    leave = [(at[r], slot[r]) for r in src[s] if r in slot]

    def idx(pairs, i):
        return torch.tensor([q[i] for q in pairs], dtype=torch.long,
                            device=device)
    return (idx(stay, 0), idx(stay, 1), idx(leave, 0), idx(leave, 1),
            idx(arrive, 0), idx(arrive, 1), len(slot))


def _exchange(x: torch.Tensor, ph: int, mesh, inverse: bool) -> torch.Tensor:
    """NHWC: the grid exchange of a rank's rows (or its inverse), exact:
    the rows that change rank go through one all-reduce of their slots.
    Each is a permutation of the whole map's rows, so each one's adjoint
    is the other."""
    (stay_src, stay_dst, leave_src, leave_slot, arrive_slot, arrive_dst,
     n) = _exchange_plan(x.shape[1] * mesh.space, ph, mesh.space,
                         mesh.space_index, inverse, x.device)
    buf = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    buf.index_copy_(1, leave_slot, x.index_select(1, leave_src))
    _all_reduce(buf, mesh.space_group, "exchange", exact=True)
    y = torch.empty_like(x)
    y.index_copy_(1, stay_dst, x.index_select(1, stay_src))
    y.index_copy_(1, arrive_dst, buf.index_select(1, arrive_slot))
    return y


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ph, mesh, inverse):
        ctx.args = (ph, mesh, inverse)
        return _exchange(x, ph, mesh, inverse)

    @staticmethod
    def backward(ctx, g):
        ph, mesh, inverse = ctx.args
        return _exchange(g.contiguous(), ph, mesh, not inverse), None, \
            None, None


def grid_exchange(x: torch.Tensor, ph: int,
                  inverse: bool = False) -> torch.Tensor:
    """NHWC x [B, H/k, W, C] of this rank's rows -> the map whose grid
    partition (ph, .) gives the grid groups of this rank's cell rows (or,
    `inverse`, back); differentiable, exact. Needs H % (ph*k) == 0."""
    mesh = active()
    if mesh is None:
        return x
    return _Exchange.apply(x, ph, mesh, inverse)


def _gather_path(fn: Callable, x: torch.Tensor, mesh) -> torch.Tensor:
    full = _GatherRows.apply(x, 1, mesh, "gather", True)
    return _own(fn(full), 1, mesh).contiguous()


def window_half(fn: Callable, x: torch.Tensor, ph: int) -> torch.Tensor:
    """`fn` (a window-kind block half on an NHWC map) on this rank's
    rows: on them alone where the windows do not cross a shard's edge
    (h/k % ph == 0), else through the gather path."""
    mesh = active()
    if mesh is None:
        return fn(x)
    if x.shape[1] % ph == 0:
        COUNTS["window_local"] += 1
        return fn(x)
    COUNTS["window_gather"] += 1
    return _gather_path(fn, x, mesh)


def grid_half(fn: Callable, x: torch.Tensor, ph: int) -> torch.Tensor:
    """`fn` (a grid-kind block half on an NHWC map) on this rank's rows:
    between the grid exchange and its inverse where H % (ph*k) == 0
    (that is, h/k % ph == 0, as for the window half), else through the
    gather path."""
    mesh = active()
    if mesh is None:
        return fn(x)
    if x.shape[1] % ph == 0:
        COUNTS["grid_exchange"] += 1
        return grid_exchange(fn(grid_exchange(x, ph)), ph, inverse=True)
    COUNTS["grid_gather"] += 1
    return _gather_path(fn, x, mesh)
