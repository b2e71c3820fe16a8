"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes that reach the kernels' edge cases, at every width
the kernels take (RVT-T and RVT-B: C = 32-512 with heads of 32; RVT-S:
C = 48-384 with heads of 24, K-blocks of 16 and 32 columns): windows of T
tokens that are no multiple of 16, 1, 2, 4 and 16 heads, the attention
half `block_attention` alone at every width, at T = 8, 20, 60 and 80,
window and grid, with and without LN1, at B = 1 and 2 and with its
heads split over clusters of 1 to 16 CTAs, launched back to back at
the stage shapes at B = 1 and 8 by its own plan, the MLP with
and without its hidden dim split over CTAs, the per-token half
`block_mlp` alone at every width its tiles take, row counts with a
ragged last 64-row tile, and clusters of 1 to 8 CTAs sharing a tile,
the GLU MLP and SiLU, an
fp32 and a bf16 cell state, the ConvLSTM update `lstm_update` alone at
every width, with a ragged last 128-row tile, at B = 1 and 2, with K
split over clusters of 1 to 8 CTAs, and launched back to back at the
stage shapes at B = 1 and 8 by its own plan, NMS with and without class ids at
K = 1, 37, 1000 and 1024, NMS at IoUs on the threshold and on the floats
either side of it (identical and nested boxes), the NMS sweep's chains
(staircases across 32-box words, box 0 suppressing all, no overlap, all
invalid, an invalid box or a class change inside a chain) at K = 1 to
1024 and B = 1 and 8, 40 NMS launches back to back, NMS at the 48
images of an eval batch, the eval step through the kernels against its
plain versions at RVT-T and RVT-S widths, and inputs the kernels
refuse.

These tests need an NVIDIA Hopper card and `nvcc`; without a card they
skip. They import no JAX. Run them on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

(`--noconftest`: the suite's conftest sets up JAX, which the port does
not need.)

Tolerances: the kernels compute in bf16 with fp32 accumulation and round
at other points than the plain bf16 version, so an output may differ by
a few bf16 ulps of its largest value: 2^-5 * max|plain| per tensor, as
`chip_smoke.py` holds them. An fp32 cell state c' of the ConvLSTM update
is held closer, to 2^-18 * max|plain|: its gates f, i and g are then
computed accurately, and only the products' order of summation differs
(the SFU's tanh, which serves a bf16 c', misses it). The NMS keep mask
must match exactly.
"""
import numpy as np
import pytest
import torch

from leod_tpu_torch.models.layers import (PartitionAttention, _SplitGateConv,
                                          grid_partition, grid_reverse,
                                          window_partition, window_reverse)
from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
from leod_tpu_torch.ops.nms import nms_mask as nms_plain

pytestmark = pytest.mark.gpu

REL_TOL = 2.0 ** -5
FP32_C_TOL = 2.0 ** -18
H, W = 16, 20
DIM_HEAD = dict(maxvit_cuda.ATTN_SHAPES)   # C -> the head width it takes
# the RVT-B and RVT-S Gen1 stage shapes: (C, (H, W)) at strides 4-32
STAGES_B = [(64, (64, 80)), (128, (32, 40)), (256, (16, 20)), (512, (8, 10))]
STAGES_S = [(48, (64, 80)), (96, (32, 40)), (192, (16, 20)), (384, (8, 10))]


def _kblock(dim):
    """The kernels' K-block: the largest of 64, 32, 16 dividing C."""
    return 64 if dim % 64 == 0 else 32 if dim % 32 == 0 else 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the plain ConvLSTM update multiplies in fp32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    got, want = got.float(), want.float()
    assert bool(got.isfinite().all())
    err = float((got - want).abs().max())
    assert err <= REL_TOL * float(want.abs().max()), err


def _randomized(module, seed, dev):
    """The module in bf16 on `dev`, every parameter drawn at O(1) scale
    (LayerScale in [0.1, 0.5]) so that no branch is scaled away."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("ls1", "ls2")):
                p.copy_(torch.rand(p.shape, generator=g) * 0.4 + 0.1)
            elif name.endswith("weight") and p.dim() == 1:      # LayerNorm
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            else:
                fan_in = p[0].numel() if p.dim() > 1 else 16
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
    return module.requires_grad_(False).to(dev, torch.bfloat16)


def _pair(dim, ps, gated, act, dev, seed=0, first=True):
    """A (window, grid) block pair with the head width the kernels take
    at this C; the window block skips its first LayerNorm only in a
    stage's first pair."""
    return [_randomized(PartitionAttention(
        dim, ps, kind, skip_first_norm=first and kind == "window",
        dim_head=DIM_HEAD[dim], mlp_gated=gated, mlp_act=act), seed + i, dev)
        for i, kind in enumerate(("window", "grid"))]


@pytest.mark.parametrize("dim,ps,gated,act", [
    (32, (4, 5), False, "gelu"), (64, (4, 5), True, "gelu"),
    (128, (8, 10), False, "gelu"), (64, (2, 4), False, "silu"),
    (512, (8, 10), False, "gelu"), (48, (4, 5), False, "gelu"),
    (96, (4, 5), True, "gelu"), (192, (8, 10), False, "silu"),
    (384, (8, 10), False, "gelu")])
def test_block_pair_kernel_matches_plain(cuda, dim, ps, gated, act):
    wb, gb = _pair(dim, ps, gated, act, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, H, W, dim, device=cuda, generator=g).to(torch.bfloat16)
    before = maxvit_cuda.fused_block_pair.launches
    got = maxvit_cuda.fused_block_pair(x, wb, gb, ps, True,
                                       dim_head=DIM_HEAD[dim], act=act,
                                       gated=gated)
    torch.cuda.synchronize()
    assert maxvit_cuda.fused_block_pair.launches == before + 1
    _close(got, maxvit_cuda.fused_block_pair_plain(x, wb, gb, ps))


def _stage_matches_plain(dev, dim, c_dtype):
    ps = (4, 5)
    pairs = [_pair(dim, ps, False, "gelu", dev, seed=2 * i, first=i == 0)
             for i in range(2)]
    gates = _randomized(_SplitGateConv(dim), 7, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x, h, c = (torch.randn(2, H, W, dim, device=dev, generator=g)
               for _ in range(3))
    x, h, c = x.to(torch.bfloat16), (h * 0.5).to(torch.bfloat16), \
        (c * 0.5).to(c_dtype)
    before = maxvit_cuda.fused_stage.launches
    hk, ck = maxvit_cuda.fused_stage(x, h, c, pairs, gates, ps, True,
                                     dim_head=DIM_HEAD[dim])
    torch.cuda.synchronize()
    assert maxvit_cuda.fused_stage.launches == before + 1
    assert hk.dtype == torch.bfloat16 and ck.dtype == c_dtype
    hp, cp = maxvit_cuda.fused_stage_plain(x, h, c, pairs, gates, ps)
    _close(hk, hp)
    _close(ck, cp)


@pytest.mark.parametrize("c_dtype", [torch.float32, torch.bfloat16])
def test_stage_kernel_matches_plain(cuda, c_dtype):
    _stage_matches_plain(cuda, 64, c_dtype)


@pytest.mark.parametrize("c_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [48, 96])
def test_stage_kernel_matches_plain_dim_head_24(cuda, dim, c_dtype):
    """RVT-S's first two stage widths, heads of 24."""
    _stage_matches_plain(cuda, dim, c_dtype)


@pytest.mark.parametrize("k", [1, 37, 1000, 1024])
@pytest.mark.parametrize("with_ids", [False, True])
def test_nms_kernel_matches_plain(cuda, k, with_ids):
    g = torch.Generator().manual_seed(k)
    b = 3
    ctr = torch.rand(b, k, 2, generator=g) * torch.tensor([320.0, 256.0])
    wh = torch.rand(b, k, 2, generator=g) * 70 + 6
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).to(cuda)
    valid = (torch.rand(b, k, generator=g) > 0.05).to(cuda)
    ids = (torch.randint(0, 2, (b, k), generator=g).float().to(cuda)
           if with_ids else None)
    before = nms_cuda.nms_mask.launches
    got = nms_cuda.nms_mask(boxes, 0.45, valid, ids)
    torch.cuda.synchronize()
    assert nms_cuda.nms_mask.launches == before + 1
    assert torch.equal(got, nms_plain(boxes, 0.45, valid, ids))
    assert torch.equal(nms_cuda.nms_mask(boxes[0], 0.45, valid[0],
                                         None if ids is None else ids[0]),
                       got[0])


def _float32_neighbours(v):
    """The float32 values just below and above float32(v)."""
    v = np.float32(v)
    return (np.nextafter(v, np.float32(-np.inf)),
            np.nextafter(v, np.float32(np.inf)))


def _threshold_pairs(n_pairs, thr, seed):
    """n_pairs pairs of boxes whose IoU in float32 (`pairwise_iou`'s
    operations, on the CPU) is exactly thr, the float just below it, the
    float just above it, 1 (identical boxes), or thr with the second box
    of another class. A pair is a box of random size and a box nested in
    it (sharing its top-left corner), whose far corner is searched over
    float32 steps until the IoU lands where the pair wants it. Every pair
    lies near the origin, where float32 steps are fine enough to reach
    each IoU, and has class ids of its own (2p, and 2p + 1 for the other
    class), so that no pair suppresses another.
    Returns boxes [2 n_pairs, 4], ids [2 n_pairs], and each pair's kind:
    the later box of the pair is suppressed iff kind is "above" or
    "identical"."""
    from leod_tpu_torch.ops.boxes import pairwise_iou
    rng = np.random.default_rng(seed)
    t = np.float32(thr)
    below, above = _float32_neighbours(t)
    want = {"at": t, "below": below, "above": above, "other_class": t}
    kinds = ["at", "below", "above", "identical", "other_class"]
    steps = np.arange(-16, 17).astype(np.float32)
    boxes, ids, kind_of = [], [], []
    for p in range(n_pairs):
        kind = kinds[p % len(kinds)]
        for _ in range(1000):       # a new outer box until the IoU is hit
            x0, y0 = rng.uniform(0, 4, 2).astype(np.float32)
            w, h = rng.uniform(30, 50, 2).astype(np.float32)
            outer = np.array([x0, y0, x0 + w, y0 + h], np.float32)
            if kind == "identical":
                inner = outer.copy()
                break
            # inner area = thr x outer area at 0.6 of the outer width
            x1 = np.float32(x0 + np.float32(0.6) * w)
            y1 = np.float32(y0 + np.float32(thr / 0.6) * h)
            xx, yy = np.meshgrid(x1 + steps * np.spacing(x1),
                                 y1 + steps * np.spacing(y1))
            cand = np.stack([np.full(xx.size, x0), np.full(xx.size, y0),
                             xx.ravel(), yy.ravel()], -1).astype(np.float32)
            iou = pairwise_iou(torch.from_numpy(outer[None]),
                               torch.from_numpy(cand))[0].numpy()
            hit = np.flatnonzero(iou == want[kind])
            if hit.size:
                inner = cand[hit[0]]
                break
        else:
            raise AssertionError(f"no pair of kind {kind} found")
        boxes += [outer, inner]
        ids += [2 * p, 2 * p + (kind == "other_class")]
        kind_of.append(kind)
    return (np.stack(boxes).astype(np.float32),
            np.asarray(ids, np.float32), kind_of)


@pytest.mark.parametrize("k", [1000, 1024])
def test_nms_kernel_exact_at_the_threshold(cuda, k):
    """B = 8 images of K boxes in isolated pairs whose IoU lies exactly
    on the threshold (0.45 in float32), on the float just below or just
    above it, at 1 (identical boxes), or on it with the classes unequal,
    each image its own order of pairs: the kernel's keep mask equals the
    plain version's, and the plain version keeps the later box of a pair
    exactly where its IoU is not above the threshold."""
    thr, b = 0.45, 8
    rng = np.random.default_rng(k)
    boxes, ids, kinds = [], [], []
    for i in range(b):
        bx, cl, kd = _threshold_pairs(k // 2, thr, seed=10 * k + i)
        perm = rng.permutation(k // 2)
        boxes.append(bx.reshape(-1, 2, 4)[perm].reshape(-1, 4))
        ids.append(cl.reshape(-1, 2)[perm].reshape(-1))
        kinds.append([kd[j] for j in perm])
    boxes = torch.from_numpy(np.stack(boxes)).to(cuda)
    ids = torch.from_numpy(np.stack(ids)).to(cuda)
    valid = torch.ones(b, k, dtype=torch.bool, device=cuda)
    got = nms_cuda.nms_mask(boxes, thr, valid, ids)
    want = nms_plain(boxes, thr, valid, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    later = want[:, 1::2].cpu().numpy()
    for i in range(b):
        for j, kind in enumerate(kinds[i]):
            assert later[i, j] == (kind not in ("above", "identical")), \
                (i, j, kind)
    assert bool(want[:, 0::2].all())
    # the same boxes, class-agnostic: other-class pairs now suppress
    assert torch.equal(nms_cuda.nms_mask(boxes, thr, valid),
                       nms_plain(boxes, thr, valid))


def test_nms_back_to_back_launches_agree(cuda):
    """B = 8 images of K = 1000 boxes: 40 launches queued back to back
    give the first launch's keep mask bit for bit, which is the plain
    version's."""
    g = torch.Generator().manual_seed(5)
    b, k = 8, 1000
    ctr = torch.rand(b, k, 2, generator=g) * torch.tensor([320.0, 256.0])
    wh = torch.rand(b, k, 2, generator=g) * 70 + 6
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).to(cuda)
    valid = (torch.rand(b, k, generator=g) > 0.05).to(cuda)
    ids = torch.randint(0, 2, (b, k), generator=g).float().to(cuda)
    outs = [nms_cuda.nms_mask(boxes, 0.45, valid, ids) for _ in range(40)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], nms_plain(boxes, 0.45, valid, ids))


CHAIN_CASES = ["staircase", "box0_kills_all", "no_overlap", "all_invalid",
               "invalid_in_chain", "class_break"]


def _chain_case(case, b, k):
    """b images of k boxes for one case of the sweep's dependency chains:
    (boxes [b, k, 4], valid [b, k], class ids [b, k] or None, the keep
    mask the case implies). In a staircase box i is 3 to the right of box
    i - 1, 10 wide, so that it overlaps box i + 1 above the threshold
    (IoU 7/13) and no other: kept and suppressed boxes alternate, and the
    chain runs across every 32-box word (30 -> 31 -> 32 -> 33). Image n
    starts its staircase at box n, the boxes before it lying apart, so
    the images' alternations differ; where all boxes are one, image n's
    first n are invalid and its box n suppresses the rest. An invalid
    box, or a change of class between two neighbours, suppresses nothing
    and turns the alternation over for the rest of the chain."""
    i = np.arange(k)
    boxes, valid, ids, want = [], [], [], []
    for n in range(b):
        apart = (i < n) | (case == "no_overlap")
        x0 = np.where(apart, 20.0 * i, 3.0 * i)
        v = np.full(k, case != "all_invalid")
        if case == "box0_kills_all":      # image n's first n boxes invalid
            apart, x0 = np.zeros(k, bool), np.zeros(k)
            v = i >= n
        y0 = np.where(apart, 500.0, 0.0)
        boxes.append(np.stack([x0, y0, x0 + 10, y0 + 10], -1))
        if case == "invalid_in_chain":
            v[[p for p in (k // 2 + n, 31 + n) if p < k]] = False
        breaks = [p for p in (n + 3, 31, 33 + n, 64 + 5 * n, 500 + n, 999)
                  if 0 < p < k] if case == "class_break" else []
        c = np.cumsum(np.isin(i, breaks)) % 2
        kept = np.zeros(k, bool)
        for j in range(k):
            if case == "box0_kills_all":
                kept[j] = v[j] and not kept[:j].any()
            else:
                prev = j - 1 >= 0 and not apart[j - 1] and not apart[j]
                kept[j] = v[j] and not (prev and kept[j - 1]
                                        and c[j - 1] == c[j])
        valid.append(v)
        ids.append(c)
        want.append(kept)
    return (torch.tensor(np.stack(boxes), dtype=torch.float32),
            torch.tensor(np.stack(valid)),
            torch.tensor(np.stack(ids), dtype=torch.float32)
            if case == "class_break" else None,
            torch.tensor(np.stack(want)))


@pytest.mark.parametrize("case", CHAIN_CASES)
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 63, 64, 1000, 1024])
def test_nms_sweep_chains_match_plain(cuda, k, b, case):
    """The sweep's dependency chains, within a 32-box word and across
    words: the kernel's keep mask equals the plain version's, and both
    are the keep mask the case implies."""
    boxes, valid, ids, want = _chain_case(case, b, k)
    assert torch.equal(nms_plain(boxes, 0.45, valid, ids), want)
    got = nms_cuda.nms_mask(boxes.to(cuda), 0.45, valid.to(cuda),
                            None if ids is None else ids.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _mlp_cases():
    """C x R x MLP kind x cluster size (CTAs per row tile), where the
    tiles allow it: each CTA needs a hidden chunk (64 units; 32 of each
    half in the GLU) and 8 projection columns a warpgroup."""
    cases = []
    for dim in maxvit_cuda.KERNEL_DIMS:
        nwg = 2 if dim > 256 else 1            # the kernel's warpgroups
        for rows in (80, 640, 1000):
            for act, gated in (("gelu", False), ("silu", False),
                               ("gelu", True)):
                chunks = (PartitionAttention(dim, (4, 5), "window",
                                             dim_head=DIM_HEAD[dim],
                                             mlp_gated=gated)
                          .mlp.proj_out.in_features // (32 if gated else 64))
                for cluster in (1, 2, 4, 8):
                    if cluster <= chunks and dim % (nwg * 8 * cluster) == 0:
                        cases.append((dim, rows, act, gated, cluster))
    return cases


@pytest.mark.parametrize("dim,rows,act,gated,cluster", _mlp_cases())
def test_block_mlp_kernel_matches_plain(cuda, dim, rows, act, gated, cluster):
    blk = _randomized(PartitionAttention(dim, (4, 5), "window",
                                         dim_head=DIM_HEAD[dim],
                                         mlp_gated=gated, mlp_act=act),
                      dim + rows, cuda)
    g = torch.Generator(device=cuda).manual_seed(rows)
    x, o = (torch.randn(rows, dim, device=cuda, generator=g
                        ).to(torch.bfloat16) for _ in range(2))
    before = maxvit_cuda.block_mlp.launches
    got = maxvit_cuda.block_mlp(x, o, blk, act, gated, cluster=cluster)
    torch.cuda.synchronize()
    assert maxvit_cuda.block_mlp.launches == before + 1
    _close(got, maxvit_cuda.block_mlp_plain(x, o, blk))
    # the cluster adds its partial sums in rank order: runs agree exactly
    assert torch.equal(got, maxvit_cuda.block_mlp(x, o, blk, act, gated,
                                                  cluster=cluster))


def _attention_cases():
    """C (with its head width) x partition (T = 8, 20, 60, 80) x
    window/grid x LN1 skipped or not x B x every cluster size the width
    takes (a head group a CTA)."""
    cases = []
    for dim in maxvit_cuda.KERNEL_DIMS:
        for ps in ((2, 4), (4, 5), (6, 10), (8, 10)):
            for grid_kind in (False, True):
                for skip in (False, True):
                    for b in (1, 2):
                        for cluster in (1, 2, 4, 8, 16):
                            if cluster <= dim // DIM_HEAD[dim]:
                                cases.append((dim, ps, grid_kind, skip, b,
                                              cluster))
    return cases


@pytest.mark.parametrize("dim,ps,grid_kind,skip,b,cluster",
                         _attention_cases())
def test_block_attention_kernel_matches_plain(cuda, dim, ps, grid_kind, skip,
                                              b, cluster):
    kind = "grid" if grid_kind else "window"
    blk = _randomized(PartitionAttention(dim, ps, kind, skip_first_norm=skip,
                                         dim_head=DIM_HEAD[dim]),
                      dim + ps[0], cuda)
    g = torch.Generator(device=cuda).manual_seed(b + ps[1])
    x = torch.randn(b, 24, 20, dim, device=cuda, generator=g
                    ).to(torch.bfloat16)
    before = maxvit_cuda.block_attention.launches
    got = maxvit_cuda.block_attention(x, blk, grid_kind, cluster=cluster)
    torch.cuda.synchronize()
    assert maxvit_cuda.block_attention.launches == before + 1
    part, rev = ((grid_partition, grid_reverse) if grid_kind
                 else (window_partition, window_reverse))
    _close(got, rev(maxvit_cuda.block_attention_plain(part(x, *ps), blk),
                    *ps, 24, 20))
    assert torch.equal(got, maxvit_cuda.block_attention(x, blk, grid_kind,
                                                        cluster=cluster))


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("grid_kind", [False, True])
@pytest.mark.parametrize("dim,hw", STAGES_B + STAGES_S)
def test_block_attention_back_to_back_launches_agree(cuda, dim, hw, grid_kind,
                                                     b):
    """At the RVT-B and RVT-S Gen1 stage shapes, B = 8 and 1 (the kernel's own plan
    of windows, heads and clusters, which differs between them: B = 1
    splits heads over clusters up to 16 CTAs), 40 launches queued back to
    back all give the first launch's output bit for bit, which holds the
    plain version: no launch overlaps or races the next."""
    kind = "grid" if grid_kind else "window"
    blk = _randomized(PartitionAttention(dim, (8, 10), kind,
                                         dim_head=DIM_HEAD[dim]), dim, cuda)
    g = torch.Generator(device=cuda).manual_seed(dim)
    x = torch.randn(b, *hw, dim, device=cuda, generator=g).to(torch.bfloat16)
    outs = [maxvit_cuda.block_attention(x, blk, grid_kind) for _ in range(40)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    part, rev = ((grid_partition, grid_reverse) if grid_kind
                 else (window_partition, window_reverse))
    _close(outs[0], rev(maxvit_cuda.block_attention_plain(
        part(x, 8, 10), blk), 8, 10, *hw))


def _lstm_cases():
    """C x B x map (R = B * H * W: 320, 480, 640 and 960 rows, three of
    them with a ragged last 128-row tile) x c in bf16 or fp32 x every
    cluster size the width takes (at most its K chunks, 2C / K-block)."""
    cases = []
    for dim in maxvit_cuda.KERNEL_DIMS:
        chunks = 2 * dim // _kblock(dim)
        for b in (1, 2):
            for hw in ((16, 20), (24, 20)):
                for c_f32 in (False, True):
                    for cluster in (1, 2, 4, 8):
                        if cluster <= chunks:
                            cases.append((dim, b, hw, c_f32, cluster))
    return cases


def _lstm_inputs(dim, b, hw, c_dtype, dev, seed):
    gates = _randomized(_SplitGateConv(dim), seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x, h, c = (torch.randn(b, *hw, dim, device=dev, generator=g)
               for _ in range(3))
    return (x.to(torch.bfloat16), (h * 0.5).to(torch.bfloat16),
            (c * 0.5).to(c_dtype), gates)


@pytest.mark.parametrize("dim,b,hw,c_f32,cluster", _lstm_cases())
def test_lstm_update_kernel_matches_plain(cuda, dim, b, hw, c_f32, cluster):
    c_dtype = torch.float32 if c_f32 else torch.bfloat16
    x, h, c, gates = _lstm_inputs(dim, b, hw, c_dtype, cuda, dim + b)
    before = maxvit_cuda.lstm_update.launches
    hk, ck = maxvit_cuda.lstm_update(x, h, c, gates, cluster=cluster)
    torch.cuda.synchronize()
    assert maxvit_cuda.lstm_update.launches == before + 1
    assert maxvit_cuda.lstm_update.plan[2] == cluster
    assert hk.dtype == torch.bfloat16 and ck.dtype == c_dtype
    hp, cp = maxvit_cuda.lstm_update_plain(x, h, c, gates)
    _close(hk, hp)
    _close(ck, cp)
    if c_f32:
        # an fp32 c' keeps fp32's accuracy: the kernel's gates are then
        # accurate, and only the products' order of summation differs
        assert float((ck - cp).abs().max()) <= FP32_C_TOL * float(
            cp.abs().max())
    # a cluster adds its partial sums in rank order: runs agree exactly
    h2, c2 = maxvit_cuda.lstm_update(x, h, c, gates, cluster=cluster)
    assert torch.equal(hk, h2) and torch.equal(ck, c2)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dim,hw", STAGES_B + STAGES_S)
def test_lstm_update_back_to_back_launches_agree(cuda, dim, hw, b):
    """At the RVT-B and RVT-S Gen1 stage shapes, B = 8 and 1, by the kernel's own
    plan (persistent CTAs, or clusters splitting K where rows are few),
    40 launches queued back to back all give the first launch's output
    bit for bit, which holds the plain version."""
    x, h, c, gates = _lstm_inputs(dim, b, hw, torch.bfloat16, cuda, dim)
    outs = [maxvit_cuda.lstm_update(x, h, c, gates) for _ in range(40)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0][0], o[0]) and torch.equal(outs[0][1], o[1])
               for o in outs[1:])
    hp, cp = maxvit_cuda.lstm_update_plain(x, h, c, gates)
    _close(outs[0][0], hp)
    _close(outs[0][1], cp)


def test_kernels_refuse_what_they_do_not_take(cuda):
    wb, gb = _pair(32, (4, 5), False, "gelu", cuda)
    x = torch.zeros(1, H, W, 32, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        maxvit_cuda.fused_block_pair(x, wb, gb, (4, 5), True)
    xt = torch.zeros(1, W, H, 32, device=cuda,
                     dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        maxvit_cuda.fused_block_pair(xt, wb, gb, (4, 5), True)
    # 80 channels (5 heads of 16) is no width the MLP kernel is built for
    blk = _randomized(PartitionAttention(80, (4, 5), "window", dim_head=16),
                      0, cuda)
    x80 = torch.zeros(80, 80, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C in"):
        maxvit_cuda.block_mlp(x80, x80, blk)
    # nor the ConvLSTM kernel
    gates = _randomized(_SplitGateConv(80), 0, cuda)
    x80 = torch.zeros(1, H, W, 80, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C in"):
        maxvit_cuda.lstm_update(x80, x80, x80, gates)
    # nor the attention kernel, at a width it takes with another head
    # width: C = 64 in heads of 16, C = 96 in heads of 32
    for dim, dh in ((64, 16), (96, 32)):
        blk = _randomized(PartitionAttention(dim, (4, 5), "window",
                                             dim_head=dh), 0, cuda)
        xd = torch.zeros(1, H, W, dim, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="dim_head"):
            maxvit_cuda.block_attention(xd, blk, False)
    wb16, gb16 = (_randomized(PartitionAttention(
        64, (4, 5), kind, skip_first_norm=kind == "window", dim_head=16),
        0, cuda) for kind in ("window", "grid"))
    x64 = torch.zeros(1, H, W, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dim_head"):
        maxvit_cuda.fused_block_pair(x64, wb16, gb16, (4, 5), True,
                                     dim_head=16)
    # a partition of 100 tokens: more keys than a warp's S holds
    blk = _randomized(PartitionAttention(32, (10, 10), "window"), 0, cuda)
    x20 = torch.zeros(1, 20, 20, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ph \\* pw"):
        maxvit_cuda.block_attention(x20, blk, False)
    boxes = torch.zeros(1, 1025, 4, device=cuda)
    valid = torch.ones(1, 1025, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="1..1024"):
        nms_cuda.nms_mask(boxes, 0.45, valid)


@pytest.mark.parametrize("with_ids", [False, True])
def test_nms_kernel_matches_plain_at_the_eval_batch(cuda, with_ids):
    """48 images of K = 1000: the B * M = 8 * 6 frames an RVT Gen1 eval
    batch sends to the NMS."""
    g = torch.Generator().manual_seed(48)
    b, k = 48, 1000
    ctr = torch.rand(b, k, 2, generator=g) * torch.tensor([320.0, 256.0])
    wh = torch.rand(b, k, 2, generator=g) * 70 + 6
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).to(cuda)
    valid = (torch.rand(b, k, generator=g) > 0.05).to(cuda)
    ids = (torch.randint(0, 2, (b, k), generator=g).float().to(cuda)
           if with_ids else None)
    before = nms_cuda.nms_mask.launches
    got = nms_cuda.nms_mask(boxes, 0.45, valid, ids)
    torch.cuda.synchronize()
    assert nms_cuda.nms_mask.launches == before + 1
    assert torch.equal(got, nms_plain(boxes, 0.45, valid, ids))


@pytest.mark.parametrize("size", ["tiny", "small"])
def test_eval_step_kernels_match_plain(cuda, size):
    """`make_eval_step` through the kernels against its plain versions, at
    RVT-T (C = 32-256, heads of 32) and RVT-S (C = 48-384, heads of 24)
    widths on a 128 x 160 input: two windows of L = 3 at B = 2 (all rows
    reset, then the second), M = 2 frames a slot; preds and the carried
    states within 2^-4 * max|plain| per tensor (the slice tolerance of
    `chip_smoke.py`), and one launch a stage and timestep of each kernel."""
    from dataclasses import replace

    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.train.step import make_eval_step

    cfg = experiment_preset("gen1", size).model
    cfg = replace(cfg, backbone=replace(cfg.backbone, in_res_hw=(128, 160),
                                        partition_size=(4, 5)))
    det = Detector(cfg, device=cuda, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, PartitionAttention) and m.ls1 is not None:
                for p in (m.ls1, m.ls2):
                    p.copy_(torch.rand(p.shape, generator=g) * 0.4 + 0.1)
    steps = {plain: make_eval_step(det, plain=plain, device=cuda)
             for plain in (False, True)}
    states = {plain: det.init_states(2) for plain in (False, True)}
    c_in = cfg.backbone.input_channels
    rng = np.random.default_rng(2)
    for is_first in ([True, True], [False, True]):
        batch = {"ev": np.minimum(rng.poisson(0.3, (3, 2, 32, 40, 16 * c_in)),
                                  255).astype(np.uint8),
                 "is_first": np.asarray(is_first),
                 "frame_t": rng.integers(0, 3, (2, 2)).astype(np.int32)}
        before = maxvit_cuda.lstm_update.launches
        preds = {}
        for plain, step in steps.items():
            states[plain], preds[plain] = step(states[plain], batch)
        torch.cuda.synchronize()
        assert maxvit_cuda.lstm_update.launches == before + 3 * 4
        assert preds[False].shape == (4, 420, 5 + cfg.head.num_classes)
        for got, want in [(preds[False], preds[True])] + [
                (a, b) for sk, sp in zip(states[False], states[True])
                for a, b in zip(sk, sp)]:
            got, want = got.float(), want.float()
            assert bool(got.isfinite().all())
            err = float((got - want).abs().max())
            assert err <= 2.0 ** -4 * float(want.abs().max()), err
