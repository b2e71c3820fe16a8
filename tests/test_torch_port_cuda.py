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
`block_mlp` and its model-axis mode `block_mlp_tp` alone at every
width its tiles take, from one row to the RVT-B Gen1 stage rows at
B = 16, with a ragged last 64-row tile, by the plan and with clusters
of 1 to 8 CTAs sharing a unit, each launch again bit for bit,
the GLU MLP and SiLU, an
fp32 and a bf16 cell state, the ConvLSTM update `lstm_update` alone at
every width, with a ragged last 128-row tile, at B = 1 and 2, with K
split over clusters of 1 to 8 CTAs, and launched back to back at the
stage shapes at B = 1 and 8 by its own plan, `block_mlp`, `lstm_update`
and the whole stage `fused_stage` at RVT-B Gen4's four stage shapes
(96 x 160 down to 12 x 20, a 6 x 10 partition) at B = 1 and 12, the
attention half (window and grid) and the whole stage at a space rank's
halves of them (48 x 160 down to 6 x 20, B = 12), NMS with and without class ids at
K = 1, 37, 1000 and 1024, NMS at IoUs on the threshold and on the floats
either side of it (identical and nested boxes), the NMS sweep's chains
(staircases across 32-box words, box 0 suppressing all, no overlap, all
invalid, an invalid box or a class change inside a chain) at K = 1 to
1024 and B = 1 and 8, 40 NMS launches back to back, NMS at the 48
images of an eval batch and at the 336 of a pseudo-label batch, the
pseudo-labeller's eval step at RVT-B width over 16 slots (8 and their
h-flipped copies), the eval step through the kernels against its
plain versions at RVT-T and RVT-S widths, inputs the kernels refuse,
and training: an fp32 train step on the card against the same step on
the CPU (loss 1e-4, each module's grad norm 1e-3, relative), a bf16
step that keeps fp32 parameters and moves them, and `Trainer.fit`,
whose validation launches every kernel while its steps launch none.
Deployment: each of the six `leod_tpu_torch::` custom ops (defined in
C++, `csrc/torch_ops.cpp`) dispatched to its CUDA implementation and
counted, and under `torch.library.opcheck`, the serving step exported (on
the card, and on the CPU for both platforms), loaded on the card and run
against the live step, and the event voxelizer on the card equal to the
CPU's. Tracing: an eval step's span, placed on the profiler's timeline,
holds the host's launch of each of its kernels.

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
# C -> the head width the kernels take it in: the stage widths of RVT-T
# and RVT-B in heads of 32, of RVT-S in heads of 24 (the library's own
# list is `kAttnShapes` in csrc/torch_ops.cpp)
DIM_HEAD = {32: 32, 64: 32, 128: 32, 256: 32, 512: 32,
            48: 24, 96: 24, 192: 24, 384: 24}
KERNEL_DIMS = tuple(sorted(DIM_HEAD))
# the RVT-B and RVT-S Gen1 stage shapes: (C, (H, W)) at strides 4-32
STAGES_B = [(64, (64, 80)), (128, (32, 40)), (256, (16, 20)), (512, (8, 10))]
# their token rows at LEOD's Gen1 test batch, B = 16
GEN1_B16_ROWS = {dim: 16 * h * w for dim, (h, w) in STAGES_B}
STAGES_S = [(48, (64, 80)), (96, (32, 40)), (192, (16, 20)), (384, (8, 10))]
# RVT-B Gen4's (input 384 x 640), in its 6 x 10 partition (T = 60)
STAGES_GEN4 = [(64, (96, 160)), (128, (48, 80)), (256, (24, 40)),
               (512, (12, 20))]
PARTITION_GEN4 = (6, 10)
# a space rank's rows of them at space 2 (`parallel/space.py`): its window
# layout, and the grid layout after the row exchange, maps of h / 2 rows
STAGES_GEN4_SPACE2 = [(dim, (h // 2, w)) for dim, (h, w) in STAGES_GEN4]


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
    """C x R x MLP kind x cluster size (CTAs a unit of row tiles, splitting
    its hidden chunks; None: the kernel's plan) x the model axis's mode:
    R of one row, under one 64-row tile, a tile and a quarter (the serve
    step's stage 4 at B = 1), ten tiles and a ragged last one at every
    width, and the RVT-B Gen1 stage rows at B = 16 (LEOD's test batch) at
    theirs. A forced cluster needs a hidden chunk a CTA (64 units; 32 of
    each half in the GLU) and 8 projection columns a CTA."""
    cases = []
    kinds = (("gelu", False), ("silu", False), ("gelu", True))
    for dim in KERNEL_DIMS:
        rows_kinds = [(rows, kind) for rows in (1, 63, 80, 640, 1000)
                      for kind in kinds]
        if dim in GEN1_B16_ROWS:
            rows_kinds.append((GEN1_B16_ROWS[dim], ("gelu", False)))
        for rows, (act, gated) in rows_kinds:
            chunks = (PartitionAttention(dim, (4, 5), "window",
                                         dim_head=DIM_HEAD[dim],
                                         mlp_gated=gated)
                      .mlp.proj_out.in_features // (32 if gated else 64))
            for cluster in (None, 1, 2, 4, 8):
                if cluster is None or (cluster <= chunks and
                                       dim % (8 * cluster) == 0):
                    for tp in (False, True):
                        cases.append((dim, rows, act, gated, cluster, tp))
    return cases


@pytest.mark.parametrize("dim,rows,act,gated,cluster,tp", _mlp_cases())
def test_block_mlp_kernel_matches_plain(cuda, dim, rows, act, gated, cluster,
                                        tp):
    """`block_mlp` (or, with `tp`, `block_mlp_tp`: x1 and the fp32
    partial from an fp32 out-projection sum a) against its plain version,
    one launch, the plan's cluster size and tiles, and a second launch
    equal bit for bit (a cluster adds its partial sums in rank order)."""
    blk = _randomized(PartitionAttention(dim, (4, 5), "window",
                                         dim_head=DIM_HEAD[dim],
                                         mlp_gated=gated, mlp_act=act),
                      dim + rows, cuda)
    g = torch.Generator(device=cuda).manual_seed(rows)
    x, o = (torch.randn(rows, dim, device=cuda, generator=g
                        ).to(torch.bfloat16) for _ in range(2))
    if tp:
        wrapper, args = maxvit_cuda.block_mlp_tp, (x, o.float(), blk)
        want = maxvit_cuda.block_mlp_tp_plain(*args)
    else:
        wrapper, args = maxvit_cuda.block_mlp, (x, o, blk)
        want = (maxvit_cuda.block_mlp_plain(*args),)
    before = wrapper.launches
    got = wrapper(*args, act, gated, cluster=cluster)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    cs, tiles, split, ctas = wrapper.plan
    assert tiles == (rows + 63) // 64 and split == (tiles if cs > 1 else 0)
    assert cluster is None or cs == cluster
    assert ctas % cs == 0
    got = got if tp else (got,)
    for k, w in zip(got, want):
        _close(k, w)
    again = wrapper(*args, act, gated, cluster=cluster)
    again = again if tp else (again,)
    assert all(torch.equal(k, a) for k, a in zip(got, again))


def _attention_cases():
    """C (with its head width) x partition (T = 8, 20, 60, 80) x
    window/grid x LN1 skipped or not x B x every cluster size the width
    takes (a head group a CTA)."""
    cases = []
    for dim in KERNEL_DIMS:
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
    for dim in KERNEL_DIMS:
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


@pytest.mark.parametrize("b", [1, 12])
@pytest.mark.parametrize("dim,hw", STAGES_GEN4)
def test_block_mlp_at_the_gen4_stage_shapes(cuda, dim, hw, b):
    """The per-token half at RVT-B Gen4's rows (up to 184,320 at stage 1
    for B = 12), by its own plan, and again bit for bit."""
    blk = _randomized(PartitionAttention(dim, PARTITION_GEN4, "window",
                                         dim_head=DIM_HEAD[dim]), dim + b,
                      cuda)
    g = torch.Generator(device=cuda).manual_seed(dim + b)
    x, o = (torch.randn(b * hw[0] * hw[1], dim, device=cuda, generator=g
                        ).to(torch.bfloat16) for _ in range(2))
    before = maxvit_cuda.block_mlp.launches
    got = maxvit_cuda.block_mlp(x, o, blk, "gelu", False)
    torch.cuda.synchronize()
    assert maxvit_cuda.block_mlp.launches == before + 1
    _close(got, maxvit_cuda.block_mlp_plain(x, o, blk))
    assert torch.equal(got, maxvit_cuda.block_mlp(x, o, blk, "gelu", False))


@pytest.mark.parametrize("b", [1, 12])
@pytest.mark.parametrize("dim,hw", STAGES_GEN4)
def test_lstm_update_at_the_gen4_stage_shapes(cuda, dim, hw, b):
    x, h, c, gates = _lstm_inputs(dim, b, hw, torch.bfloat16, cuda, dim + b)
    before = maxvit_cuda.lstm_update.launches
    hk, ck = maxvit_cuda.lstm_update(x, h, c, gates)
    torch.cuda.synchronize()
    assert maxvit_cuda.lstm_update.launches == before + 1
    hp, cp = maxvit_cuda.lstm_update_plain(x, h, c, gates)
    _close(hk, hp)
    _close(ck, cp)


@pytest.mark.parametrize("b", [1, 12])
@pytest.mark.parametrize("dim,hw", STAGES_GEN4)
def test_fused_stage_at_the_gen4_stage_shapes(cuda, dim, hw, b):
    """The whole stage of RVT-B Gen4 (one block pair, then the ConvLSTM
    update) from warm (h, c) in bf16, as the serving path keeps them."""
    pair = _pair(dim, PARTITION_GEN4, False, "gelu", cuda, seed=dim)
    gates = _randomized(_SplitGateConv(dim), dim + 1, cuda)
    g = torch.Generator(device=cuda).manual_seed(dim + b)
    x, h, c = (torch.randn(b, *hw, dim, device=cuda, generator=g)
               for _ in range(3))
    x, h, c = x.to(torch.bfloat16), (h * 0.5).to(torch.bfloat16), \
        (c * 0.5).to(torch.bfloat16)
    before = maxvit_cuda.fused_stage.launches
    hk, ck = maxvit_cuda.fused_stage(x, h, c, [pair], gates, PARTITION_GEN4,
                                     True, dim_head=DIM_HEAD[dim])
    torch.cuda.synchronize()
    assert maxvit_cuda.fused_stage.launches == before + 1
    hp, cp = maxvit_cuda.fused_stage_plain(x, h, c, [pair], gates,
                                           PARTITION_GEN4)
    _close(hk, hp)
    _close(ck, cp)


@pytest.mark.parametrize("grid_kind", [False, True])
@pytest.mark.parametrize("dim,hw", STAGES_GEN4_SPACE2)
def test_block_attention_at_the_gen4_space_rank_shapes(cuda, dim, hw,
                                                       grid_kind):
    """The attention half at a space rank's RVT-B Gen4 maps (B 12, h / 2
    rows): the window layout of its rows, and the grid layout the row
    exchange gives it."""
    blk = _randomized(PartitionAttention(dim, PARTITION_GEN4,
                                         "grid" if grid_kind else "window",
                                         dim_head=DIM_HEAD[dim]), dim, cuda)
    g = torch.Generator(device=cuda).manual_seed(dim + grid_kind)
    x = torch.randn(12, *hw, dim, device=cuda, generator=g).to(torch.bfloat16)
    part, rev = ((grid_partition, grid_reverse) if grid_kind
                 else (window_partition, window_reverse))
    got = maxvit_cuda.block_attention(x, blk, grid_kind)
    torch.cuda.synchronize()
    want = rev(maxvit_cuda.block_attention_plain(part(x, *PARTITION_GEN4),
                                                 blk),
               *PARTITION_GEN4, *hw)
    _close(got, want)


@pytest.mark.parametrize("dim,hw", STAGES_GEN4_SPACE2)
def test_fused_stage_at_the_gen4_space_rank_shapes(cuda, dim, hw):
    """The whole stage of RVT-B Gen4 at a space rank's maps (B 12, h / 2
    rows), the window and grid blocks on them as they are."""
    pair = _pair(dim, PARTITION_GEN4, False, "gelu", cuda, seed=dim)
    gates = _randomized(_SplitGateConv(dim), dim + 1, cuda)
    g = torch.Generator(device=cuda).manual_seed(dim)
    x, h, c = (torch.randn(12, *hw, dim, device=cuda, generator=g)
               for _ in range(3))
    x, h, c = x.to(torch.bfloat16), (h * 0.5).to(torch.bfloat16), \
        (c * 0.5).to(torch.bfloat16)
    hk, ck = maxvit_cuda.fused_stage(x, h, c, [pair], gates, PARTITION_GEN4,
                                     True, dim_head=DIM_HEAD[dim])
    torch.cuda.synchronize()
    hp, cp = maxvit_cuda.fused_stage_plain(x, h, c, [pair], gates,
                                           PARTITION_GEN4)
    _close(hk, hp)
    _close(ck, cp)


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


@pytest.mark.parametrize("with_ids", [False, True])
def test_nms_kernel_matches_plain_at_the_pseudo_label_batch(cuda, with_ids):
    """336 images of K = 1000: the 2B * L = 16 * 21 frames a pseudo-label
    batch with h-flip sends to the NMS (a 43 MB suppression mask)."""
    g = torch.Generator().manual_seed(336)
    b, k = 336, 1000
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


def test_eval_step_at_16_slots_matches_plain(cuda):
    """The pseudo-labeller's eval step: RVT-B Gen1 at full width (256 x
    320 input), 8 slots and their h-flipped copies as 16
    (`data/loader.py` `hflip_batch`), every frame of an L = 3 window
    predicted (`harvest_all_frames`), two windows (all rows reset, then
    none): the kernels' preds and carried states within 2^-4 *
    max|plain| of the plain versions', and a launch a stage and timestep
    of each kernel."""
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.data.loader import hflip_batch
    from leod_tpu_torch.selftrain.runner import harvest_all_frames
    from leod_tpu_torch.train.step import make_eval_step

    cfg = experiment_preset("gen1", "base")
    det = Detector(cfg.model, device=cuda, seed=0)
    g = torch.Generator().manual_seed(16)
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, PartitionAttention) and m.ls1 is not None:
                for p in (m.ls1, m.ls2):
                    p.copy_(torch.rand(p.shape, generator=g) * 0.4 + 0.1)
    steps = {plain: make_eval_step(det, plain=plain, device=cuda)
             for plain in (False, True)}
    states = {plain: det.init_states(16) for plain in (False, True)}
    rng = np.random.default_rng(16)
    L, b = 3, 8
    for first in (True, False):
        batch = {"ev": np.minimum(rng.poisson(0.3, (L, b, 20, 240, 304)),
                                  255).astype(np.uint8),
                 "is_first": np.full(b, first),
                 "is_padded": np.zeros((b, L), bool),
                 "labels": [[None] * b for _ in range(L)]}
        hb = harvest_all_frames(hflip_batch(batch), cfg)
        before = maxvit_cuda.block_attention.launches
        preds = {}
        for plain, step in steps.items():
            states[plain], preds[plain] = step(states[plain], hb)
        torch.cuda.synchronize()
        n_pairs = sum(cfg.model.backbone.num_blocks)
        assert maxvit_cuda.block_attention.launches == before + 2 * n_pairs * L
        assert preds[False].shape == (2 * b * L, 1680,
                                      5 + cfg.model.head.num_classes)
        for got, want in [(preds[False], preds[True])] + [
                (x, y) for sk, sp in zip(states[False], states[True])
                for x, y in zip(sk, sp)]:
            got, want = got.float(), want.float()
            assert bool(got.isfinite().all())
            err = float((got - want).abs().max())
            assert err <= 2.0 ** -4 * float(want.abs().max()), err


def _train_model_cfg(hw=(64, 96), partition=(2, 3), size="tiny"):
    from dataclasses import replace

    from leod_tpu_torch.config import experiment_preset

    cfg = experiment_preset("gen1", size)
    bb = replace(cfg.model.backbone, in_res_hw=hw, partition_size=partition)
    return replace(cfg, model=replace(cfg.model, backbone=bb))


def _train_batch(cfg, b, L, m, g, seed):
    rng = np.random.default_rng(seed)
    h, w = cfg.model.backbone.in_res_hw
    c = cfg.model.backbone.input_channels
    labels = np.zeros((b, m, g, 7), np.float32)
    for i in range(b):
        for j in range(m):
            for k in range(int(rng.integers(1, g))):
                bw, bh = rng.uniform(10, 40, 2)
                labels[i, j, k] = [rng.integers(0, 2),
                                   rng.uniform(bw / 2, w - bw / 2),
                                   rng.uniform(bh / 2, h - bh / 2), bw, bh,
                                   1.0, 1.0]
    return {"ev": np.minimum(rng.poisson(1.5, (L, b, h // 4, w // 4, 16 * c)),
                             255).astype(np.uint8),
            "is_first": np.ones(b, bool),
            "frame_t": np.tile(np.arange(m, dtype=np.int32), (b, 1)),
            "frame_mask": np.ones((b, m), bool), "labels": labels}


def _one_train_step(cfg, dev, dtype, batch, b):
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.train.optim import make_optimizer
    from leod_tpu_torch.train.step import TrainState, make_train_step

    det = Detector(cfg.model, dtype=dtype, device=dev, seed=0,
                   trainable=True)
    before = [p.detach().clone() for p in det.parameters()]
    opt, _ = make_optimizer(cfg.training, det.parameters())
    st, m = make_train_step(det, opt)(
        TrainState(states=det.init_states(b), step=0), batch)
    return det, before, st, {k: float(v) for k, v in m.items()}


def test_fp32_train_step_on_the_card_matches_the_cpu(cuda):
    """One fp32 step (TF32 off) from one seed's weights and one batch:
    the card's loss within 1e-4 and each module's gradient norm within
    1e-3 of the CPU's, relative. The CPU step is held against the JAX
    package's in tests/test_torch_port_train_step.py."""
    cfg = _train_model_cfg()
    batch = _train_batch(cfg, 2, 3, 2, 6, seed=3)
    got = _one_train_step(cfg, cuda, torch.float32, batch, 2)[3]
    want = _one_train_step(cfg, "cpu", torch.float32, batch, 2)[3]
    assert got["num_fg"] == want["num_fg"] > 0
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    for mod in ("backbone", "fpn", "head"):
        k = f"grad_norm/{mod}"
        assert got[k] == pytest.approx(want[k], rel=1e-3), k


def test_bf16_train_step_keeps_fp32_parameters_and_moves_them(cuda):
    cfg = _train_model_cfg()
    batch = _train_batch(cfg, 2, 3, 2, 6, seed=4)
    det, before, st, m = _one_train_step(cfg, cuda, torch.bfloat16, batch, 2)
    assert all(np.isfinite(v) for v in m.values()), m
    params = list(det.parameters())
    assert all(p.dtype == torch.float32 for p in params)
    assert sum(not torch.equal(a, p) for a, p in zip(before, params)) > \
        len(params) // 2
    for h, c in st.states:
        assert h.dtype == c.dtype == torch.bfloat16
        assert bool(h.isfinite().all()) and bool(c.isfinite().all())


def test_fit_validates_through_every_kernel(cuda, tmp_path):
    """`Trainer.fit` on the card: two bf16 steps through the module
    forwards (no kernel launch), then a validation whose streaming eval
    launches every kernel wrapper; a checkpoint restores its step."""
    from dataclasses import replace

    from leod_tpu_torch.data.synthetic import render_array_dataset
    from leod_tpu_torch.train.trainer import Trainer

    cfg = _train_model_cfg(hw=(128, 160), partition=(4, 5))
    dst = replace(cfg.dataset, resolution_hw=(120, 152), sequence_length=3)
    cfg = replace(cfg, dataset=dst, save_dir=str(tmp_path), exp_name="t",
                  training=replace(cfg.training, batch_size_train=2,
                                   batch_size_eval=2, val_check_interval=2,
                                   max_det_frames=2))
    splits = render_array_dataset(dst, 2, 2, 0, seed=0, num_reprs=12,
                                  hw=dst.resolution_hw, first_label_repr=2,
                                  label_every=2)
    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    trainer = Trainer(cfg, device=cuda)
    seen = {}
    trainer.logger.add_sink(lambda rec: seen.update(
        {w.__name__: w.launches for w in wrappers})
        if rec.get("step") == 2 and "loss" in rec else None)
    for w in wrappers:
        w.launches = 0
    state = trainer.fit(max_steps=2, log_every=1, sequences=splits["train"],
                        val_sequences=splits["val"])
    assert state.step == 2
    assert seen and not any(seen.values()), seen       # the steps: none
    assert all(w.launches > 0 for w in wrappers), \
        {w.__name__: w.launches for w in wrappers}
    st, path = trainer.restore_latest(trainer.init_state(2))
    assert path is not None and st.step == 2


# ---------------------------------------------------------------------------
# Deployment: the custom ops, the exported artifact, the voxelizer
# ---------------------------------------------------------------------------

def _op_inputs(dev):
    """Each custom op's arguments at RVT-B Gen1's first stage shape
    (B = 1, 64 x 80 x 64, 8 x 10 partitions) and the NMS at one image of
    K = 1000, with the op's CUDA implementation (`csrc/torch_ops.cpp`)
    called directly: a redispatch to the CUDA key, past the dispatcher's
    choice of kernel."""
    wb, _ = _pair(64, (8, 10), False, "gelu", dev, first=False)
    gates = _randomized(_SplitGateConv(64), 3, dev)
    g = torch.Generator().manual_seed(5)
    x, o, h = (torch.randn(1, 64, 80, 64, generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    c = torch.randn(1, 64, 80, 64, generator=g).to(dev)
    boxes, valid, ids = _nms_inputs(1000, 1, dev, seed=2)
    args = {
        "block_attention": (
            x, *maxvit_cuda._norm1(wb), wb.attn.qkv.weight,
            wb.attn.qkv.bias, 32, 8, 10, True, 1e-5, 0),
        "block_mlp": (
            x, o, *maxvit_cuda._mlp_weights(wb), "gelu", False, 1e-5, 0),
        "lstm_update": (x, h, c, gates.weight, gates.bias, 0),
        "nms_mask": (boxes, 0.45, valid, ids),
        "block_mlp_tp": (x, c, *maxvit_cuda._mlp_tp_weights(wb), "gelu",
                         False, 1e-5, 0),
        "block_residual": (x, c, wb.mlp.proj_out.bias, wb.ls2),
    }
    maxvit_cuda.block_attention.launches     # the library loaded
    cuda_key = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)

    def direct(name):
        op = getattr(torch.ops.leod_tpu_torch, name).default
        return lambda *a: op.redispatch(cuda_key, *a)
    return {name: (direct(name), a) for name, a in args.items()}


def _nms_inputs(k, b, dev, seed):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(b, k, 2, generator=g) * 300
    wh = torch.rand(b, k, 2, generator=g) * 60 + 2
    boxes = torch.cat([xy, xy + wh], -1).to(dev)
    valid = (torch.rand(b, k, generator=g) < 0.9).to(dev)
    ids = torch.randint(0, 2, (b, k), generator=g).float().to(dev)
    return boxes, valid, ids


OP_NAMES = ("block_attention", "block_mlp", "lstm_update", "nms_mask",
            "block_mlp_tp", "block_residual")
OP_WRAPPER = {"block_attention": maxvit_cuda.block_attention,
              "block_mlp": maxvit_cuda.block_mlp,
              "lstm_update": maxvit_cuda.lstm_update,
              "nms_mask": nms_cuda.nms_mask,
              "block_mlp_tp": maxvit_cuda.block_mlp_tp,
              "block_residual": maxvit_cuda.block_residual}


@pytest.mark.parametrize("op", OP_NAMES)
def test_custom_op_is_its_direct_launch(cuda, op):
    """A dispatch-and-count check: `torch.ops.leod_tpu_torch.<op>` on
    CUDA tensors reaches the op's CUDA implementation (bit-equal to a
    redispatch to the CUDA key, which calls the same C++ function, so
    only a wrong choice of kernel by the dispatcher fails it), and the
    library counts one launch for it. The kernels' agreement with their
    plain versions is the other tests' work."""
    impl, args = _op_inputs(cuda)[op]
    want = impl(*args)
    before = OP_WRAPPER[op].launches
    got = getattr(torch.ops.leod_tpu_torch, op).default(*args)
    torch.cuda.synchronize()
    assert OP_WRAPPER[op].launches == before + 1
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


@pytest.mark.parametrize("op", OP_NAMES)
def test_custom_op_opcheck_on_the_card(cuda, op):
    """`torch.library.opcheck` of each op on CUDA tensors: its schema,
    its fake implementation against the kernel's output, and the op
    under AOT dispatch."""
    _, args = _op_inputs(cuda)[op]
    torch.library.opcheck(getattr(torch.ops.leod_tpu_torch, op).default,
                          args)


def _tiny_det(dev, seed=0):
    from dataclasses import replace

    from leod_tpu_torch.config import derive, experiment_preset
    from leod_tpu_torch.models.detector import Detector

    cfg = experiment_preset("gen1", "tiny")
    bb = replace(cfg.model.backbone, in_res_hw=(128, 160),
                 partition_size=(4, 5))
    cfg = derive(replace(cfg, model=replace(cfg.model, backbone=bb)))
    det = Detector(cfg.model, device=dev, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, PartitionAttention) and m.ls1 is not None:
                for p in (m.ls1, m.ls2):
                    p.copy_(torch.rand(p.shape, generator=g) * 0.4 + 0.1)
    return cfg, det


def test_step_span_holds_its_kernel_launches(cuda):
    """The eval step's span, placed on the profiler's timeline through
    `profiling_start_time_ns` (the tracer's clock), holds the host's
    launch of every kernel the step made, to within 200 us: the RVT-T
    eval step at B = 2, L = 3, once warm."""
    from leod_tpu_torch import timing
    from leod_tpu_torch.serve import serve_input_shape
    from leod_tpu_torch.train.step import make_eval_step

    cfg, det = _tiny_det(cuda)
    step = make_eval_step(det, device=cuda)
    rng = np.random.default_rng(3)
    shape = (3,) + serve_input_shape(cfg, 2)
    batch = {"ev": np.minimum(rng.poisson(0.3, shape), 255).astype(np.uint8),
             "is_first": np.ones(2, bool),
             "frame_t": rng.integers(0, 3, (2, 2)).astype(np.int32)}
    states = det.init_states(2)
    states, _ = step(states, batch)
    torch.cuda.synchronize()
    timing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with timing.recording(), torch.profiler.profile(activities=acts) as prof:
        with timing.span("step"):
            states, _ = step(states, batch)
        torch.cuda.synchronize()
    (sp,) = [s for s in timing.recorded()["spans"] if s.name == "step"]
    t0 = prof.profiler.profiling_start_time_ns
    launches = [(t0 + e.time_range.start * 1e3, t0 + e.time_range.end * 1e3)
                for e in prof.events() if "LaunchKernel" in e.name]
    assert len(launches) >= 3 * 4 * 2     # two kernels a stage and step
    assert min(a for a, _ in launches) >= sp.start_ns - 200e3
    assert max(b for _, b in launches) <= sp.end_ns + 200e3


@pytest.mark.parametrize("traced_on", ["cuda", "cpu"])
def test_exported_artifact_runs_the_kernels(cuda, tmp_path, traced_on):
    """The serving step of an RVT-T-wide bf16 model at 128 x 160 (B = 2),
    exported on the card, or on the CPU for both platforms, saved, and
    loaded on the card: two steps (all reset, then one row reset and one
    idle) equal the live step on the card within 1e-5 relative, 1e-6
    absolute, valid exactly, and each step launches the live step's
    kernels."""
    from leod_tpu_torch.serve import (artifact_meta, export_serve_step,
                                      load_artifact, load_artifact_exported,
                                      make_serve_step, save_artifact,
                                      serve_input_shape, zero_states_like)

    cfg, det = _tiny_det(cuda)
    src = det if traced_on == "cuda" else _tiny_det("cpu")[1]
    path = str(tmp_path / "m.pt2")
    ep = export_serve_step(src, cfg, 2, conf_threshold=0.0,
                           platforms=("cuda", "cpu"))
    save_artifact(ep, path, artifact_meta(cfg, 2, True, 0.0))
    step_fn, meta = load_artifact(path, device=cuda)
    assert meta["platforms"] == ["cuda", "cpu"]
    live = make_serve_step(det, conf_threshold=0.0, device=cuda)
    st_a = det.init_states(2)
    st_b = zero_states_like(load_artifact_exported(path)[0], device=cuda)
    rng = np.random.default_rng(3)
    n_blocks = 2 * sum(cfg.model.backbone.num_blocks)
    for reset, active in (([1, 1], [1, 1]), ([0, 1], [1, 0])):
        ev = torch.from_numpy(np.minimum(rng.poisson(
            0.3, serve_input_shape(cfg, 2)), 255).astype(np.uint8)).to(cuda)
        reset = torch.tensor(reset, dtype=torch.bool, device=cuda)
        active = torch.tensor(active, dtype=torch.bool, device=cuda)
        st_a, d_a, v_a = live(st_a, ev, reset, active)
        before = {n: w.launches for n, w in OP_WRAPPER.items()}
        st_b, d_b, v_b = step_fn(st_b, ev, reset, active)
        torch.cuda.synchronize()
        assert {n: w.launches - before[n] for n, w in OP_WRAPPER.items()} \
            == {"block_attention": n_blocks, "block_mlp": n_blocks,
                "lstm_update": 4, "nms_mask": 1, "block_mlp_tp": 0,
                "block_residual": 0}
        assert torch.equal(v_b, v_a)
        torch.testing.assert_close(d_b, d_a, rtol=1e-5, atol=1e-6)
        for (ha, ca), (hb, cb) in zip(st_a, st_b):
            torch.testing.assert_close(hb, ha, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(cb, ca, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("windows", [1, 6])
def test_voxelizer_on_the_card_equals_the_cpu(cuda, windows):
    """`stacked_histogram_batch` and `mixed_density_stack` on the card
    equal the CPU's exactly: Gen1's 240 x 304 canvas, 10 bins, 30k events
    a window with out-of-canvas and padded ones, and events on the bin
    edges."""
    from leod_tpu_torch.ops import voxel

    rng = np.random.default_rng(windows)
    n, h, w = 30_000, 240, 304
    x = rng.integers(-2, w + 2, (windows, n))
    y = rng.integers(-2, h + 2, (windows, n))
    p = rng.integers(0, 2, (windows, n))
    t = np.sort(rng.integers(0, 50_000, (windows, n)), axis=1)
    t[:, :11] = np.arange(11) * 5_000
    t = np.sort(t, axis=1)
    valid = rng.uniform(size=(windows, n)) < 0.95
    args = [torch.from_numpy(a) for a in (x, y, p, t, valid)]
    kw = dict(bins=10, height=h, width=w)
    want = voxel.stacked_histogram_batch(*args, **kw)
    got = voxel.stacked_histogram_batch(*(a.to(cuda) for a in args), **kw)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    want = voxel.mixed_density_stack(*(a[0] for a in args), **kw)
    got = voxel.mixed_density_stack(*(a[0].to(cuda) for a in args), **kw)
    assert torch.equal(got.cpu(), want)
