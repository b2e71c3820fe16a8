"""The port's training loss against the JAX package's on the CPU: the
elementwise losses (1e-6), SimOTA's extrema passes and cheapest-k mask
on tied values (exact), `simota_assign` on padded frames with ignore
boxes and tied costs (masks and indices exact, IoUs at 1e-6),
`mark_low_conf_as_ignore` (exact), `yolox_loss` over its options (every
component at 1e-5) with its gradient against `jax.grad` (1e-5: the
gradient reaches the boxes through SimOTA's IoU-scaled cls target), and
the optimizer: `onecycle_linear` pointwise against the optax schedule
and three clip + AdamW updates against `optax`."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from leod_tpu.config import HeadConfig as JHeadConfig
from leod_tpu.config import TrainingConfig as JTrainingConfig
from leod_tpu.models import head as jhead
from leod_tpu.ops import losses as jlosses
from leod_tpu.ops import simota as jsimota
from leod_tpu.train.optim import make_optimizer as j_make_optimizer
from leod_tpu.train.optim import onecycle_linear as j_onecycle_linear

from leod_tpu_torch.config import HeadConfig, TrainingConfig
from leod_tpu_torch.models import head as thead
from leod_tpu_torch.ops import losses as tlosses
from leod_tpu_torch.ops import simota as tsimota
from leod_tpu_torch.train.optim import make_optimizer, onecycle_linear

IGNORE = 1024
HW = (64, 96)
STRIDES = (8, 16, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores, and torch's
    thread pool in each would oversubscribe them: these many small ops
    then run tens of times slower. They run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _boxes(rng, n):
    """Random cxcywh boxes, some overlapping, some apart."""
    return np.stack([rng.uniform(10, 80, n), rng.uniform(10, 50, n),
                     rng.uniform(4, 40, n), rng.uniform(4, 40, n)],
                    -1).astype(np.float32)


# ---------------------------------------------------------------------------
# Elementwise losses
# ---------------------------------------------------------------------------

def test_box_losses_match_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 200), _boxes(rng, 200)
    b[:20] = a[:20]                                 # perfect overlaps
    for name in ("iou_loss", "giou_loss"):
        got = getattr(tlosses, name)(_t(a), _t(b))
        want = getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(_n(got), _n(want), rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["bce_with_logits", "sigmoid_focal_loss",
                                  "bce_probs"])
def test_logit_losses_match_jax(name):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(300,)) * 6).astype(np.float32)
    y = rng.uniform(0, 1, 300).astype(np.float32)
    y[:50] = np.round(y[:50])
    if name == "bce_probs":
        # probabilities, with the ends that the log clamp catches
        x = 1.0 / (1.0 + np.exp(-x))
        x[:5] = [0.0, 1.0, 1e-45, 1.0 - 1e-8, 0.5]
    got = getattr(tlosses, name)(_t(x), _t(y))
    want = getattr(jlosses, name)(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(_n(got), _n(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# SimOTA
# ---------------------------------------------------------------------------

def test_extract_k_with_ties_matches_jax():
    rng = np.random.default_rng(7)
    for _ in range(10):
        x = rng.integers(0, 6, (3, 5, 37)).astype(np.float32)  # heavy ties
        k = int(rng.integers(1, 11))
        for largest in (True, False):
            got = tsimota._extract_k(_t(x), k, largest)
            want = jsimota._extract_k(jnp.asarray(x), k, largest)
            np.testing.assert_array_equal(_n(got), _n(want))


def test_cheapest_k_mask_with_ties_matches_jax():
    """Tied costs: the mask breaks ties by ascending index (stable ranks),
    exactly as the JAX function does, for every k in [0, K]."""
    rng = np.random.default_rng(3)
    K = 10
    for _ in range(10):
        cost = rng.integers(0, 7, (4, 6, 43)).astype(np.float32)
        k = rng.integers(0, K + 1, (4, 6)).astype(np.int32)
        got = tsimota._cheapest_k_mask(_t(cost), _t(k), K)
        want = jax.vmap(lambda c, kk: jsimota._cheapest_k_mask(c, kk, K))(
            jnp.asarray(cost), jnp.asarray(k))
        np.testing.assert_array_equal(_n(got), _n(want))
        order = np.argsort(cost, axis=-1, kind="stable")
        ranks = np.argsort(order, axis=-1, kind="stable")
        np.testing.assert_array_equal(_n(got), ranks < k[..., None])


def _anchors():
    return jhead.make_anchors(HW, STRIDES), thead.make_anchors(HW, STRIDES)


def _problem(seed, M=6, G=8, C=2):
    """M frames of labels [M, G, 7] (padding rows, ignore boxes, one
    frame with no box, one with ignore boxes only) and train_out
    [M, A, 5+C] decoded from raw maps; anchors copied onto their
    neighbours make exactly tied costs."""
    rng = np.random.default_rng(seed)
    ja, _ = _anchors()
    shifts, strides = np.asarray(ja.shifts), np.asarray(ja.strides)
    centers = np.asarray(ja.centers)
    A = len(strides)
    labels = np.zeros((M, G, 7), np.float32)
    for m in range(M):
        n_valid = {0: 0, 1: 0}.get(m, int(rng.integers(1, 6)))
        n_ignore = 2 if m in (1, 3) else 0
        for g in range(n_valid + n_ignore):
            w, h = rng.uniform(10, 40, 2)
            labels[m, g] = [rng.integers(0, C),
                            rng.uniform(w / 2, HW[1] - w / 2),
                            rng.uniform(h / 2, HW[0] - h / 2), w, h,
                            rng.uniform(0.2, 1), rng.uniform(0.2, 1)]
        labels[m, n_valid:n_valid + n_ignore, 0] = IGNORE
    raw = rng.normal(0, 0.6, (M, A, 5 + C)).astype(np.float32)
    raw[..., 4:] *= 3
    xy = (raw[..., :2] + shifts) * strides[:, None]
    wh = np.exp(raw[..., 2:4]) * strides[:, None]
    out = np.concatenate([xy, wh, raw[..., 4:]], -1).astype(np.float32)
    for m in range(M):
        for g in range(G):
            if labels[m, g].sum() == 0:
                continue
            d = np.abs(centers - labels[m, g, 1:3]).sum(-1) + 1e3 * (
                strides != 8)
            a = int(np.argmin(d))
            out[m, a + 1] = out[m, a]           # tied with its neighbour
            out[m, a - 1] = out[m, a]
    return labels, out


def _j_assign(labels, out, ja, C=2):
    return jax.vmap(lambda lab, o: jsimota.simota_assign(
        lab, o[:, :4], o[:, 4], o[:, 5:], ja.centers, ja.strides,
        num_classes=C, ignore_label=IGNORE))(jnp.asarray(labels),
                                              jnp.asarray(out))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simota_assign_matches_jax(seed):
    labels, out = _problem(seed)
    ja, ta = _anchors()
    want = _j_assign(labels, out, ja)
    o = _t(out)
    got = tsimota.simota_assign(_t(labels), o[..., :4], o[..., 4],
                                o[..., 5:], ta.centers, ta.strides,
                                num_classes=2, ignore_label=IGNORE)
    fg = _n(want.fg)
    assert fg.any() and _n(want.ignore).any()
    for k in ("fg", "ignore", "num_fg", "num_gt"):
        np.testing.assert_array_equal(_n(getattr(got, k)),
                                      _n(getattr(want, k)), err_msg=k)
    np.testing.assert_array_equal(_n(got.matched_gt)[fg],
                                  _n(want.matched_gt)[fg])
    np.testing.assert_allclose(_n(got.pred_iou), _n(want.pred_iou),
                               rtol=1e-6, atol=1e-6)


def test_mark_low_conf_as_ignore_matches_jax():
    labels, _ = _problem(4)
    thr = np.asarray([0.6, 0.45], np.float32)
    got = tsimota.mark_low_conf_as_ignore(_t(labels), _t(thr), IGNORE)
    want = jsimota.mark_low_conf_as_ignore(jnp.asarray(labels),
                                           jnp.asarray(thr), IGNORE)
    np.testing.assert_array_equal(_n(got), _n(want))
    assert (_n(got)[..., 0] == IGNORE).sum() > (labels[..., 0] == IGNORE).sum()


# ---------------------------------------------------------------------------
# yolox_loss and its gradient
# ---------------------------------------------------------------------------

LOSS_CASES = [
    # use_l1, bbox_loss_weighting, obj_focal_loss, ignore_bg_k,
    # ignore_bbox_thresh
    (False, "", False, 0.0, None),
    (True, "", False, 0.0, None),
    (False, "obj", False, 0.0, None),
    (False, "cls-w**2", False, 0.0, None),
    (False, "objxcls", True, 0.0, None),
    (False, "", False, 0.1, None),
    (True, "obj", True, 0.05, (0.6, 0.45)),
    (False, "", False, 0.0, (0.6, 0.45)),
]


@pytest.mark.parametrize("use_l1,weighting,focal,bg_k,ign", LOSS_CASES)
def test_yolox_loss_and_grad_match_jax(use_l1, weighting, focal, bg_k, ign):
    labels, out = _problem(11)
    kw = dict(use_l1=use_l1, bbox_loss_weighting=weighting,
              obj_focal_loss=focal, ignore_bg_k=bg_k, ignore_bbox_thresh=ign,
              ignore_label=IGNORE, max_gt=labels.shape[1])
    jcfg, tcfg = JHeadConfig(**kw), HeadConfig(**kw)
    ja, ta = _anchors()
    fm = np.ones(len(labels), bool)
    fm[-1] = False                                   # a padded frame slot

    def jloss(o):
        return jhead.yolox_loss(o, jnp.asarray(labels), jnp.asarray(fm), ja,
                                jcfg)

    want = jloss(jnp.asarray(out))
    want_grad = jax.grad(lambda o: jloss(o)["loss"])(jnp.asarray(out))
    o = _t(out).requires_grad_(True)
    got = thead.yolox_loss(o, _t(labels), _t(fm), ta, tcfg)
    got["loss"].backward()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_n(got[k]), _n(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    g, wg = _n(o.grad), _n(want_grad)
    assert np.abs(wg[..., :4]).max() > 0             # the boxes get grad
    np.testing.assert_allclose(g, wg, rtol=1e-5,
                               atol=1e-5 * np.abs(wg).max())


def test_yolox_loss_grad_reaches_boxes_through_the_cls_target():
    """With the regression weight at zero and no L1, the boxes' gradient
    comes from the cls target's IoU alone: SimOTA's matched IoU is not
    cut from the graph, as `jax.grad` of the JAX loss does not cut it."""
    labels, out = _problem(12)
    kw = dict(reg_weight=0.0, max_gt=labels.shape[1])
    ja, ta = _anchors()
    fm = np.ones(len(labels), bool)
    want = jax.grad(lambda o: jhead.yolox_loss(
        o, jnp.asarray(labels), jnp.asarray(fm), ja,
        JHeadConfig(**kw))["loss"])(jnp.asarray(out))
    o = _t(out).requires_grad_(True)
    thead.yolox_loss(o, _t(labels), _t(fm), ta,
                     HeadConfig(**kw))["loss"].backward()
    box_grad = _n(o.grad)[..., :4]
    assert np.abs(box_grad).max() > 1e-6
    np.testing.assert_allclose(box_grad, _n(want)[..., :4], rtol=1e-5,
                               atol=1e-5 * np.abs(_n(want)[..., :4]).max())


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,pct,div", [(1000, 0.005, 20.0),
                                           (400, 0.01, 25.0),
                                           (50, 0.1, 25.0)])
def test_onecycle_matches_optax_schedule(total, pct, div):
    args = (2e-4, total, pct, div, 10000.0)
    ours, theirs = onecycle_linear(*args), j_onecycle_linear(*args)
    got = np.array([ours(i) for i in range(total + 3)])
    want = np.array([float(theirs(i)) for i in range(total + 3)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip,wd,sched", [(1.0, 0.0, True),
                                           (0.05, 0.1, True),
                                           (0.0, 0.01, False)])
def test_clip_adamw_matches_optax(clip, wd, sched):
    """Three updates from the same gradients: clip by value, then AdamW
    at schedule(0), schedule(1), schedule(2), on a random tree."""
    kw = dict(learning_rate=3e-2, weight_decay=wd, gradient_clip_val=clip,
              max_steps=8)
    jcfg = JTrainingConfig(**kw)
    jcfg = replace(jcfg, lr_scheduler=replace(jcfg.lr_scheduler, use=sched,
                                              pct_start=0.25))
    tcfg = TrainingConfig(**kw)
    tcfg = replace(tcfg, lr_scheduler=replace(tcfg.lr_scheduler, use=sched,
                                              pct_start=0.25))
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 0.2).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    tx, _ = j_make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v.copy())) for k, v in params.items()}
    opt, _ = make_optimizer(tcfg, tp.values())
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for k, p in tp.items():
            p.grad = _t(g[k].copy())
        opt.step()
    assert opt.count == 3
    for k in shapes:
        np.testing.assert_allclose(_n(tp[k]), _n(jp[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
