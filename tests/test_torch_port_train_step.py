"""The port's train step against the JAX package's on the CPU, in float32,
at RVT-T widths (64 x 96 input, L 3, B 2, M 2), from one set of weights
(`load_jax_variables`) and the same batches: the first step's loss and
components and every parameter's gradient (1e-4, the gradient relative
to its tensor's largest), then three steps of the real optimizers (clip
by value, AdamW with weight decay, the Gen1 preset's OneCycle schedule)
after which the parameters, the BN statistics and the carried LSTM
states agree to 1e-4 (of the tensor's largest where that is above one),
and AdamW's moments to 1e-4 of each tensor's largest.
And the port's own: every remat policy ("full", "dots", "stage1",
"none") gives the same loss and gradients, a reset row's poisoned state
does not leak, the states leave the step detached.

AdamW divides each gradient by its own magnitude, so a parameter whose
gradient is zero but for rounding (the key bias of attention, which the
softmax cancels; directions a LayerNorm removes) moves by up to the
learning rate either way in either package. The three steps therefore
run at the preset's learning rates (OneCycle's warmup: about 1e-5 a
step), where that freedom stays inside the tolerance; the moments,
which are not normalized, hold the gradients of every step to 1e-4, and
the optimizer's arithmetic is held at 1e-6 on well-scaled gradients in
`test_torch_port_train_loss.py`."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from leod_tpu.config import experiment_preset as j_experiment_preset
from leod_tpu.models.detector import Detector as JDetector
from leod_tpu.train import step as jstep
from leod_tpu.train.optim import make_optimizer as j_make_optimizer

from leod_tpu_torch.config import experiment_preset
from leod_tpu_torch.convert import _leaves, _target, load_jax_variables
from leod_tpu_torch.models.detector import Detector
from leod_tpu_torch.train.optim import make_optimizer
from leod_tpu_torch.train.step import TrainState, make_train_step

from test_torch_port_serve import _randomize, _tiny

L, B, M, G = 3, 2, 2, 6
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores, and torch's
    thread pool in each would oversubscribe them: these many small ops
    then run tens of times slower. They run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_cfg(cfg):
    """The Gen1 preset's training config (lr 2e-4, OneCycle over 400k
    steps, clip 1.0 by value), with weight decay on."""
    return replace(cfg, training=replace(cfg.training, weight_decay=0.05))


@pytest.fixture(scope="module")
def models():
    jcfg = _train_cfg(_tiny(j_experiment_preset))
    tcfg = _train_cfg(_tiny(experiment_preset))
    jdet = JDetector(jcfg.model, dtype=jnp.float32)
    init = jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(0)))
    v = _randomize(init, np.random.default_rng(0))
    # O(1) LayerScale and non-trivial BN statistics, but the prediction
    # layers as initialized: scaled-up logits would make the loss after
    # a step hang on rounding-level parameter differences
    v["params"]["head"] = init["params"]["head"]
    v["batch_stats"]["head"] = init["batch_stats"]["head"]
    return jcfg, tcfg, jdet, v


def _trainable(tcfg, v):
    det = Detector(tcfg.model, dtype=torch.float32, device="cpu",
                   trainable=True)
    load_jax_variables(det, v)
    return det


def _batches(cfg, n, seed=1):
    """n batches of a prefolded uint8 window, boxes on every frame kept,
    padded frame slots, and rows that start a sequence or continue."""
    rng = np.random.default_rng(seed)
    h, w = cfg.model.backbone.in_res_hw
    c = cfg.model.backbone.input_channels
    firsts = ([True, True], [False, True], [False, False])
    out = []
    for i in range(n):
        ev = np.minimum(rng.poisson(1.5, (L, B, h // 4, w // 4, 16 * c)),
                        255).astype(np.uint8)
        labels = np.zeros((B, M, G, 7), np.float32)
        for b in range(B):
            for m in range(M):
                for g in range(int(rng.integers(1, G))):
                    bw, bh = rng.uniform(10, 40, 2)
                    labels[b, m, g] = [rng.integers(0, 2),
                                       rng.uniform(bw / 2, w - bw / 2),
                                       rng.uniform(bh / 2, h - bh / 2),
                                       bw, bh, 1.0, 1.0]
        frame_mask = np.array([[True, True], [True, i % 2 == 0]])
        labels[~frame_mask] = 0.0
        out.append(dict(ev=ev, is_first=np.array(firsts[i % 3]),
                        frame_t=np.array([[0, 2], [1, 2]], np.int32),
                        frame_mask=frame_mask, labels=labels))
    return out


def _capture_grads():
    """An optax transformation whose state after an update is the
    gradients themselves, exactly, and whose update is zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _j_state(jdet, v, tx):
    return jstep.TrainState(variables=jax.tree.map(jnp.asarray, v),
                            opt_state=tx.init(jax.tree.map(jnp.asarray,
                                                           v["params"])),
                            states=jdet.init_states(B),
                            step=jnp.zeros((), jnp.int32))


def _each_tensor(det, tree, coll, port_value):
    """(path, JAX value in the port's layout, the port's value) for every
    leaf of the JAX tree `tree` of collection `coll`."""
    for path, arr in _leaves(tree):
        module = det.get_submodule(".".join(path[:-1]))
        name, want = _target(module, path[-1], arr)
        yield "/".join((coll,) + path), want, port_value(getattr(module,
                                                                 name))


def _close(got, want, what, floor=1e-30):
    """Within TOL of the tensor's largest magnitude, or of `floor` where
    that is larger (1.0: TOL absolute for values of order one or less)."""
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def test_first_step_loss_and_grads_match_jax(models):
    jcfg, tcfg, jdet, v = models
    batch = _batches(tcfg, 1)[0]
    tx = _capture_grads()
    jst, jm = jax.jit(jstep.make_train_step(jdet, tx))(
        _j_state(jdet, v, tx), {k: jnp.asarray(x) for k, x in batch.items()})
    det = _trainable(tcfg, v)
    # no clip, so that the gradients the step leaves are the unclipped
    # ones JAX's transformation captured (clipping is in place)
    opt, _ = make_optimizer(replace(tcfg.training, gradient_clip_val=0.0),
                            det.parameters())
    step = make_train_step(det, opt, remat="full")
    _, tm = step(TrainState(states=det.init_states(B), step=0), batch)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    assert float(jm["num_fg"]) > 0
    n = 0
    for path, want, got in _each_tensor(
            det, jax.tree.map(np.asarray, jst.opt_state), "grad",
            lambda t: t.grad.numpy()):
        _close(got, want, path)
        n += 1
    assert n == len(list(det.parameters()))


def test_three_adamw_steps_match_jax(models):
    """Params, BN running statistics (flax's biased variance, padded
    frames in the batch statistics) and carried states after three
    steps of clip + AdamW at the OneCycle schedule, from three batches
    with resets and padded frame slots."""
    jcfg, tcfg, jdet, v = models
    batches = _batches(tcfg, 3, seed=2)
    tx, _ = j_make_optimizer(jcfg.training)
    jfn = jax.jit(jstep.make_train_step(jdet, tx))
    jst = _j_state(jdet, v, tx)
    det = _trainable(tcfg, v)
    opt, _ = make_optimizer(tcfg.training, det.parameters())
    step = make_train_step(det, opt, remat="full")
    tst = TrainState(states=det.init_states(B), step=0)
    for batch in batches:
        jst, jm = jfn(jst, {k: jnp.asarray(x) for k, x in batch.items()})
        tst, tm = step(tst, batch)
        for k in ("loss", "iou_loss", "conf_loss", "cls_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                       err_msg=k)
    assert tst.step == 3 and opt.count == 3
    adam = [x for x in jax.tree_util.tree_leaves(
        jst.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    assert len(adam) == 1
    for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = jax.tree.map(np.asarray, getattr(adam[0], key))
        for path, want, got in _each_tensor(
                det, tree, key,
                lambda t: opt.adamw.state[t][moment].numpy()):
            _close(got, want, path)
    var = jax.tree.map(np.asarray, jst.variables)
    moved = 0
    for coll in ("params", "batch_stats"):
        for path, want, got in _each_tensor(det, var[coll], coll,
                                            lambda t: t.detach().numpy()):
            _close(got, want, path, floor=1.0)
            moved += coll == "batch_stats" and not np.array_equal(
                want, np.asarray(_leaf(v[coll], path)))
    assert moved > 0                       # the statistics did move
    for k, ((th, tc), (jh, jc)) in enumerate(zip(tst.states, jst.states)):
        _close(th.numpy(), np.asarray(jh), f"h{k}", floor=1.0)
        _close(tc.numpy(), np.asarray(jc), f"c{k}", floor=1.0)


def _leaf(tree, path):
    for key in path.split("/")[1:]:
        tree = tree[key]
    return tree


@pytest.fixture(scope="module")
def full_remat_step(models):
    """The loss and gradients of one step under remat "full", and its
    batch."""
    _, tcfg, _, v = models
    batch = _batches(tcfg, 1, seed=3)[0]
    det = _trainable(tcfg, v)
    opt, _ = make_optimizer(tcfg.training, det.parameters())
    _, m = make_train_step(det, opt, remat="full")(
        TrainState(states=det.init_states(B), step=0), batch)
    return batch, float(m["loss"]), [p.grad.clone() for p in det.parameters()]


@pytest.mark.parametrize("remat", ["full", "dots", "stage1", "none"])
def test_remat_full_and_none_give_the_same_step(models, full_remat_step,
                                                remat):
    """Every remat policy gives the step of "full": the loss within 1e-6
    relative, every gradient within rtol 1e-5; the states leave the step
    detached."""
    _, tcfg, _, v = models
    batch, loss, grads = full_remat_step
    det = _trainable(tcfg, v)
    opt, _ = make_optimizer(tcfg.training, det.parameters())
    st, m = make_train_step(det, opt, remat=remat)(
        TrainState(states=det.init_states(B), step=0), batch)
    assert not any(t.requires_grad for s in st.states for t in s)
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-6)
    for a, b in zip([p.grad for p in det.parameters()], grads):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()) + 1e-30)


def test_reset_row_with_poisoned_state_trains_finite(models):
    """A NaN left in a slot's carried state is cleared when the slot
    starts a new sequence (reset by selection), and the other row's
    carried state goes on into the step."""
    _, tcfg, _, v = models
    batch = dict(_batches(tcfg, 1, seed=4)[0], is_first=np.array([True,
                                                                  False]))
    det = _trainable(tcfg, v)
    opt, _ = make_optimizer(tcfg.training, det.parameters())
    states = tuple((h.clone(), c.clone()) for h, c in det.init_states(B))
    for h, c in states:
        h[0] = float("nan")
        c[1] = 0.5
    st, m = make_train_step(det, opt)(TrainState(states=states, step=0),
                                      batch)
    assert all(np.isfinite(float(x)) for x in m.values())
    assert all(torch.isfinite(p).all() for p in det.parameters())
    assert all(torch.isfinite(t).all() for s in st.states for t in s)
