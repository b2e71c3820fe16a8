"""The TBPTT remat policies of the port's train step ("full", "dots",
"stage1", "none"; `train/step.py` `_scan_backbone`) against the JAX
package's, on the CPU in float32 at RVT-T widths and the shapes of the
JAX package's own remat test (`tests/test_train.py`: 64 x 96 input, a
(2, 3) partition, one block a stage, B 2, L 3, M 2):

- each policy's first step against `leod_tpu`'s with the same policy
  (its `_scan_backbone` under the policy, then `make_train_step`'s loss
  from the features on, differentiated through both), from one set of
  weights (`load_jax_variables`) and one batch: the loss and its
  components within 1e-4, every gradient within 1e-4 of its tensor's
  largest;
- "dots" keeps as many products in a timestep as the jaxpr of
  `leod_tpu`'s one-timestep `forward_backbone` has `dot_general`s
  without batch dimensions (the ones `dots_with_no_batch_dims_saveable`
  keeps), and the bytes a checkpointed timestep keeps for the backward
  rank full < dots < none and full < stage1 < none;
- "stage1" under token masking or with stage 1 prebatched keeps what
  "full" keeps (the JAX package falls back to "full" there);
- `forward_stage1_pre` then `forward_from_stage1` is bit-equal to
  `forward_backbone_modules`, both within 1e-5 of `leod_tpu`'s
  `forward_backbone`; the prebatched scan within 1e-5 of the per-step
  scan and of `leod_tpu`'s prebatched scan, and the prebatched step
  gives the per-step step's loss and gradients;
- an unknown policy raises ValueError, in `Trainer.fit` before it
  builds its loaders."""
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax
import jax.numpy as jnp
import optax

from leod_tpu import config as jc
from leod_tpu.models.detector import Detector as JDetector
from leod_tpu.train import step as jstep

from leod_tpu_torch import config as tc
from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.models.detector import Detector
from leod_tpu_torch.train import step as tstep
from leod_tpu_torch.train.optim import make_optimizer
from leod_tpu_torch.train.trainer import Trainer

from test_torch_port_serve import _randomize
from test_torch_port_train_step import TOL, _close, _each_tensor

L, B, M, G = 3, 2, 2, 8
HW = (64, 96)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_models.py's prebatch test


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores; torch's
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(mod, **backbone):
    return mod.ModelConfig(
        backbone=mod.BackboneConfig(embed_dim=32, in_res_hw=HW,
                                    partition_size=(2, 3), **backbone),
        head=mod.HeadConfig(num_classes=2, max_gt=G))


@pytest.fixture(scope="module")
def setup():
    """The JAX detector and its variables (O(1) LayerScale, the
    prediction layers as initialized), and the batch of the JAX
    package's remat test."""
    jdet = JDetector(_model(jc), dtype=jnp.float32)
    init = jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(0)))
    v = _randomize(init, np.random.default_rng(0))
    v["params"]["head"] = init["params"]["head"]
    v["batch_stats"]["head"] = init["batch_stats"]["head"]
    rng = np.random.default_rng(0)
    labels = np.zeros((B, M, G, 7), np.float32)
    labels[:, :, 0] = [0, 40, 30, 24, 20, 1, 1]
    batch = dict(ev=rng.integers(0, 50, (L, B) + HW + (20,)).astype(np.uint8),
                 is_first=np.zeros(B, bool),
                 frame_t=np.tile([L - 2, L - 1], (B, 1)).astype(np.int32),
                 frame_mask=np.ones((B, M), bool), labels=labels)
    return jdet, v, batch


def _trainable(v, **backbone):
    det = Detector(_model(tc, **backbone), dtype=torch.float32, device="cpu",
                   trainable=True)
    if v is not None:
        load_jax_variables(det, v)
    return det


@pytest.fixture(scope="module")
def jax_head(setup):
    """The half of JAX's train step after the backbone, which no remat
    policy touches, compiled once: `make_train_step`'s loss_fn from the
    features on (gather, `forward_detect(train=True)`, `loss`), its loss
    and components, and its gradients with respect to the parameters
    (the FPN's and the head's) and to the features, which the backbone's
    VJP under each policy then takes back to the backbone's parameters."""
    jdet, v, batch = setup
    jv = jax.tree.map(jnp.asarray, v)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    states0 = jdet.init_states(B, jnp.float32)
    feats = jax.jit(lambda p: jstep._scan_backbone(
        jdet, {"params": p}, states0, jb["ev"])[1])(jv["params"])

    def head_loss(params, feats):
        var = {"params": params, "batch_stats": jv["batch_stats"]}
        out, _ = jdet.forward_detect(
            var, jstep._gather_frames(feats, jb["frame_t"]), train=True)
        labels = jb["labels"].reshape((-1,) + jb["labels"].shape[2:])
        losses = jdet.loss(out, labels, jb["frame_mask"].reshape(-1))
        return losses["loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(
        head_loss, argnums=(0, 1), has_aux=True))(jv["params"], feats)
    return jv, jb, states0, losses, grads


@pytest.mark.parametrize("remat", tstep.REMAT_POLICIES)
def test_step_matches_jax_with_the_same_policy(setup, jax_head, remat):
    """JAX's step under `remat`: its backbone scan (`_scan_backbone`, where
    the policy acts) differentiated by `jax.vjp` against the features'
    cotangent of `jax_head`, its parameters' gradients summed with the
    FPN's and the head's: `jax.grad` of `make_train_step`'s loss_fn with
    the jit split at the features, so that only the policy's part
    compiles anew for each policy. The port's `make_train_step(remat=)`
    against it: every metric at 1e-4 relative, every gradient at 1e-4
    of its tensor's largest."""
    jdet, v, batch = setup
    jv, jb, states0, losses, (g_params, g_feats) = jax_head

    @jax.jit
    def step_grads(params, g_params, ct):
        _, vjp = jax.vjp(lambda p: jstep._scan_backbone(
            jdet, {"params": p}, states0, jb["ev"], remat=remat)[1], params)
        grads = jax.tree.map(jnp.add, g_params, vjp(ct)[0])
        norms = {f"grad_norm/{mod}": optax.global_norm(grads[mod])
                 for mod in ("backbone", "fpn", "head")}
        return grads, dict(norms, grad_norm=optax.global_norm(grads))

    grads, norms = step_grads(jv["params"], g_params, g_feats)
    jm = dict(losses, **norms)

    det = _trainable(v)
    # no clip: the gradients the step leaves are the unclipped ones
    opt, _ = make_optimizer(tc.TrainingConfig(learning_rate=1e-4,
                                              gradient_clip_val=0.0),
                            det.parameters())
    _, tm = tstep.make_train_step(det, opt, remat=remat)(
        tstep.TrainState(states=det.init_states(B), step=0), batch)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    assert float(jm["num_fg"]) > 0
    assert float(jm["grad_norm/backbone"]) > 0
    n = 0
    for path, want, got in _each_tensor(
            det, jax.tree.map(np.asarray, grads), "grad",
            lambda t: t.grad.numpy()):
        _close(got, want, path)
        n += 1
    assert n == len(list(det.parameters()))


@pytest.mark.parametrize("remat", ["full", "stage1"])
def test_prebatched_step_is_the_step(setup, remat):
    """`make_train_step(prebatch_stage1=True)`: stage 1's pre over the
    whole window first ("stage1" then runs as "full"), the same loss
    within 1e-6 relative and every gradient within rtol 1e-5 of the
    per-step "full" step."""
    _, v, batch = setup
    out = []
    for pre in (False, True):
        det = _trainable(v)
        opt, _ = make_optimizer(tc.TrainingConfig(), det.parameters())
        _, m = tstep.make_train_step(det, opt, remat="full" if not pre
                                     else remat, prebatch_stage1=pre)(
            tstep.TrainState(states=det.init_states(B), step=0), batch)
        out.append((float(m["loss"]), [p.grad for p in det.parameters()]))
    (loss, grads), (loss_pre, grads_pre) = out
    assert loss_pre == pytest.approx(loss, rel=1e-6)
    for a, b in zip(grads_pre, grads):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()) + 1e-30)


def test_unknown_policy_raises(setup):
    det = _trainable(None)
    opt, _ = make_optimizer(tc.TrainingConfig(), det.parameters())
    with pytest.raises(ValueError, match="remat='offload'"):
        tstep.make_train_step(det, opt, remat="offload")
    ev = torch.from_numpy(setup[2]["ev"])
    with pytest.raises(ValueError, match="remat='offload'"):
        tstep._scan_backbone(det, det.init_states(B), ev, remat="offload")


def test_fit_refuses_an_unknown_policy_before_loading(tmp_path, monkeypatch):
    cfg = tc.ExperimentConfig(
        model=_model(tc), save_dir=str(tmp_path),
        training=tc.TrainingConfig(remat="offload"))
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu")

    def no_loader(*args, **kwargs):
        raise AssertionError("fit built its loaders")

    monkeypatch.setattr(trainer, "make_train_loader", no_loader)
    with pytest.raises(ValueError, match="remat='offload'"):
        trainer.fit(max_steps=1)
    trainer.close()


# ---------------------------------------------------------------------------
# What each policy keeps for the backward
# ---------------------------------------------------------------------------

class _Kept(TorchDispatchMode):
    """Records the storage of every tensor an op makes; `nbytes` sums
    those still alive, apart from the given tensors' (the outputs, the
    parameters, the inputs): what the autograd graph and the checkpoints
    keep for the backward."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.made.setdefault(s._cdata, (StorageWeakRef(s),
                                                s.nbytes()))
        return out

    def nbytes(self, exclude) -> int:
        ex = {t.untyped_storage()._cdata for t in exclude}
        return sum(n for k, (ref, n) in self.made.items()
                   if not ref.expired() and k not in ex)


def _kept(det, ev, remat, prebatch_stage1=False):
    """Bytes kept for the backward by `_scan_backbone` over ev."""
    states0 = det.init_states(ev.shape[1])
    mode = _Kept()
    with mode:
        states, feats = tstep._scan_backbone(det, states0, ev,
                                             prebatch_stage1, remat)
    return mode.nbytes(list(det.parameters()) + [ev] + tree_leaves(states0)
                       + tree_leaves(states) + list(feats.values()))


def _dots_without_batch_dims(jaxpr) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, _), (lhs_batch, _) = eqn.params["dimension_numbers"]
            n += not lhs_batch
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    n += _dots_without_batch_dims(sub)
    return n


def test_dots_keeps_the_products_jax_keeps(setup, monkeypatch):
    """One timestep: the products "dots" keeps, counted where its policy
    says MUST_SAVE, against the jaxpr's `dot_general`s without batch
    dimensions (4 stages x (2 blocks x 4 Dense + the ConvLSTM's 2 split
    products) = 40); then the bytes each policy keeps."""
    jdet, v, batch = setup
    x = jnp.asarray(batch["ev"][0])
    jaxpr = jax.make_jaxpr(lambda v, x, s: jdet.forward_backbone(v, x, s))(
        jax.tree.map(jnp.asarray, v), x, jdet.init_states(B, jnp.float32))
    want = _dots_without_batch_dims(jaxpr.jaxpr)
    assert want == 40

    saved = []
    policy = tstep._dots_policy

    def counting(ctx, op, *args, **kwargs):
        p = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and p == tstep.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return p

    monkeypatch.setattr(tstep, "_dots_policy", counting)
    det = _trainable(v)
    ev = torch.from_numpy(batch["ev"][:1])
    kept = {r: _kept(det, ev, r) for r in tstep.REMAT_POLICIES}
    assert len(saved) == want
    assert kept["full"] < kept["dots"] < kept["none"], kept
    assert kept["full"] < kept["stage1"] < kept["none"], kept


def test_stage1_falls_back_to_full(setup):
    """"stage1" under token masking or with stage 1 prebatched has no
    stage-1 checkpoint boundary: it keeps what "full" keeps."""
    _, _, batch = setup
    ev = torch.from_numpy(batch["ev"])
    masked = _trainable(None, enable_masking=True)
    assert masked.backbone.stage1.mask_token is not None
    assert _kept(masked, ev, "stage1") == _kept(masked, ev, "full")
    det = _trainable(None)
    assert _kept(det, ev, "stage1", prebatch_stage1=True) == \
        _kept(det, ev, "full", prebatch_stage1=True)
    # without either, "stage1" keeps stages 2-4
    assert _kept(det, ev, "stage1") > _kept(det, ev, "full")


# ---------------------------------------------------------------------------
# The stage-1 split and the prebatched scan
# ---------------------------------------------------------------------------

def _warm_states(jdet, seed):
    rng = np.random.default_rng(seed)
    return tuple(tuple(rng.normal(0, 0.5, np.shape(t)).astype(np.float32)
                       for t in st)
                 for st in jdet.init_states(B, jnp.float32))


def test_stage1_split_is_the_timestep(setup):
    jdet, v, batch = setup
    det = _trainable(v)
    states = _warm_states(jdet, 1)
    t_states = tuple((torch.from_numpy(h), torch.from_numpy(c))
                     for h, c in states)
    x = torch.from_numpy(batch["ev"][1])
    with torch.no_grad():
        feats, new = det.forward_backbone_modules(x, t_states)
        s_feats, s_new = det.forward_from_stage1(det.forward_stage1_pre(x),
                                                 t_states)
    assert sorted(feats) == sorted(s_feats) == [1, 2, 3, 4]
    for k in feats:
        assert torch.equal(feats[k], s_feats[k]), k
    for a, b in zip(tree_leaves(new), tree_leaves(s_new)):
        assert torch.equal(a, b)
    j_feats, j_new = jax.jit(jdet.forward_backbone)(
        jax.tree.map(jnp.asarray, v), jnp.asarray(batch["ev"][1]),
        jax.tree.map(jnp.asarray, states))
    for k in feats:
        np.testing.assert_allclose(feats[k].numpy(), np.asarray(j_feats[k]),
                                   **SCAN_TOL, err_msg=f"stage {k}")
    for a, b in zip(tree_leaves(new), jax.tree.leaves(j_new)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SCAN_TOL)


def test_prebatched_scan_matches(setup):
    jdet, v, batch = setup
    det = _trainable(v)
    states = _warm_states(jdet, 2)
    t_states = tuple((torch.from_numpy(h), torch.from_numpy(c))
                     for h, c in states)
    ev = torch.from_numpy(batch["ev"])
    with torch.no_grad():
        s_pre, f_pre = tstep._scan_backbone(det, t_states, ev,
                                            prebatch_stage1=True)
        s_seq, f_seq = tstep._scan_backbone(det, t_states, ev)
    s_jax, f_jax = jax.jit(lambda v, e, s: jstep._scan_backbone(
        jdet, v, s, e, prebatch_stage1=True))(
        jax.tree.map(jnp.asarray, v), jnp.asarray(batch["ev"]),
        jax.tree.map(jnp.asarray, states))
    assert sorted(f_pre) == sorted(f_seq) == sorted(f_jax) == [2, 3, 4]
    for k in f_pre:
        assert f_pre[k].shape == (L, B) + f_pre[k].shape[2:]
        np.testing.assert_allclose(f_pre[k].numpy(), f_seq[k].numpy(),
                                   **SCAN_TOL, err_msg=f"stage {k}")
        np.testing.assert_allclose(f_pre[k].numpy(), np.asarray(f_jax[k]),
                                   **SCAN_TOL, err_msg=f"stage {k}")
    for a, b, c in zip(tree_leaves(s_pre), tree_leaves(s_seq),
                       jax.tree.leaves(s_jax)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SCAN_TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **SCAN_TOL)
