"""The port's space mesh axis (`leod_tpu_torch/parallel/space.py`, the
height of every map sharded over ranks) against the unsharded port and
the JAX package's (data, space) mesh, on the CPU.

Ranks run this file as a script: they import torch and the port only,
keep one thread each, and join one gloo process group through a file.
Two launches, each run once per session under a file lock (across the
suite's worker processes too, as `tests/test_torch_port_parallel.py`
launches its ranks), each check then its own test:

- mesh (1, 2), two ranks and a one-process reference: every convolution
  of the model through `space_conv2d` (forward, input and weight
  gradients), the grid exchange, the block halves on the aligned and
  the gather path, a 2-step `fit`, a stop asked on one rank with the
  checkpoint timer due on that rank alone, a streaming eval, TTA eval (whose
  process shards are then space ranks), the first step of every remat
  policy, a Gen4-flavour step, and `cli.train --mesh 1x2`; the pytest
  process runs the JAX package's streaming eval on `make_mesh(4,
  space=2)` meanwhile;
- mesh (2, 2), four ranks: the BN statistics over data x space, a
  3-step `fit` (its steps against the JAX package's `Trainer.fit` on
  `make_mesh(4, space=2)`, which the pytest process runs meanwhile),
  and `cli.train --mesh 2x2`.

The configuration is `tests/mp_worker.py`'s (embed 32, 64 x 96,
partition 2 x 3, L 4, global B 8 of stream slots), whose stage maps of
16, 8, 4 and 2 rows put stages 1-3 on the aligned path (8, 4 and 2 rows
a rank) and stage 4 (1 row a rank) on the gather path at space 2.
"""
import dataclasses
import fcntl
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path[:0] = [TESTS]

from test_torch_port_parallel import (B, SPLIT, _bn_run, _digest,  # noqa: E402
                                      _records, build_cfg, ssod_cfg)

STEPS12, STEPS22 = 2, 3
KEYS = ("loss", "grad_norm", "grad_norm/backbone", "grad_norm/fpn",
        "grad_norm/head", "num_fg")
POLICIES = ("full", "dots", "stage1", "none")
RANK_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 90
# the BN case: the frames of the two data shards, [C, H, W] a frame
BN_FRAMES = (2, 4)
BN_SHAPE = (5, 4, 4)
GEN4_SPLIT = dict(num_train=2, num_val=0, num_test=0, num_reprs=24,
                  hw=(96, 128), ds2=True, num_classes=3, label_every=2,
                  first_label_repr=11)
TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=2e-4, atol=1e-5)


def gen4_cfg(cm, root, runs):
    """`test_spatial_mesh_gen4_flavor`'s configuration, in the config
    module `cm` of either package."""
    dst = dataclasses.replace(
        cm.dataset_preset("gen4"), path=root, resolution_hw=(96, 128),
        sequence_length=4, train_sampling="stream")
    model = cm.ModelConfig(
        backbone=cm.BackboneConfig(embed_dim=32, in_res_hw=(64, 64),
                                   partition_size=(2, 2)),
        head=cm.HeadConfig(num_classes=3, max_gt=8))
    training = cm.TrainingConfig(max_steps=1, batch_size_train=4,
                                 batch_size_eval=4, val_check_interval=0,
                                 max_det_frames=2, learning_rate=1e-4,
                                 viz_every_steps=0)
    return cm.ExperimentConfig(dataset=dst, model=model, training=training,
                               save_dir=runs, exp_name="sp4")


def _bn_data():
    """(y [6, C, H, W], output gradient, BN module), seeded."""
    from torch import nn
    g = torch.Generator().manual_seed(1)
    n = sum(BN_FRAMES)
    y = torch.randn((n,) + BN_SHAPE, generator=g) + 2.0
    gout = torch.randn((n,) + BN_SHAPE, generator=g)
    bn = nn.BatchNorm2d(BN_SHAPE[0])
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
        bn.running_mean.uniform_(-1.0, 1.0, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    return y, gout, bn


def _bn_rows(d: int, s: int, k: int = 2):
    """(frames, rows) of rank (d, s) in the BN case."""
    lo = sum(BN_FRAMES[:d])
    h = BN_SHAPE[1] // k
    return slice(lo, lo + BN_FRAMES[d]), slice(s * h, (s + 1) * h)


# ---------------------------------------------------------------------------
# The ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _join(rank: int, world: int, init_file: str):
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from leod_tpu_torch.parallel import distributed as pdist
    pdist.maybe_initialize(f"file://{init_file}", num_processes=world,
                           process_id=rank, backend="gloo",
                           timeout_s=GROUP_TIMEOUT_S)


def _spy(T, steps: list, hooks: list = ()) -> None:
    """Every train step `train.trainer` makes records its metrics and
    the parameters' digest after it, then calls each of `hooks` with the
    number of steps recorded."""
    real = T.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def run(state, batch):
            state, m = step(state, batch)
            steps.append({**{key: float(m[key]) for key in KEYS},
                          "digest": _digest(a[0])})
            for hook in hooks:
                hook(len(steps))
            return state, m
        return run
    T.make_train_step = make


def _fit(T, cfg, mesh, variables, steps: list) -> dict:
    """`Trainer.fit` from `variables` (a JAX tree), or from the port's
    seed 0 where None."""
    from leod_tpu_torch.convert import load_jax_variables
    del steps[:]
    tr = T.Trainer(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
    st = tr.init_state(cfg.training.batch_size_train)
    if variables is not None:
        load_jax_variables(tr.det, variables)
    st = tr.fit(max_steps=cfg.training.max_steps, state=st, log_every=1)
    tr.close()
    finite = all(bool(torch.isfinite(p).all()) for p in tr.det.parameters())
    return {"step": st.step, "steps": list(steps), "finite": finite,
            "state_shapes": [list(h.shape) for h, _ in st.states]}


def _ssod(T, tc, root, runs, mesh, variables, steps: list) -> dict:
    """Online SSOD (`test_torch_port_parallel.py`'s configuration, 3
    steps) from `variables`: the steps, the teacher's state rows and
    heights, and the pseudo boxes merged a batch."""
    from leod_tpu_torch.convert import load_jax_variables
    del steps[:]
    tr = T.Trainer(ssod_cfg(tc, root, runs), dtype=torch.float32,
                   device="cpu", mesh=mesh)
    st = tr.init_state(B)
    load_jax_variables(tr.det, variables)
    st = tr.fit(max_steps=3, state=st, log_every=1)
    tr.close()
    return {"step": st.step, "steps": list(steps),
            "teacher_state": list(tr.ssod_batcher.states[0][0].shape),
            "merged": list(tr.ssod_batcher.merged)}


def _stop(T, tc, root, runs, mesh, variables, steps: list, hooks: list,
          rank: int) -> dict:
    """A fit of up to 50 steps, the stop and the checkpoint timer
    exchanged every step: rank 1 alone asks to stop after its second
    step, and its own clock (ckpt_every_min 0) says a checkpoint is due
    after every step, rank 0's never. The step it ended at, the run
    dir's files and the steps at which this rank saved a checkpoint."""
    from leod_tpu_torch.convert import load_jax_variables
    del steps[:]
    cfg = build_cfg(tc, root, runs, exp="stop", max_steps=50,
                    multihost_sync_every=1,
                    ckpt_every_min=0.0 if rank == 1 else 1e9)
    tr = T.Trainer(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
    st = tr.init_state(B)
    load_jax_variables(tr.det, variables)
    saves, real = [], tr.save_checkpoint

    def save(state, name="last"):
        saves.append(int(state.step))
        real(state, name)
    tr.save_checkpoint = save
    if rank == 1:
        hooks.append(lambda n: tr.request_stop() if n == 2 else None)
    try:
        st = tr.fit(max_steps=50, state=st, log_every=1)
    finally:
        del hooks[:]
        tr.close()
    return {"step": st.step, "files": sorted(os.listdir(tr.run_dir)),
            "run_dir": tr.run_dir, "saves": saves}


def _cli_mesh(mesh_flag: str, root: str) -> list:
    """`cli.train --mesh` up to the Trainer it builds: (data, space) of
    the mesh handed to it."""
    from leod_tpu_torch.cli import train as cli_train

    class Built(Exception):
        pass

    seen = []

    class Stub:
        def __init__(self, cfg, dtype=None, device=None, mesh=None):
            seen.append([mesh.size, mesh.space])
            raise Built

    real, cli_train.Trainer = cli_train.Trainer, Stub
    try:
        cli_train.main(["--mesh", mesh_flag, "--cpu", "--fp32", "--path",
                        root, "--size", "tiny"])
    except Built:
        pass
    finally:
        cli_train.Trainer = real
    return seen


def _conv_cases(det, cfg):
    """Every convolution of the model and its input shape in one
    unsharded train-mode timestep at B 2 (forward pre-hooks on the
    modules called as such, and `layers._conv` for those run through
    `space_conv2d`), plus the stem's two other input layouts and the
    ConvLSTM's depthwise conv at stage 3's map."""
    from torch import nn
    from leod_tpu_torch.models import layers
    seen, hooks = {}, []
    names = {id(m): name for name, m in det.named_modules()}

    def record(name):
        def hook(mod, args):
            seen.setdefault((name, tuple(args[0].shape)), mod)
        return hook
    for name, m in det.named_modules():
        if isinstance(m, (nn.Conv2d, layers._S2DStemConv)):
            hooks.append(m.register_forward_pre_hook(record(name)))
    real_conv = layers._conv

    def conv(m, x):
        seen.setdefault((names[id(m)], tuple(x.shape)), m)
        return real_conv(m, x)
    bb = cfg.model.backbone
    h, w = bb.in_res_hw
    c = bb.input_channels
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, h // 4, w // 4, 16 * c, generator=g)
    layers._conv = conv
    try:
        feats, _ = det.forward_backbone_modules(x, det.init_states(2))
        det.forward_detect(feats, train=True)
    finally:
        layers._conv = real_conv
        for hk in hooks:
            hk.remove()
    stem = det.backbone.stage1.down.conv
    cases = [(name, shape, m) for (name, shape), m in seen.items()]
    cases += [("stem_width_fold", (2, h, w // 4, 4 * c), stem),
              ("stem_raw", (2, h, w, c), stem)]
    dws = nn.Conv2d(bb.stage_dims[2], bb.stage_dims[2], 3, padding=1,
                    groups=bb.stage_dims[2])
    with torch.no_grad():                   # the same weights on every rank
        for p in dws.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / 3.0)
    cases.append(("lstm_dws", (2, bb.stage_dims[2], h // 16, w // 16), dws))
    return cases


def _unit_checks(mesh, det, cfg) -> dict:
    """Each collective piece against its unsharded counterpart on this
    rank's rows: arrays for the tests. The convolutions and the block
    halves run in float64: a halo or a route in the wrong place moves
    the result by O(1), while fp32's summation order alone, which the
    shard's other shapes change, moves the stem's 1280-term sums by up to
    3.6e-6."""
    import copy
    import torch.distributed as dist
    from leod_tpu_torch.models.layers import (PartitionAttention, _conv,
                                              _S2DStemConv,
                                              block_pair_tokens,
                                              grid_partition)
    from leod_tpu_torch.ops.maxvit_cuda import fused_block_pair
    from leod_tpu_torch.parallel import space
    from leod_tpu_torch.parallel.mesh import height_slice
    s = mesh.space_index
    out = {"convs": [], "halves": []}

    def run_conv(m, x, nhwc):
        """Unsharded, the module itself (an nn.Conv2d: `F.conv2d` with its
        own padding); in a shard, as the model runs it."""
        if isinstance(m, _S2DStemConv) or space.active() is None:
            return m(x)
        return _conv(m, x)

    f64 = torch.float64
    for i, (name, shape, m) in enumerate(_conv_cases(det, cfg)):
        nhwc = isinstance(m, _S2DStemConv)
        dim = 1 if nhwc else 2
        m = copy.deepcopy(m).to(f64)
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(shape, generator=g, dtype=f64)
        x_full = x.clone().requires_grad_(True)
        m.zero_grad()
        y = run_conv(m, x_full, nhwc)
        gy = torch.randn(y.shape, generator=g, dtype=f64)
        (y * gy).sum().backward()
        gw_full = m.weight.grad.clone()
        m.zero_grad()
        x_loc = height_slice(mesh, x, dim).clone().requires_grad_(True)
        with space.space_shard(mesh):
            y_loc = run_conv(m, x_loc, nhwc)
        (y_loc * height_slice(mesh, gy, dim)).sum().backward()
        gw = m.weight.grad.clone()
        dist.all_reduce(gw, group=mesh.space_group)
        m.zero_grad()
        out["convs"].append({
            "name": name, "shape": list(shape),
            "y": y_loc.detach().numpy(),
            "y_want": height_slice(mesh, y.detach(), dim).numpy(),
            "gx": x_loc.grad.numpy(),
            "gx_want": height_slice(mesh, x_full.grad, dim).numpy(),
            "gw": gw.numpy(), "gw_want": gw_full.numpy()})

    # the grid exchange and its inverse on a map of 16 rows, partition 2
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 16, 6, 8, generator=g)
    grads = [torch.randn(2, 8, 6, 8,
                         generator=torch.Generator().manual_seed(20 + r))
             for r in range(mesh.space)]
    x_loc = height_slice(mesh, x, 1).clone().requires_grad_(True)
    with space.space_shard(mesh):
        y = space.grid_exchange(x_loc, 2)
        back = space.grid_exchange(y, 2, inverse=True)
    (y * grads[s]).sum().backward()
    # rank r holds cell rows [4r, 4r + 4) of both grid rows of 8 cells
    rows = [torch.cat([torch.arange(a * 8 + 4 * r, a * 8 + 4 * r + 4)
                       for a in range(2)]) for r in range(mesh.space)]
    g_full = torch.zeros_like(x)
    for r in range(mesh.space):
        g_full[:, rows[r]] = grads[r]
    out["exchange"] = {
        "y": y.detach().numpy(), "y_want": x[:, rows[s]].numpy(),
        "groups": grid_partition(y.detach(), 2, 3).numpy(),
        "groups_want": grid_partition(x, 2, 3).reshape(
            2, 8, 2, 6, 8)[:, 4 * s:4 * s + 4].reshape(-1, 6, 8).numpy(),
        "back": back.detach().numpy(), "x": x_loc.detach().numpy(),
        "gx": x_loc.grad.numpy(),
        "gx_want": height_slice(mesh, g_full, 1).numpy()}

    # the block halves: modules under autograd and the kernel wrapper,
    # at 16 rows (aligned: local windows, exchanged grid) and at 2 rows
    # (1 a rank: both halves through the gather path)
    torch.manual_seed(0)
    blocks = [PartitionAttention(32, (2, 3), kind, skip_first_norm=False,
                                 ls_init_value=0.5).to(f64)
              for kind in ("window", "grid")]
    for rows_h in (16, 2):
        g = torch.Generator().manual_seed(40 + rows_h)
        x = torch.randn(2, rows_h, 6, 32, generator=g, dtype=f64)
        x_full = x.clone().requires_grad_(True)
        for b in blocks:
            b.zero_grad()
        y = block_pair_tokens(x_full, *blocks, (2, 3))
        gy = torch.randn(y.shape, generator=g, dtype=f64)
        (y * gy).sum().backward()
        gp_want = [p.grad.clone() for b in blocks for p in b.parameters()]
        for b in blocks:
            b.zero_grad()
        x_loc = height_slice(mesh, x, 1).clone().requires_grad_(True)
        space.reset_counts()
        with space.space_shard(mesh):
            y_loc = block_pair_tokens(x_loc, *blocks, (2, 3))
            with torch.no_grad():
                y_kern = fused_block_pair(x_loc.detach(), *blocks, (2, 3),
                                          skip_first_norm=False)
        (y_loc * height_slice(mesh, gy, 1)).sum().backward()
        gp = [p.grad.clone() for b in blocks for p in b.parameters()]
        for t in gp:
            dist.all_reduce(t, group=mesh.space_group)
        with torch.no_grad():
            y_kern_want = fused_block_pair(x, *blocks, (2, 3),
                                           skip_first_norm=False)
        out["halves"].append({
            "rows": rows_h, "counts": dict(space.COUNTS),
            "y": y_loc.detach().numpy(),
            "y_want": height_slice(mesh, y.detach(), 1).numpy(),
            "y_kernel": y_kern.numpy(),
            "y_kernel_want": height_slice(mesh, y_kern_want, 1).numpy(),
            "gx": x_loc.grad.numpy(),
            "gx_want": height_slice(mesh, x_full.grad, 1).numpy(),
            "gp": [t.numpy() for t in gp],
            "gp_want": [t.numpy() for t in gp_want]})
    return out


def _worker12(rank: int, init_file: str, shared: str) -> None:
    """A rank of the (1, 2) mesh."""
    _join(rank, 2, init_file)
    import leod_tpu_torch.train.trainer as T
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.convert import load_jax_variables
    from leod_tpu_torch.eval.tta import run_tta_eval
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.parallel import space
    from leod_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    root = weights["root"]
    mesh = make_mesh(2, space=2)
    runs = os.path.join(shared, "runs12")
    cfg = build_cfg(tc, root, runs, max_steps=STEPS12)
    out = {"mesh": [mesh.size, mesh.space, mesh.data_index,
                    mesh.space_index]}

    det = Detector(cfg.model, dtype=torch.float32, device="cpu",
                   trainable=True)
    load_jax_variables(det, weights["init"])
    out["units"] = _unit_checks(mesh, det, cfg)
    del det

    steps, hooks = [], []
    _spy(T, steps, hooks)
    space.reset_counts()
    out["fit"] = _fit(T, cfg, mesh, weights["init"], steps)
    out["fit"]["counts"] = dict(space.COUNTS)
    out["stop"] = _stop(T, tc, root, os.path.join(shared, f"stop{rank}"),
                        mesh, weights["init"], steps, hooks, rank)
    det = Detector(cfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(det, weights["rand"])
    out["eval"] = {
        "stream": T.run_streaming_eval(det, cfg, "val", device="cpu",
                                       mesh=mesh),
        "tta": run_tta_eval(det, cfg, "val", device="cpu")}
    out["remat"] = {}
    for pol in POLICIES[1:]:
        pcfg = build_cfg(tc, root, runs, exp=f"remat_{pol}", max_steps=1,
                         remat=pol)
        out["remat"][pol] = _fit(T, pcfg, mesh, weights["init"], steps)
    gcfg = gen4_cfg(tc, weights["gen4_root"], runs)
    out["gen4"] = _fit(T, gcfg, mesh, None, steps)
    out["ssod"] = _ssod(T, tc, root, runs, mesh, weights["rand"], steps)
    out["cli"] = _cli_mesh("1x2", root)
    with open(os.path.join(shared, f"rank12_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _worker22(rank: int, init_file: str, shared: str) -> None:
    """A rank of the (2, 2) mesh."""
    _join(rank, 4, init_file)
    import leod_tpu_torch.train.trainer as T
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.parallel import distributed as pdist
    from leod_tpu_torch.parallel import space
    from leod_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    mesh = make_mesh(4, space=2)
    out = {"mesh": [mesh.size, mesh.space, mesh.data_index,
                    mesh.space_index]}
    y, gout, bn = _bn_data()
    frames, rows = _bn_rows(mesh.data_index, mesh.space_index)
    with pdist.global_batch(mesh.data_group), space.space_shard(mesh):
        out["bn"] = _bn_run(y[frames][:, :, rows].contiguous(),
                            gout[frames][:, :, rows].contiguous(), bn)
    steps = []
    _spy(T, steps)
    cfg = build_cfg(tc, weights["root"], os.path.join(shared, "runs22"),
                    max_steps=STEPS22)
    out["fit"] = _fit(T, cfg, mesh, weights["init"], steps)
    out["cli"] = _cli_mesh("2x2", weights["root"])
    with open(os.path.join(shared, f"rank22_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _one_process(shared: str) -> None:
    """The port in one process on the same weights: the (1, 2) mesh's
    references."""
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import leod_tpu_torch.train.trainer as T
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.convert import load_jax_variables
    from leod_tpu_torch.eval.tta import run_tta_eval
    from leod_tpu_torch.models.detector import Detector

    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    root = weights["root"]
    runs = os.path.join(shared, "one")
    cfg = build_cfg(tc, root, runs, max_steps=STEPS12)
    steps = []
    _spy(T, steps)
    out = {"fit": _fit(T, cfg, None, weights["init"], steps)}
    det = Detector(cfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(det, weights["rand"])
    out["eval"] = {"stream": T.run_streaming_eval(det, cfg, "val",
                                                  device="cpu"),
                   "tta": run_tta_eval(det, cfg, "val", device="cpu")}
    out["gen4"] = _fit(T, gen4_cfg(tc, weights["gen4_root"], runs), None,
                       None, steps)
    out["ssod"] = _ssod(T, tc, root, runs, None, weights["rand"], steps)
    with open(os.path.join(shared, "one.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# The fixtures: the ranks, and the JAX references meanwhile
# ---------------------------------------------------------------------------

def _launch(shared: str, argvs, tag: str, jax: bool = False):
    """This file as a script once per argv; the port's processes with one
    thread and without the 8-device XLA flags, a JAX one (`jax`) with the
    pytest process's environment."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    if not jax:
        env.pop("XLA_FLAGS", None)
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(shared, f"{tag}_{i}.log"), "w")
            for i in range(len(argvs))]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)] + a, stdout=f,
        stderr=subprocess.STDOUT, env=env) for a, f in zip(argvs, logs)]
    return procs, logs


def _wait(procs, logs) -> None:
    """A process that fails or outlives RANK_TIMEOUT_S is killed, and so
    are the others, and the fixture fails."""
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for i in bad:
            with open(logs[i].name) as f:
                tails.append(f"{logs[i].name} (rc {procs[i].returncode}):"
                             f"\n" + f.read()[-3000:])
        raise RuntimeError("\n".join(tails))


def _shared_dir(tmp_path_factory) -> str:
    """One directory for the whole session: under pytest-xdist the
    workers' base temp dirs share a parent."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = os.path.join(str(base), "torch_port_space")
    os.makedirs(d, exist_ok=True)
    return d


def _locked(shared: str, name: str, make):
    """`make(shared)`'s result, made once per session under a lock."""
    done = os.path.join(shared, f"{name}.pkl")
    with open(os.path.join(shared, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(done):
            res = make(shared)
            with open(done + ".tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(done + ".tmp", done)
    with open(done, "rb") as f:
        return pickle.load(f)


def _base(shared: str) -> dict:
    """The splits and the seeded weights both launches start from: the
    JAX `Trainer`'s init, and a randomized copy for eval (the
    Gen4-flavour runs start from the port's seed 0)."""
    import jax
    import jax.numpy as jnp
    from leod_tpu import config as jc
    from leod_tpu.data.synthetic import generate_dataset
    from leod_tpu.train.trainer import Trainer as JTrainer
    from test_torch_port_serve import _randomize

    root = generate_dataset(os.path.join(shared, "synth"), **SPLIT)
    gen4_root = generate_dataset(os.path.join(shared, "synth_gen4"),
                                 **GEN4_SPLIT)
    jtr = JTrainer(build_cfg(jc, root, os.path.join(shared, "jax")),
                   dtype=jnp.float32)
    init = jax.tree.map(np.asarray, jtr.init_state(B).variables)
    jtr.close()
    weights = {"root": root, "gen4_root": gen4_root, "init": init,
               "rand": _randomize(init, np.random.default_rng(0))}
    with open(os.path.join(shared, "weights.pkl"), "wb") as f:
        pickle.dump(weights, f)
    # the JAX space-mesh step's compile is the longest part: it runs
    # beside both launches, and `_run22` reads its result
    _, logs = _launch(shared, [["jax_space", shared]], "jax22", jax=True)
    logs[0].close()
    return {"root": root}


def _run12(shared: str) -> dict:
    import jax.numpy as jnp
    from leod_tpu import config as jc
    from leod_tpu.models.detector import Detector as JDetector
    from leod_tpu.parallel.mesh import make_mesh as j_make_mesh
    from leod_tpu.train.trainer import run_streaming_eval as j_eval

    init_file = os.path.join(shared, "group12")
    argvs = [["sp12", str(r), init_file, shared] for r in range(2)] + \
        [["one", shared]]
    procs, logs = _launch(shared, argvs, "sp12")
    try:
        with open(os.path.join(shared, "weights.pkl"), "rb") as f:
            weights = pickle.load(f)
        jcfg = build_cfg(jc, weights["root"], os.path.join(shared, "jax"))
        jdet = JDetector(jcfg.model, dtype=jnp.float32)
        jax_eval = j_eval(jdet, weights["rand"], jcfg, "val",
                          mesh=j_make_mesh(4, space=2))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    _wait(procs, logs)
    ranks = []
    for r in range(2):
        with open(os.path.join(shared, f"rank12_{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    with open(os.path.join(shared, "one.pkl"), "rb") as f:
        one = pickle.load(f)
    return {"ranks": ranks, "one": one, "jax_eval": jax_eval}


def _jax_fit(shared: str, name: str, space: int, steps: int) -> list:
    """The JAX package's `Trainer.fit` from the shared weights, on one
    device (space 0) or on `make_mesh(4, space=space)`: its step
    records."""
    import jax.numpy as jnp
    from leod_tpu import config as jc
    from leod_tpu.parallel.mesh import make_mesh as j_make_mesh
    from leod_tpu.parallel.mesh import shard_params
    from leod_tpu.train.trainer import Trainer as JTrainer

    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    mesh = j_make_mesh(4, space=space) if space else None
    jtr = JTrainer(build_cfg(jc, weights["root"],
                             os.path.join(shared, f"jax22_{name}"),
                             max_steps=steps),
                   dtype=jnp.float32, mesh=mesh)
    jstate = jtr.init_state(B)
    variables = weights["init"]
    if mesh is not None:
        variables = shard_params(mesh, variables)
    jtr.fit(max_steps=steps, log_every=1,
            state=jstate._replace(variables=variables))
    jtr.close()
    return [r for r in _records(jtr.run_dir) if "loss" in r]


def _jax_space(shared: str) -> None:
    """(As a script.) The JAX package's first step on `make_mesh(4,
    space=2)` of the 8 CPU devices `tests/conftest.py` forces."""
    sys.path[:0] = [TESTS, REPO]
    import conftest  # noqa: F401  the 8 CPU devices, the compile cache
    try:
        steps = _jax_fit(shared, "space", 2, 1)
    except BaseException as e:
        with open(os.path.join(shared, "jax_space.err"), "w") as f:
            f.write(repr(e))
        raise
    with open(os.path.join(shared, "jax_space.tmp"), "w") as f:
        json.dump(steps, f)
    os.replace(os.path.join(shared, "jax_space.tmp"),
               os.path.join(shared, "jax_space.json"))


def _jax_space_result(shared: str) -> list:
    """The `_jax_space` process's steps (started by `_base`, so that its
    compile overlaps both launches), waiting up to RANK_TIMEOUT_S."""
    deadline = time.time() + RANK_TIMEOUT_S
    path = os.path.join(shared, "jax_space.json")
    while not os.path.exists(path):
        err = os.path.join(shared, "jax_space.err")
        if os.path.exists(err) or time.time() > deadline:
            with open(os.path.join(shared, "jax22_0.log")) as f:
                raise RuntimeError("the JAX space-mesh step failed:\n"
                                   + f.read()[-3000:])
        time.sleep(0.2)
    with open(path) as f:
        return json.load(f)


def _jax_leaf_grads(work: str) -> None:
    """(As a script: `python tests/test_torch_port_space.py jax_grads
    DIR`.) The JAX package's first-step gradient of every parameter on
    `make_mesh(4, space=2)` and `make_mesh(8, space=2)` (the state built
    by `Trainer._place(init_state)`, as
    `test_spatial_mesh_matches_single_device` builds it, and as this
    file's `_jax_fit` builds it) and on the data-only `make_mesh(2)`,
    against one device: each leaf's |g_mesh - g_one| / |g_one|, printed
    largest first. The optimizer is the identity, so the step's
    parameter change is the gradient."""
    sys.path[:0] = [TESTS, REPO]
    import conftest  # noqa: F401  the 8 CPU devices, the compile cache
    import jax
    import jax.numpy as jnp
    import optax
    from leod_tpu import config as jc
    from leod_tpu.data.loader import (StreamTrainLoader, harvest_frames,
                                      open_split_sequences)
    from leod_tpu.data.synthetic import generate_dataset
    from leod_tpu.parallel.mesh import make_mesh as j_make_mesh
    from leod_tpu.parallel.mesh import shard_batch, shard_params
    from leod_tpu.train.step import make_train_step
    from leod_tpu.train.trainer import Trainer as JTrainer

    root = generate_dataset(os.path.join(work, "synth"), **SPLIT)
    cfg = build_cfg(jc, root, os.path.join(work, "runs"))
    one = JTrainer(cfg, dtype=jnp.float32)
    seqs = open_split_sequences(cfg.dataset, "train")
    batch = next(iter(StreamTrainLoader(seqs, cfg.dataset, B, seed=0)))
    hb = harvest_frames(batch, 2, cfg.model.head.max_gt,
                        cfg.dataset.resolution_hw)
    dev = {k: hb[k] for k in ("ev", "is_first", "frame_t", "frame_mask",
                              "labels")}
    ident = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                         lambda g, s, p=None: (g, s))
    step = jax.jit(make_train_step(one.det, ident))
    state = one.init_state(B, seed=0)
    p0 = jax.tree_util.tree_flatten_with_path(state.variables["params"])[0]
    names = [".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in p0]

    def grads(st, b):
        new, m = step(st, b)
        flat = jax.tree.leaves(new.variables["params"])
        return ([np.asarray(v, np.float64) - np.asarray(w, np.float64)
                 for v, (_, w) in zip(flat, p0)],
                {k: float(m[k]) for k in ("loss", "grad_norm")})

    g1, m1 = grads(state, dev)
    print("one device", m1)
    for label, mesh in (("make_mesh(4, space=2)", j_make_mesh(4, space=2)),
                        ("make_mesh(8, space=2)", j_make_mesh(8, space=2)),
                        ("make_mesh(2)", j_make_mesh(2))):
        tr = JTrainer(cfg, dtype=jnp.float32, mesh=mesh)
        tr.det = one.det
        st = tr._place(one.init_state(B, seed=0))
        gm, mm = grads(st, shard_batch(mesh, dev))
        rows = sorted(((np.linalg.norm(b - a) / np.linalg.norm(a), n,
                        np.linalg.norm(b) / np.linalg.norm(a))
                       for n, a, b in zip(names, g1, gm)), reverse=True)
        print(f"{label} {mm}: {sum(r[0] > 1e-3 for r in rows)} of "
              f"{len(rows)} leaves over 1e-3")
        for gap, n, ratio in rows:
            print(f"  {gap:.4e}  |g|/|g_one| {ratio:.4f}  {n}")


def _run22(shared: str) -> dict:
    init_file = os.path.join(shared, "group22")
    argvs = [["sp22", str(r), init_file, shared] for r in range(4)]
    procs, logs = _launch(shared, argvs, "sp22")
    try:
        jax_steps = _jax_fit(shared, "one", 0, STEPS22)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    _wait(procs, logs)
    ranks = []
    for r in range(4):
        with open(os.path.join(shared, f"rank22_{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "jax_steps": jax_steps,
            "jax_space_steps": _jax_space_result(shared)}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    d = _shared_dir(tmp_path_factory)
    _locked(d, "base", _base)
    return d


@pytest.fixture(scope="module")
def run12(shared):
    return _locked(shared, "run12", _run12)


@pytest.fixture(scope="module")
def run22(shared):
    return _locked(shared, "run22", _run22)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The pieces on (1, 2)
# ---------------------------------------------------------------------------

def test_ranks_lay_out_as_jax_mesh(run12, run22):
    """rank = d * space + s, as `devices.reshape(data, space)`."""
    assert [r["mesh"] for r in run12["ranks"]] == [[1, 2, 0, 0],
                                                  [1, 2, 0, 1]]
    assert [r["mesh"] for r in run22["ranks"]] == [
        [2, 2, 0, 0], [2, 2, 0, 1], [2, 2, 1, 0], [2, 2, 1, 1]]


def test_space_conv2d_at_every_conv_of_the_model(run12):
    """Forward, input and weight gradients of every convolution of the
    model (its stem in all three input layouts, the stride-2
    downsamples, the FPN's and the head's 3 x 3 and 1 x 1 convolutions,
    the ConvLSTM's depthwise one) on a rank's rows with the halo,
    against the unsharded convolution, fp32."""
    names = set()
    for r in run12["ranks"]:
        for c in r["units"]["convs"]:
            names.add(c["name"])
            for k in ("y", "gx", "gw"):
                np.testing.assert_allclose(
                    c[k], c[f"{k}_want"], **TOL,
                    err_msg=f"{c['name']} {c['shape']} {k}")
    assert {"backbone.stage1.down.conv", "stem_width_fold", "stem_raw",
            "backbone.stage2.down.conv", "fpn.bu_conv2.conv",
            "head.cls_conv0_0.conv", "lstm_dws"} <= names


def test_grid_exchange_is_exact(run12):
    """The exchange gives a rank exactly its cell rows of every grid
    row, whose grid partition is the unsharded map's groups of those
    cells; the inverse gives back the rank's rows, and the gradient is
    the permuted output gradient, bit for bit."""
    for r in run12["ranks"]:
        ex = r["units"]["exchange"]
        for a, b in (("y", "y_want"), ("groups", "groups_want"),
                     ("back", "x"), ("gx", "gx_want")):
            np.testing.assert_array_equal(ex[a], ex[b], err_msg=a)


@pytest.mark.parametrize("rows,route", [(16, "aligned"), (2, "gather")])
def test_block_halves_match_unsharded_pair(run12, rows, route):
    """The window and grid halves of a block pair (modules under
    autograd, and the kernel wrapper's plain route) on a rank's rows:
    at 16 rows the windows are local and the grid runs between the
    exchange and its inverse, at 2 rows (1 a rank) both take the gather
    path; outputs, input and parameter gradients against the unsharded
    pair."""
    for r in run12["ranks"]:
        h = next(v for v in r["units"]["halves"] if v["rows"] == rows)
        want = ({"window_local": 2, "grid_exchange": 2, "window_gather": 0,
                 "grid_gather": 0} if route == "aligned" else
                {"window_local": 0, "grid_exchange": 0, "window_gather": 2,
                 "grid_gather": 2})
        assert h["counts"] == want
        for k in ("y", "y_kernel", "gx"):
            np.testing.assert_allclose(h[k], h[f"{k}_want"], **TOL,
                                       err_msg=k)
        for got, exp in zip(h["gp"], h["gp_want"]):
            np.testing.assert_allclose(got, exp, **TOL)


# ---------------------------------------------------------------------------
# Training and eval on (1, 2)
# ---------------------------------------------------------------------------

def test_space_fit_matches_one_process(run12):
    want = run12["one"]["fit"]["steps"]
    assert len(want) == STEPS12
    for r in run12["ranks"]:
        got = r["fit"]["steps"]
        assert r["fit"]["step"] == len(got) == STEPS12 and r["fit"]["finite"]
        for key in KEYS:
            np.testing.assert_allclose([s[key] for s in got],
                                       [w[key] for w in want], **STEP_TOL,
                                       err_msg=key)
    # each rank carries its height slice of the state table
    assert run12["ranks"][0]["fit"]["state_shapes"] == [
        [B, 8, 24, 32], [B, 4, 12, 64], [B, 2, 6, 128], [B, 1, 3, 256]]
    assert run12["one"]["fit"]["state_shapes"][0] == [B, 16, 24, 32]


def test_space_stop_on_one_rank_stops_both(run12):
    """A stop asked on space rank 1 alone stops both ranks at the same
    step, and rank 0 alone writes ckpt_last at that step."""
    s0, s1 = (r["stop"] for r in run12["ranks"])
    assert s0["step"] == s1["step"] == 2
    assert "ckpt_last.pt" in s0["files"]
    assert not [f for f in s1["files"] if f.startswith("ckpt_")]
    payload = torch.load(os.path.join(s0["run_dir"], "ckpt_last.pt"),
                         weights_only=True)
    assert payload["step"] == 2


def test_space_checkpoint_timer_is_rank0s(run12):
    """Rank 0's clock decides the timed checkpoint for both space ranks:
    rank 1's own clock, due after every step, saves nothing alone, and
    both ranks enter `save_checkpoint` (and its barrier) only at the
    stop."""
    assert [r["stop"]["saves"] for r in run12["ranks"]] == [[2], [2]]


def test_space_ranks_bit_equal_after_every_step(run12, run22):
    for run, n in ((run12, STEPS12), (run22, STEPS22)):
        digests = [[s["digest"] for s in r["fit"]["steps"]]
                   for r in run["ranks"]]
        assert all(d == digests[0] for d in digests)
        assert len(set(digests[0])) == n


def test_space_fit_routes(run12):
    """In the fit, stages 1-3 ran their block halves locally and through
    the exchange, and stage 4 (1 row a rank) through the gather path."""
    c = run12["ranks"][0]["fit"]["counts"]
    assert c["window_local"] == c["grid_exchange"] == 3 * c["grid_gather"]
    assert c["window_gather"] == c["grid_gather"] > 0


@pytest.mark.parametrize("kind", ["stream", "tta"])
def test_space_eval_matches_one_process(run12, kind):
    """Streaming eval on the (1, 2) mesh (the head's outputs gathered,
    only space rank 0 feeding the evaluator, the evaluators
    all-gathered) and TTA eval (whose process shards are the two space
    ranks): the same metrics on both ranks as in one process, rtol
    1e-6, as `test_spatial_mesh_fit_and_eval` holds JAX's mesh."""
    want = run12["one"]["eval"][kind]
    assert want["AP"] > 0.0
    for r in run12["ranks"]:
        got = r["eval"][kind]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)


def test_space_eval_matches_jax_space_mesh(run12):
    """The port's streaming eval on (1, 2) against the JAX package's on
    `make_mesh(4, space=2)` from the same weights, rtol 1e-6."""
    want = run12["jax_eval"]
    got = run12["ranks"][0]["eval"]["stream"]
    assert want["AP"] > 0.0 and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_space_remat_first_step_matches_full(run12, policy):
    for r in run12["ranks"]:
        full = r["fit"]["steps"][0]
        got = r["remat"][policy]["steps"]
        assert len(got) == 1
        for key in KEYS:
            np.testing.assert_allclose(got[0][key], full[key], rtol=1e-5,
                                       err_msg=key)


def test_space_gen4_flavour_step(run12):
    """`test_spatial_mesh_gen4_flavor`'s one step at space 2 (ds2 split,
    3 classes, 64 x 64 input): finite parameters, the state table's
    height halved, and one process's step."""
    want = run12["one"]["gen4"]
    for r in run12["ranks"]:
        g = r["gen4"]
        assert g["step"] == 1 and g["finite"]
        assert g["state_shapes"][0] == [4, 8, 16, 32]
        for key in KEYS:
            np.testing.assert_allclose(g["steps"][0][key],
                                       want["steps"][0][key], **STEP_TOL,
                                       err_msg=key)


def test_space_online_ssod_teacher_at_full_height(run12):
    """Online SSOD on (1, 2): each rank's teacher labels its data shard's
    slots at full height in the prefetch thread (no space shard there),
    so each rank merges what one process merges, and the student's
    steps are one process's."""
    one = run12["one"]["ssod"]
    assert sum(one["merged"][1:3]) > 0
    for r in run12["ranks"]:
        g = r["ssod"]
        assert g["step"] == 3
        assert g["teacher_state"] == one["teacher_state"] == [B, 16, 24, 32]
        assert g["merged"][:3] == one["merged"][:3]
        for key in KEYS:
            np.testing.assert_allclose([s[key] for s in g["steps"]],
                                       [s[key] for s in one["steps"]],
                                       **STEP_TOL, err_msg=key)
    assert run12["ranks"][0]["ssod"]["steps"][-1]["digest"] == \
        run12["ranks"][1]["ssod"]["steps"][-1]["digest"]


# ---------------------------------------------------------------------------
# (2, 2): BN over data x space, the step against the JAX mesh
# ---------------------------------------------------------------------------

def _flax_bn(y, gout, bn):
    """flax's `nn.BatchNorm` as the JAX package builds it (momentum 0.9,
    epsilon 1e-5, train mode) on y: its output, input and weight
    gradients by `jax.vjp`, and its running statistics (NCHW)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    def nhwc(t):
        return jnp.asarray(t.detach().numpy().transpose(0, 2, 3, 1))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    params = {"scale": jnp.asarray(bn.weight.detach().numpy()),
              "bias": jnp.asarray(bn.bias.detach().numpy())}
    stats = {"mean": jnp.asarray(bn.running_mean.numpy()),
             "var": jnp.asarray(bn.running_var.numpy())}

    def fwd(p, x):
        out, upd = jbn.apply({"params": p, "batch_stats": stats}, x,
                             mutable=["batch_stats"])
        return out, upd["batch_stats"]
    out, vjp, upd = jax.vjp(fwd, params, nhwc(y), has_aux=True)
    dp, dy = vjp(nhwc(gout))

    def nchw(a):
        return np.asarray(a).transpose(0, 3, 1, 2)
    return {"out": nchw(out), "dy": nchw(dy), "dw": np.asarray(dp["scale"]),
            "db": np.asarray(dp["bias"]), "mean": np.asarray(upd["mean"]),
            "var": np.asarray(upd["var"])}


@pytest.mark.parametrize("ref", ["port", "flax"])
def test_bn_over_data_and_space(run22, ref):
    """The four ranks' BN (each its data shard's frames, its half of the
    rows) against one BN over the concatenated frames, the port's
    one-process BN and flax's, within 1e-5: the four ranks' fp32 partial
    sums of a weight gradient round apart from one pass's (2.3e-6 on a
    bias gradient of 0.93 summed from terms of 5), and flax's own fp32
    gradients lie 5.2e-6 from the exact value
    (`test_torch_port_parallel.py`)."""
    y, gout, bn = _bn_data()
    want = _bn_run(y, gout, bn) if ref == "port" else _flax_bn(y, gout, bn)
    tol = 1e-5
    for r in run22["ranks"]:
        frames, rows = _bn_rows(*r["mesh"][2:])
        got = r["bn"]
        for k in ("out", "dy"):
            np.testing.assert_allclose(got[k], want[k][frames][:, :, rows],
                                       rtol=tol, atol=tol, err_msg=k)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                       err_msg=k)
    for k in ("dw", "db"):
        got = sum(r["bn"][k] for r in run22["ranks"])
        np.testing.assert_allclose(got, want[k], rtol=tol, atol=tol,
                                   err_msg=k)


def test_two_by_two_first_step_matches_jax_space_mesh(run22):
    """The first step on (data 2, space 2) against the JAX package's
    `Trainer.fit` on `make_mesh(4, space=2)` from the same weights: the
    loss and num_fg, rtol 2e-4, atol 1e-5 (what
    `test_spatial_mesh_matches_single_device` holds JAX's space mesh to:
    its gradients are not its one device's, see
    `test_two_by_two_steps_match_jax_one_device`)."""
    want = run22["jax_space_steps"]
    assert len(want) == 1
    for r in run22["ranks"]:
        got = r["fit"]["steps"][0]
        for key in ("loss", "num_fg"):
            np.testing.assert_allclose(got[key], want[0][key], **STEP_TOL,
                                       err_msg=key)


def test_two_by_two_steps_match_jax_one_device(run22):
    """Three steps on (data 2, space 2) against the JAX package's
    `Trainer.fit` on one device from the same weights: loss, num_fg and
    every gradient norm, rtol 2e-4, atol 1e-5. (JAX's own space mesh
    gives this loss at step 1 but gradient norms 4.7 % above it at
    `make_mesh(4, space=2)` and 2.7x at `make_mesh(8, space=2)`, and
    later losses apart; its data-only mesh gives these.)"""
    want = run22["jax_steps"]
    assert len(want) == STEPS22
    for r in run22["ranks"]:
        got = r["fit"]["steps"]
        assert r["fit"]["step"] == len(got) == STEPS22
        for key in KEYS:
            np.testing.assert_allclose([s[key] for s in got],
                                       [w[key] for w in want], **STEP_TOL,
                                       err_msg=key)
    assert run22["ranks"][0]["fit"]["state_shapes"][0] == [B // 2, 8, 24, 32]


# ---------------------------------------------------------------------------
# The CLI and the mesh in one process
# ---------------------------------------------------------------------------

def test_cli_train_takes_space_meshes(run12, run22):
    assert all(r["cli"] == [[1, 2]] for r in run12["ranks"])
    assert all(r["cli"] == [[2, 2]] for r in run22["ranks"])


@pytest.mark.parametrize("argv,error,match", [
    (["--mesh", "1x1x2"], ValueError, "process group has 1"),
    (["--mesh", "1x2"], ValueError, "process group has 1"),
    (["--mesh", "2x2"], ValueError, "process group has 1")])
def test_cli_train_mesh_refusals_in_one_process(argv, error, match):
    from leod_tpu_torch.cli import train as cli_train
    with pytest.raises(error, match=match):
        cli_train.main(argv + ["--cpu"])


def test_init_states_height_slice():
    from leod_tpu_torch import config as tc
    cfg = build_cfg(tc, "unused", "unused")
    from leod_tpu_torch.models.backbone import init_states
    st = init_states(cfg.model.backbone, 2, space=2)
    assert [list(h.shape) for h, _ in st] == [
        [2, 8, 24, 32], [2, 4, 12, 64], [2, 2, 6, 128], [2, 1, 3, 256]]
    with pytest.raises(ValueError, match="does not split"):
        init_states(cfg.model.backbone, 2, space=4)


if __name__ == "__main__":
    if sys.argv[1] == "one":
        _one_process(sys.argv[2])
    elif sys.argv[1] == "jax_space":
        _jax_space(sys.argv[2])
    elif sys.argv[1] == "jax_grads":
        _jax_leaf_grads(sys.argv[2])
    elif sys.argv[1] == "sp12":
        _worker12(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        _worker22(int(sys.argv[2]), sys.argv[3], sys.argv[4])
