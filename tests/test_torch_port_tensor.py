"""The port's model mesh axis (`leod_tpu_torch/parallel/tensor.py`: the
transformer blocks' heads and MLP inner units sharded over ranks)
against the unsharded port and the JAX package on one device, on the CPU.

Four gloo ranks run this file as a script (torch and the port only, one
thread each, one process group joined through a file), launched once per
session under a file lock (as `tests/test_torch_port_space.py` launches
its ranks), with a one-process reference beside them; the pytest process
runs the JAX package on one device meanwhile. In the one launch:

- the model group of a (2, 1, 2) mesh: one block pair through the
  module path (forward and gradients) and through the kernel wrappers'
  plain versions against the unsharded pair, gated and not, fp32; the
  sharding rules' round trip through `gather_state`;
- `Trainer.fit` on (2, 1, 2): 3 fp32 steps of `tests/mp_worker.py`'s
  configuration (heads of 32 at embed 32: stage 1's single head stays
  whole) and 3 of one whose every stage shards (heads of 16), against
  JAX's one-device `Trainer.fit`; the moments' shards, the gathered
  parameters and moments against JAX's, gradflow against the one
  process's; its checkpoint resumed by the one process and the one
  process's resumed on the ranks;
- `Trainer.fit` on (1, 2, 2) for 2 steps, then a streaming eval whose
  metrics are JAX one-device's (`test_3d_mesh_fit_and_eval`'s bar);
- `cli.train --mesh 2x1x2` and `1x2x2`, and online SSOD's refusal.

Like the space axis (ROADMAP.md section C), the ranks are held to JAX on
one device and never to JAX's own model mesh.
"""
import fcntl
import os
import pickle
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path[:0] = [TESTS]

from test_torch_port_parallel import B, SPLIT, _records, build_cfg  # noqa: E402

WORLD = 4
STEPS, STEPS3D = 3, 2
KEYS = ("loss", "grad_norm", "grad_norm/backbone", "grad_norm/fpn",
        "grad_norm/head", "num_fg")
RANK_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 90
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=1e-5)
# the parameters within 1e-4, as
# `test_torch_port_parallel.py::test_final_weights_match_jax_mesh` holds
# them (Adam moves a weight whose gradient is a rounding's by up to lr a
# step, 1e-4 here); the first step's moments within MOMENT_TOL of each
# element and of the tensor's largest magnitude: the one-process port's
# own lie up to 1.08x of that bar at 1e-4 from JAX's in this
# configuration (the stem's and stage 1's LayerNorm's, whose gradients
# sum 98,304 positions), so they are held as the steps are
STATE_TOL = 1e-4
MOMENT_TOL = 2e-4
# the configurations: tests/mp_worker.py's (heads of 32: 1, 2, 4 and 8
# a stage) and one of heads of 16 (2, 4, 8, 16: every stage shards)
HEAD_WIDTHS = {"a": 32, "b": 16}


def cfg_of(cm, root, runs, which, exp=None, **training):
    """Configuration `which` ("a" or "b") in the config module `cm` of
    either package, with gradflow on."""
    import dataclasses
    cfg = build_cfg(cm, root, runs, exp=exp or f"tp_{which}", gradflow=True,
                    **training)
    bb = dataclasses.replace(cfg.model.backbone,
                             dim_head=HEAD_WIDTHS[which])
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone=bb))


# ---------------------------------------------------------------------------
# The ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _join(rank: int) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)


def _spy(T, steps: list, first: dict = None) -> None:
    """Every train step `train.trainer` makes records its metrics (the
    gradflow ones under "flow"); where `first` is given, the first step
    of a fit on a model axis also fills it with the parameters and the
    AdamW moments after it, gathered whole (every rank gathers)."""
    from leod_tpu_torch.parallel import tensor
    real = T.make_train_step

    def make(det, opt, *a, mesh=None, **k):
        step = real(det, opt, *a, mesh=mesh, **k)

        def run(state, batch):
            state, m = step(state, batch)
            steps.append({**{key: float(m[key]) for key in KEYS},
                          "flow": {key: float(v) for key, v in m.items()
                                   if key.startswith("gradflow/")}})
            if first is not None and len(steps) == 1:
                params, opt_state = dict(det.named_parameters()), \
                    opt.state_dict()
                if mesh is not None:
                    params = tensor.gather_state(det, mesh, params)
                    opt_state = tensor.gather_optimizer(det, mesh, opt_state)
                first.update(params=_numpy(params),
                             moments=_moments(det, opt_state))
            return state, m
        return run
    T.make_train_step = make


def _whole(cfg, variables):
    """A whole trainable port model holding a JAX tree."""
    from leod_tpu_torch.convert import load_jax_variables
    from leod_tpu_torch.models.detector import Detector
    det = Detector(cfg.model, dtype=torch.float32, device="cpu",
                   trainable=True)
    load_jax_variables(det, variables)
    return det


def _trainer(T, cfg, mesh, variables):
    tr = T.Trainer(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
    st = tr.init_state(B)
    tr.load_state(_whole(cfg, variables).state_dict())
    return tr, st


def _numpy(state: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in state.items()}


def _moments(det, opt_state: dict) -> dict:
    """{parameter name: (exp_avg, exp_avg_sq)} of an optimizer state."""
    names = [n for n, p in det.named_parameters() if p.requires_grad]
    return {names[int(i)]: (st["exp_avg"].numpy().copy(),
                            st["exp_avg_sq"].numpy().copy())
            for i, st in opt_state["adamw"]["state"].items()}


def _pair_checks(mesh) -> list:
    """One block pair (window then grid, dim 64, heads of 32: one a
    rank) on the model group: the module path under autograd and the
    kernel wrappers (plain on the CPU), sharded against whole, gated
    and not."""
    import copy
    from torch import nn
    from leod_tpu_torch.models.layers import (PartitionAttention,
                                              block_pair_tokens)
    from leod_tpu_torch.ops.maxvit_cuda import fused_block_pair
    from leod_tpu_torch.parallel import tensor
    out = []
    for gated in (False, True):
        torch.manual_seed(5)
        whole = nn.ModuleList([PartitionAttention(
            64, (2, 3), kind, dim_head=32, ls_init_value=0.5,
            mlp_gated=gated) for kind in ("window", "grid")])
        shard = copy.deepcopy(whole)
        report = tensor.shard_params(shard, mesh)
        g = torch.Generator().manual_seed(6)
        x = torch.randn(2, 4, 6, 64, generator=g)
        gy = torch.randn(2, 4, 6, 64, generator=g)
        xw = x.clone().requires_grad_(True)
        y = block_pair_tokens(xw, *whole, (2, 3))
        (y * gy).sum().backward()
        xs = x.clone().requires_grad_(True)
        with tensor.model_shard(mesh):
            ys = block_pair_tokens(xs, *shard, (2, 3))
            (ys * gy).sum().backward()
            with torch.no_grad():
                yk = fused_block_pair(x, *shard, (2, 3), False, 32,
                                      gated=gated)
        with torch.no_grad():
            yk_want = fused_block_pair(x, *whole, (2, 3), False, 32,
                                       gated=gated)
        shards = tensor.sharded_tensors(shard)
        gp, gp_want = {}, {}
        for (n, p), (_, q) in zip(shard.named_parameters(),
                                  whole.named_parameters()):
            gp[n] = p.grad.numpy().copy()
            want = q.grad
            if n in shards:
                want = tensor.shard_tensor(want, *shards[n],
                                           mesh.model_index, mesh.model)
            gp_want[n] = want.numpy().copy()
        out.append({"gated": gated, "report": report,
                    "y": ys.detach().numpy(), "y_want": y.detach().numpy(),
                    "y_kernel": yk.numpy(), "y_kernel_want": yk_want.numpy(),
                    "gx": xs.grad.numpy(), "gx_want": xw.grad.numpy(),
                    "gp": gp, "gp_want": gp_want, "sharded": sorted(shards)})
    return out


def _round_trip(mesh, cfg) -> dict:
    """`shard_params` then `gather_state` on a whole model: bit-equal."""
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.parallel import tensor
    det = Detector(cfg.model, dtype=torch.float32, device="cpu",
                   trainable=True)
    whole = {k: v.clone() for k, v in det.state_dict().items()}
    report = tensor.shard_params(det, mesh)
    back = tensor.gather_state(det, mesh, det.state_dict())
    return {"report": report, "equal": sorted(
        k for k in whole if torch.equal(whole[k], back[k])),
        "names": sorted(whole)}


def _cli_mesh(mesh_flag: str, root: str) -> list:
    """`cli.train --mesh` up to the Trainer it builds: the mesh's
    degrees and this rank's indices."""
    from leod_tpu_torch.cli import train as cli_train

    class Built(Exception):
        pass

    seen = []

    class Stub:
        def __init__(self, cfg, dtype=None, device=None, mesh=None):
            seen.append([mesh.size, mesh.space, mesh.model, mesh.data_index,
                         mesh.space_index, mesh.model_index])
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


def _wait_file(path: str) -> None:
    deadline = time.time() + RANK_TIMEOUT_S
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(path)
        time.sleep(0.1)


def _worker(rank: int, init_file: str, shared: str) -> None:
    _join(rank)
    import dataclasses
    import leod_tpu_torch.train.trainer as T
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.convert import load_jax_variables
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.parallel import distributed as pdist
    from leod_tpu_torch.parallel import tensor
    from leod_tpu_torch.parallel.mesh import make_mesh

    pdist.maybe_initialize(f"file://{init_file}", num_processes=WORLD,
                           process_id=rank, backend="gloo",
                           timeout_s=GROUP_TIMEOUT_S)
    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    root = weights["root"]
    runs = os.path.join(shared, "runs")
    mesh = make_mesh(WORLD, model=2)
    out = {"mesh": [mesh.size, mesh.space, mesh.model, mesh.data_index,
                    mesh.space_index, mesh.model_index],
           "pair": _pair_checks(mesh),
           "round_trip": _round_trip(mesh, cfg_of(tc, root, runs, "b"))}
    steps, first = [], {}
    _spy(T, steps, first)

    # (2, 1, 2): 3 steps of each configuration from the shared weights
    for which in ("a", "b"):
        del steps[:]
        first.clear()
        cfg = cfg_of(tc, root, runs, which)
        tr, st = _trainer(T, cfg, mesh, weights[f"init_{which}"])
        st = tr.fit(max_steps=STEPS, state=st, log_every=1)
        tr.close()
        shards = tensor.sharded_tensors(tr.det)
        params = dict(tr.det.named_parameters())
        opt = tr.optimizer.state_dict()
        res = {"step": st.step, "steps": list(steps), "shards": tr.shards,
               "shapes": {n: [list(params[n].shape),
                              [list(v.shape) for v in
                               _moments(tr.det, opt)[n]]]
                          for n in shards},
               "run_dir": tr.run_dir}
        whole = _numpy(tr.full_state_dict())
        if rank == 0:
            res.update(whole=whole, first=dict(first))
        out[f"fit_{which}"] = res
    if rank == 0:
        with open(os.path.join(shared, "tp_ready"), "w"):
            pass

    # the one process's checkpoint, resumed on the ranks for one step
    _wait_file(os.path.join(shared, "one_ready"))
    del steps[:]
    cfg = cfg_of(tc, root, runs, "a", exp="tp_resume")
    tr = T.Trainer(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
    st = tr.restore_checkpoint(os.path.join(shared, "one", "tp_a",
                                            "ckpt_last.pt"),
                               tr.init_state(B))
    out["resumed_step"] = st.step
    tr.fit(max_steps=STEPS + 1, state=st, log_every=1)
    tr.close()
    out["resume"] = list(steps)

    # online SSOD refuses a model axis
    scfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, ssod_online=dataclasses.replace(
            cfg.training.ssod_online, enabled=True)))
    try:
        T.Trainer(scfg, dtype=torch.float32, device="cpu",
                  mesh=mesh).fit(max_steps=1)
        out["ssod"] = None
    except NotImplementedError as e:
        out["ssod"] = str(e)

    # (1, 2, 2): 2 steps, then a streaming eval of seeded weights
    mesh3 = make_mesh(WORLD, space=2, model=2)
    del steps[:]
    cfg = cfg_of(tc, root, runs, "a", exp="tp_3d")
    tr, st = _trainer(T, cfg, mesh3, weights["init_a"])
    st = tr.fit(max_steps=STEPS3D, state=st, log_every=1)
    tr.close()
    out["fit_3d"] = {"step": st.step, "steps": list(steps),
                     "state_shapes": [list(h.shape) for h, _ in st.states]}
    det = Detector(cfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(det, weights["rand"])
    out["eval_3d"] = T.run_streaming_eval(det, cfg, "val", device="cpu",
                                          mesh=mesh3)
    out["mesh3"] = [mesh3.size, mesh3.space, mesh3.model, mesh3.data_index,
                    mesh3.space_index, mesh3.model_index]
    out["cli"] = _cli_mesh("2x1x2", root) + _cli_mesh("1x2x2", root)
    with open(os.path.join(shared, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _one_process(shared: str) -> None:
    """The port in one process: configuration "a"'s 3 steps (gradflow
    and its checkpoint), then one step resumed from its own checkpoint
    and one from the ranks'."""
    _join(0)
    import leod_tpu_torch.train.trainer as T
    from leod_tpu_torch import config as tc

    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    root = weights["root"]
    runs = os.path.join(shared, "one")
    cfg = cfg_of(tc, root, runs, "a")
    steps, first = [], {}
    _spy(T, steps, first)
    tr, st = _trainer(T, cfg, None, weights["init_a"])
    st = tr.fit(max_steps=STEPS, state=st, log_every=1)
    tr.close()
    out = {"steps": list(steps), "first": dict(first)}
    first.clear()
    with open(os.path.join(shared, "one_ready"), "w"):
        pass
    _wait_file(os.path.join(shared, "tp_ready"))
    for name, path in (("one", os.path.join(runs, "tp_a", "ckpt_last.pt")),
                       ("tp", os.path.join(shared, "runs", "tp_a",
                                           "ckpt_last.pt"))):
        del steps[:]
        tr = T.Trainer(cfg_of(tc, root, runs, "a", exp=f"resume_{name}"),
                       dtype=torch.float32, device="cpu")
        st = tr.restore_checkpoint(path, tr.init_state(B))
        out[f"resumed_step_{name}"] = st.step
        tr.fit(max_steps=STEPS + 1, state=st, log_every=1)
        tr.close()
        out[f"resume_{name}"] = list(steps)
    with open(os.path.join(shared, "one.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# The fixture: the ranks, and JAX on one device meanwhile
# ---------------------------------------------------------------------------

def _shared_dir(tmp_path_factory) -> str:
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = os.path.join(str(base), "torch_port_tensor")
    os.makedirs(d, exist_ok=True)
    return d


def _jax_tree(det) -> dict:
    """A port model's parameters and BN statistics as the JAX package's
    variables tree (numpy), `convert.load_jax_variables` backwards."""
    from leod_tpu_torch.convert import _target, jax_paths
    paths = jax_paths(det)
    tree = {}
    for name, t in det.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        coll, path, _ = paths[name]
        arr = t.detach().numpy()
        module = det.get_submodule(".".join(path[:-1]))
        if path[-1] == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        assert np.array_equal(_target(module, path[-1], arr)[1],
                              t.detach().numpy()), name
        node = tree.setdefault(coll, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def _jax_fit(shared: str, root: str, which: str, variables: dict) -> dict:
    """JAX's one-device `Trainer.fit` of configuration `which` for 3
    steps from `variables`: its step records, its final state and its
    state after the first step (the fit's jitted step wrapped to copy
    it out), in numpy."""
    import jax
    import jax.numpy as jnp
    import optax
    import leod_tpu.train.trainer as jtrainer
    from leod_tpu import config as jc
    from leod_tpu.train.step import TrainState

    def state(st) -> dict:
        adam = [x for x in jax.tree_util.tree_leaves(
            st.opt_state,
            is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(x, optax.ScaleByAdamState)][0]
        return jax.tree.map(np.asarray, {"variables": st.variables,
                                         "adam": adam._asdict()})

    first = []

    class Jit:
        """`jax` in the trainer's module, its `jit` wrapped."""
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn, **kw):
            step = jax.jit(fn, **kw)

            def run(st, batch):
                st, m = step(st, batch)
                if not first:
                    first.append(state(st))
                return st, m
            return run

    jtr = jtrainer.Trainer(cfg_of(jc, root, os.path.join(shared, "jax"),
                                  which), dtype=jnp.float32)
    v = jax.tree.map(jnp.asarray, variables)
    st = TrainState(variables=v, opt_state=jtr.optimizer.init(v["params"]),
                    states=jtr.det.init_states(B),
                    step=jnp.zeros((), jnp.int32))
    real, jtrainer.jax = jtrainer.jax, Jit()
    try:
        st = jtr.fit(max_steps=STEPS, log_every=1, state=st)
    finally:
        jtrainer.jax = real
    jtr.close()
    return {"steps": [r for r in _records(jtr.run_dir) if "loss" in r],
            "state": state(st), "first": first[0]}


def _jax_b(shared: str) -> None:
    """(As a script.) Configuration "b"'s JAX fit, beside the pytest
    process's of "a"."""
    sys.path[:0] = [TESTS, REPO]
    import conftest  # noqa: F401  the CPU devices, the compile cache
    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    res = _jax_fit(shared, weights["root"], "b", weights["init_b"])
    with open(os.path.join(shared, "jax_b.tmp"), "wb") as f:
        pickle.dump(res, f)
    os.replace(os.path.join(shared, "jax_b.tmp"),
               os.path.join(shared, "jax_b.pkl"))


def _make(shared: str) -> dict:
    from leod_tpu.data.synthetic import generate_dataset
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.models.detector import Detector
    from test_torch_port_serve import _randomize

    root = generate_dataset(os.path.join(shared, "synth"), **SPLIT)
    weights = {"root": root}
    for which in ("a", "b"):
        det = Detector(cfg_of(tc, root, "unused", which).model,
                       dtype=torch.float32, device="cpu", seed=0,
                       trainable=True)
        weights[f"init_{which}"] = _jax_tree(det)
    weights["rand"] = _randomize(weights["init_a"],
                                 np.random.default_rng(0))
    with open(os.path.join(shared, "weights.pkl"), "wb") as f:
        pickle.dump(weights, f)

    init_file = os.path.join(shared, "group")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    port_env = {k: v for k, v in env.items() if k != "XLA_FLAGS"}
    port_env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    argvs = [["rank", str(r), init_file, shared] for r in range(WORLD)] + \
        [["one", shared], ["jax_b", shared]]
    logs = [open(os.path.join(shared, f"proc{i}.log"), "w")
            for i in range(len(argvs))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                              + a, stdout=f, stderr=subprocess.STDOUT,
                              env=env if a[0] == "jax_b" else port_env)
             for a, f in zip(argvs, logs)]
    try:
        import jax.numpy as jnp
        from leod_tpu import config as jc
        from leod_tpu.models.detector import Detector as JDetector
        from leod_tpu.train.trainer import run_streaming_eval as j_eval
        jax_out = {"a": _jax_fit(shared, root, "a", weights["init_a"])}
        jcfg = cfg_of(jc, root, os.path.join(shared, "jax"), "a")
        jax_out["eval"] = j_eval(JDetector(jcfg.model, dtype=jnp.float32),
                                 weights["rand"], jcfg, "val")
    finally:
        deadline = time.time() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.time(), 1.0))
        except subprocess.TimeoutExpired:
            pass
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
                tails.append(f"{logs[i].name} (rc {procs[i].returncode}):\n"
                             + f.read()[-3000:])
        raise RuntimeError("\n".join(tails))
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(shared, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    with open(os.path.join(shared, "one.pkl"), "rb") as f:
        one = pickle.load(f)
    with open(os.path.join(shared, "jax_b.pkl"), "rb") as f:
        jax_out["b"] = pickle.load(f)
    return {"ranks": ranks, "one": one, "jax": jax_out}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    shared = _shared_dir(tmp_path_factory)
    done = os.path.join(shared, "run.pkl")
    with open(os.path.join(shared, "run.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(done):
            res = _make(shared)
            with open(done + ".tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(done + ".tmp", done)
    with open(done, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# The layout and the rules, without processes
# ---------------------------------------------------------------------------

def test_layout_is_jax_device_grid():
    """`mesh_layout(2, 2, 2)` is JAX's `make_mesh(space=2, model=2)` over
    the 8 CPU devices, `devices.reshape(data, space, model)`, and each
    group holds the ranks that differ in its axis alone."""
    from leod_tpu.parallel.mesh import make_mesh as j_make_mesh
    from leod_tpu_torch.parallel.mesh import mesh_layout
    jm = j_make_mesh(space=2, model=2)
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    lay = mesh_layout(2, 2, 2)
    assert grid.shape == (2, 2, 2)
    np.testing.assert_array_equal(np.array(lay["grid"]), grid)
    want = {"data": [list(grid[:, s, m]) for s in range(2) for m in range(2)],
            "space": [list(grid[d, :, m]) for d in range(2) for m in range(2)],
            "model": [list(grid[d, s, :]) for d in range(2) for s in range(2)],
            "replica": [list(grid[:, :, m].reshape(-1)) for m in range(2)]}
    for kind, lists in want.items():
        assert lay[kind] == [[int(r) for r in ranks] for ranks in lists], kind


def test_param_spec_rules():
    """`test_param_spec_rules`'s counterpart: `shard_params` cuts exactly
    the `_TP_RULES` tensors, qkv in whole heads (a contiguous block of
    rows), proj and proj_out in their input columns, both halves of a
    gated proj_in; the shards of every rank put back together are the
    whole tensors, bit for bit."""
    import copy
    import dataclasses
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.parallel import tensor
    cfg = cfg_of(tc, "unused", "unused", "b")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(cfg.model.backbone,
                                                mlp_gated=True)))
    torch.manual_seed(0)
    whole = Detector(cfg.model, dtype=torch.float32, device="cpu",
                     trainable=True)
    ws = whole.state_dict()
    k = 2
    parts = []
    for m in range(k):
        det = copy.deepcopy(whole)
        report = tensor.shard_params(det, SimpleNamespace(model=k,
                                                          model_index=m))
        assert report["replicated"] == [] and len(report["sharded"]) == 8
        parts.append(det.state_dict())
    shards = tensor.sharded_tensors(det)
    suffixes = {p for p, _ in tensor.TP_RULES}
    assert {n.split(".", 3)[-1] for n in shards} == suffixes
    changed = {n for n in ws if parts[0][n].shape != ws[n].shape}
    assert changed == set(shards)
    blk = "backbone.stage2.block0_window."
    dh, c = 16, 64
    for m in range(k):
        q = parts[m][blk + "attn.qkv.weight"]
        # heads [2m, 2m + 2) of 4: rows [m * 3 * 2 * dh, ...)
        np.testing.assert_array_equal(
            q, ws[blk + "attn.qkv.weight"][m * 6 * dh:(m + 1) * 6 * dh])
        np.testing.assert_array_equal(
            parts[m][blk + "attn.proj.weight"],
            ws[blk + "attn.proj.weight"][:, m * 2 * dh:(m + 1) * 2 * dh])
        inner = ws[blk + "mlp.proj_out.weight"].shape[1]
        n = inner // k
        pin = ws[blk + "mlp.proj_in.weight"]
        np.testing.assert_array_equal(
            parts[m][blk + "mlp.proj_in.weight"],
            torch.cat([pin[m * n:(m + 1) * n],
                       pin[inner + m * n:inner + (m + 1) * n]]))
        assert parts[m][blk + "norm2.weight"].shape == (c,)
    for name, (dim, gated) in shards.items():
        halves = [list(p[name].chunk(2 if gated else 1, dim))
                  for p in parts]
        back = torch.cat([torch.cat([h[i] for h in halves], dim)
                          for i in range(len(halves[0]))], dim)
        assert torch.equal(back, ws[name]), name


@pytest.mark.parametrize("op", ["block_attention", "block_mlp_tp",
                                "block_residual"])
def test_model_axis_ops_opcheck(op):
    """The model axis's custom ops (the head-shard attention: 1 head of
    2, the MLP's model-axis mode, the last residual) pass
    `torch.library.opcheck` on the CPU, launching nothing."""
    from leod_tpu_torch.ops import maxvit_cuda
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    c, dh = 64, 32
    args = {
        "block_attention": (t(2, 4, 6, c), t(c), t(c), t(3 * dh, c), t(3 * dh),
                            dh, 2, 3, False, 1e-5, 0),
        "block_mlp_tp": (t(2, 4, 6, c), t(2, 4, 6, c), t(c), t(c), t(c),
                         t(c), t(2 * c, c), t(2 * c), t(c, 2 * c), "gelu",
                         False, 1e-5, 0),
        "block_residual": (t(2, 4, 6, c), t(2, 4, 6, c), t(c), t(c)),
    }[op]
    before = [w.launches for w in maxvit_cuda.WRAPPERS
              + maxvit_cuda.TP_WRAPPERS]
    torch.library.opcheck(getattr(torch.ops.leod_tpu_torch, op).default,
                          args)
    assert [w.launches for w in maxvit_cuda.WRAPPERS
            + maxvit_cuda.TP_WRAPPERS] == before
    if op == "block_attention":
        out = torch.ops.leod_tpu_torch.block_attention.default(*args)
        assert out.shape == (2, 4, 6, dh)


def test_sharded_block_outside_model_shard_raises():
    from leod_tpu_torch.models.layers import PartitionAttention
    from leod_tpu_torch.parallel import tensor
    blk = PartitionAttention(64, (2, 3), "window", dim_head=32)
    tensor.shard_params(torch.nn.ModuleList([blk]),
                        SimpleNamespace(model=2, model_index=0))
    with pytest.raises(RuntimeError, match="outside model_shard"):
        blk(torch.zeros(2, 6, 64))


# ---------------------------------------------------------------------------
# The ranks' results
# ---------------------------------------------------------------------------

def test_ranks_lay_out_as_jax_mesh(run):
    """rank = (d * space + s) * model + m, on (2, 1, 2) and (1, 2, 2)."""
    assert [r["mesh"] for r in run["ranks"]] == [
        [2, 1, 2, 0, 0, 0], [2, 1, 2, 0, 0, 1], [2, 1, 2, 1, 0, 0],
        [2, 1, 2, 1, 0, 1]]
    assert [r["mesh3"] for r in run["ranks"]] == [
        [1, 2, 2, 0, 0, 0], [1, 2, 2, 0, 0, 1], [1, 2, 2, 0, 1, 0],
        [1, 2, 2, 0, 1, 1]]


@pytest.mark.parametrize("gated", [False, True])
def test_block_pair_matches_unsharded(run, gated):
    """One block pair with a head and half the inner units a rank: the
    module path's output, input and parameter gradients (a sharded
    tensor's against its slice of the whole gradient) and the kernel
    wrappers' plain route, against the whole pair, fp32, 1e-5."""
    for r in run["ranks"]:
        p = next(v for v in r["pair"] if v["gated"] == gated)
        assert p["report"] == {"sharded": ["0", "1"], "replicated": []}
        assert len(p["sharded"]) == 2 * len(
            [1 for n in p["sharded"] if n.startswith("0.")])
        for k in ("y", "y_kernel", "gx"):
            np.testing.assert_allclose(p[k], p[f"{k}_want"], **TOL,
                                       err_msg=k)
        for n in p["gp"]:
            np.testing.assert_allclose(p["gp"][n], p["gp_want"][n], **TOL,
                                       err_msg=n)


def test_gather_state_round_trip(run):
    for r in run["ranks"]:
        rt = r["round_trip"]
        assert rt["equal"] == rt["names"]
        assert len(rt["report"]["sharded"]) == 8


@pytest.mark.parametrize("which", ["a", "b"])
def test_tensor_parallel_steps_match_jax_one_device(run, which):
    """`test_tensor_parallel_matches_single_device`'s counterpart: 3 fp32
    steps on (2, 1, 2) against JAX's one-device `Trainer.fit` from the
    same weights, loss, num_fg and every gradient norm, rtol 2e-4. In
    "a" stage 1's single head stays whole; in "b" every stage shards."""
    want = run["jax"][which]["steps"]
    assert len(want) == STEPS
    replicated = {"a": ["backbone.stage1.block0_window",
                        "backbone.stage1.block0_grid"], "b": []}[which]
    for r in run["ranks"]:
        fit = r[f"fit_{which}"]
        assert fit["step"] == STEPS and len(fit["steps"]) == STEPS
        assert fit["shards"]["replicated"] == replicated
        assert len(fit["shards"]["sharded"]) == 8 - len(replicated)
        for key in KEYS:
            np.testing.assert_allclose([s[key] for s in fit["steps"]],
                                       [w[key] for w in want], **STEP_TOL,
                                       err_msg=key)


@pytest.mark.parametrize("which", ["a", "b"])
def test_moments_sharded_like_params(run, which):
    for r in run["ranks"]:
        shapes = r[f"fit_{which}"]["shapes"]
        assert shapes
        for name, (p, moments) in shapes.items():
            assert moments == [p, p], name


@pytest.mark.parametrize("which", ["a", "b"])
def test_gathered_state_matches_jax(run, which):
    """The ranks' parameters and BN statistics after 3 steps, gathered
    whole, against JAX's one-device state, and their parameters and
    AdamW moments after the first step against JAX's after its first
    (`STATE_TOL`, `MOMENT_TOL`; nu through its square root, which is
    linear in the gradient as mu is). (After 3 steps the moments carry the later
    steps' gradients, in which Adam's updates of weights whose gradient
    is a rounding's show: the one-process port's own moments lie up to
    3.8e-3 of a tensor's largest magnitude from JAX's there.)"""
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.convert import load_jax_variables
    from leod_tpu_torch.models.detector import Detector
    jax_run = run["jax"][which]
    fit = run["ranks"][0][f"fit_{which}"]
    det = Detector(cfg_of(tc, "unused", "unused", which).model,
                   dtype=torch.float32, device="cpu", trainable=True)
    load_jax_variables(det, jax_run["state"]["variables"])
    want = det.state_dict()
    for n, v in fit["whole"].items():
        if n.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v, want[n].numpy(), rtol=STATE_TOL,
                                   atol=STATE_TOL, err_msg=n)
    st = jax_run["first"]
    load_jax_variables(det, st["variables"])
    params = dict(det.named_parameters())
    assert set(fit["first"]["params"]) == set(params)
    for n, v in fit["first"]["params"].items():
        np.testing.assert_allclose(v, params[n].detach().numpy(),
                                   rtol=STATE_TOL, atol=STATE_TOL,
                                   err_msg=n)
    for i, key in enumerate(("mu", "nu")):
        load_jax_variables(det, {"params": st["adam"][key],
                                 "batch_stats": st["variables"][
                                     "batch_stats"]})
        params = dict(det.named_parameters())
        assert set(fit["first"]["moments"]) == set(params)
        for n, m in fit["first"]["moments"].items():
            # mu = 0.1 g and sqrt(nu) = sqrt(0.001) |g|: both linear in
            # the first gradient, held as the gradients are
            got, w = m[i], params[n].detach().numpy()
            if key == "nu":
                got, w = np.sqrt(got), np.sqrt(w)
            np.testing.assert_allclose(
                got, w, rtol=MOMENT_TOL,
                atol=MOMENT_TOL * float(np.abs(w).max()),
                err_msg=f"{key} {n}")


def test_gradflow_matches_one_process(run):
    """gradflow/* of the (2, 1, 2) steps: the one process's keys at
    every step, and its values within 1e-4 at the first (a sharded
    tensor's |grad| summed over the model group over the whole size);
    the later steps' within 1e-3, the bar `chip_smoke.py` holds later
    gradient norms to (`DP_FP32_LATER_NORM_RTOL`): Adam's first update
    of weights whose gradient is a rounding's moves them by lr either
    way, and the ls1 gradients with them (1.3e-4 at step 2)."""
    one = run["one"]["steps"]
    for r in run["ranks"]:
        got = r["fit_a"]["steps"]
        assert len(got) == len(one) == STEPS
        for i, (g, w) in enumerate(zip(got, one)):
            assert set(g["flow"]) == set(w["flow"]) and len(w["flow"]) > 200
            np.testing.assert_allclose(
                [g["flow"][k] for k in sorted(w["flow"])],
                [w["flow"][k] for k in sorted(w["flow"])],
                rtol=1e-4 if i == 0 else 1e-3, atol=1e-9, err_msg=str(i))


def test_checkpoints_cross_between_mesh_and_one_process(run):
    """A (2, 1, 2) checkpoint (whole tensors, gathered) resumes in one
    process, and a one-process checkpoint on the ranks: the step after
    either restore is the one process's own resumed step, rtol 2e-4."""
    one = run["one"]
    want = one["resume_one"]
    assert one["resumed_step_one"] == one["resumed_step_tp"] == STEPS
    assert len(want) == 1
    for got in [one["resume_tp"]] + [r["resume"] for r in run["ranks"]]:
        assert len(got) == 1
        for key in KEYS:
            np.testing.assert_allclose(got[0][key], want[0][key],
                                       **STEP_TOL, err_msg=key)
    assert all(r["resumed_step"] == STEPS for r in run["ranks"])
    payload = {name: torch.load(os.path.join(d, "ckpt_last.pt"),
                                weights_only=True)
               for name, d in (("tp", run["ranks"][0]["fit_a"]["run_dir"]),)}
    whole = run["ranks"][0]["fit_a"]["whole"]
    assert {k: tuple(v.shape) for k, v in payload["tp"]["model"].items()} \
        == {k: v.shape for k, v in whole.items()}


def test_3d_mesh_fit_and_eval(run):
    """`test_3d_mesh_fit_and_eval`'s counterpart on (1, 2, 2): 2 steps
    (the state table's height halved, one process's steps), then a
    streaming eval whose metrics equal JAX one-device's, rtol 1e-6."""
    want = run["jax"]["eval"]
    assert want["AP"] > 0.0
    one = run["one"]["steps"][:STEPS3D]
    for r in run["ranks"]:
        fit = r["fit_3d"]
        assert fit["step"] == STEPS3D
        assert fit["state_shapes"][0] == [B, 8, 24, 32]
        for key in KEYS:
            np.testing.assert_allclose([s[key] for s in fit["steps"]],
                                       [w[key] for w in one], **STEP_TOL,
                                       err_msg=key)
        got = r["eval_3d"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)


def test_cli_train_takes_model_meshes(run):
    for rank, r in enumerate(run["ranks"]):
        m = rank % 2
        assert r["cli"] == [[2, 1, 2, rank // 2, 0, m],
                            [1, 2, 2, 0, rank // 2, m]]


def test_online_ssod_refuses_model_axis(run):
    for r in run["ranks"]:
        assert r["ssod"] is not None and "C.3" in r["ssod"]


if __name__ == "__main__":
    if sys.argv[1] == "one":
        _one_process(sys.argv[2])
    elif sys.argv[1] == "jax_b":
        _jax_b(sys.argv[2])
    else:
        _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
