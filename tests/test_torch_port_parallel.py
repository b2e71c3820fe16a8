"""The port's data parallelism against the JAX package's mesh, on the CPU.

Two worker processes run this file as a script: they import torch and
the port only, keep one thread each, and join one gloo process group
through a file. A module fixture launches them once (across the suite's
worker processes too: the first one to need them runs them under a
file lock, the others read its results), with a third process that runs
the port's one-process eval and online SSOD, and a fourth that runs the
JAX package's online SSOD on a mesh, while the pytest process runs the
JAX package's `Trainer` on a `make_mesh(2)` of the 8 CPU devices
`tests/conftest.py` forces. Each assertion is then its own
test. The configuration is `tests/mp_worker.py`'s (embed 32, 64 x 96,
partition 2 x 3, L 4, global B 8 of stream slots, max_det_frames 2, 3
steps) on a split the JAX generator writes.

What one global batch means under data parallelism: each rank's loss
normalizers and BN statistics are the global batch's, the ranks'
gradients are summed, so the two ranks' losses and gradient norms are
the JAX mesh run's (rtol 2e-4, atol 1e-5, as `tests/test_multiprocess.py`
holds two JAX processes to one) and the ranks' parameters stay
bit-equal after every step.
"""
import fcntl
import hashlib
import json
import os
import pickle
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
HW = (64, 96)
L = 4
B = 8
STEPS = 3
SPLIT = dict(num_train=2, num_val=4, num_test=0, num_reprs=24,
             label_every=4, first_label_repr=11, hw=HW)
WORLD = 2
# the BN case: unequal frame counts a rank
BN_FRAMES = (2, 4)
BN_SHAPE = (5, 3, 4)
RANK_TIMEOUT_S = 180
GROUP_TIMEOUT_S = 60


def build_cfg(cm, root, runs, exp="mp", **training):
    """`tests/mp_worker.py`'s configuration, in the config module `cm` of
    either package."""
    dst = replace(cm.dataset_preset("gen1"), path=root, resolution_hw=HW,
                  sequence_length=L, train_sampling="stream")
    model = cm.ModelConfig(
        backbone=cm.BackboneConfig(embed_dim=32, in_res_hw=HW,
                                   partition_size=(2, 3)),
        head=cm.HeadConfig(num_classes=2, max_gt=8))
    tr = cm.TrainingConfig(**{**dict(
        max_steps=STEPS, batch_size_train=B, batch_size_eval=4,
        val_check_interval=0, max_det_frames=2, learning_rate=1e-4,
        viz_every_steps=0), **training})
    return cm.ExperimentConfig(dataset=dst, model=model, training=tr,
                               save_dir=runs, exp_name=exp)


def ssod_cfg(cm, root, runs):
    return build_cfg(cm, root, runs, exp="ssod",
                     ssod_online=cm.SSODOnlineConfig(
                         enabled=True, burn_in_steps=1, obj_thresh=0.05,
                         cls_thresh=0.05, skip_first_t=1))


def _digest(module) -> str:
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _bn_data():
    """(y, output gradient, BN module) of the global batch, seeded."""
    from torch import nn
    g = torch.Generator().manual_seed(0)
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


def _bn_run(y, gout, bn):
    """batch_norm_train on y, its backward against gout: the arrays."""
    from leod_tpu_torch.models.layers import batch_norm_train
    y = y.clone().requires_grad_(True)
    out = batch_norm_train(y, bn)
    (out * gout).sum().backward()
    return {"out": out.detach().numpy(), "dy": y.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy().copy(),
            "var": bn.running_var.numpy().copy()}


# ---------------------------------------------------------------------------
# The ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _worker(rank: int, init_file: str, shared: str) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import leod_tpu_torch.models.head as head
    import leod_tpu_torch.train.trainer as T
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.convert import load_jax_variables
    from leod_tpu_torch.eval.tta import run_tta_eval
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.parallel import distributed as pdist
    from leod_tpu_torch.parallel.mesh import make_mesh

    pdist.maybe_initialize(f"file://{init_file}", num_processes=WORLD,
                           process_id=rank, backend="gloo",
                           timeout_s=GROUP_TIMEOUT_S)
    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    root = weights["root"]
    out, arrays = {}, {}

    # global BN over this rank's frames
    y, gout, bn = _bn_data()
    lo = sum(BN_FRAMES[:rank])
    rows = slice(lo, lo + BN_FRAMES[rank])
    with pdist.global_batch(torch.distributed.group.WORLD):
        bn_out = _bn_run(y[rows], gout[rows], bn)
    arrays.update({f"bn_{k}": v for k, v in bn_out.items()})

    # every step: the metrics, the parameters' digest and this rank's
    # own foreground count (the first sum the loss takes over the ranks)
    local_fg, steps, hooks = [], [], []
    real_sum, real_step = head.global_sum, T.make_train_step

    def spy_sum(x):
        if x.numel() == 2:
            local_fg.append(float(x[0]))
        return real_sum(x)

    def spy_step(*a, **k):
        step = real_step(*a, **k)

        def run(state, batch):
            state, m = step(state, batch)
            steps.append({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "num_fg": float(m["num_fg"]),
                          "local_fg": local_fg[-1],
                          "digest": _digest(a[0])})
            for hook in hooks:
                hook(len(steps))
            return state, m
        return run

    head.global_sum, T.make_train_step = spy_sum, spy_step
    mesh = make_mesh(WORLD)
    runs = os.path.join(shared, f"runs{rank}")

    def trainer(cfg, w="init"):
        tr = T.Trainer(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
        st = tr.init_state(B)
        load_jax_variables(tr.det, weights[w])
        return tr, st

    cfg = build_cfg(tc, root, runs)
    tr, st = trainer(cfg)
    st = tr.fit(max_steps=STEPS, state=st, log_every=1)
    tr.close()
    out["train"] = {"step": st.step, "steps": list(steps),
                    "files": sorted(os.listdir(tr.run_dir)),
                    "run_dir": tr.run_dir}
    if rank == 0:
        torch.save(tr.det.state_dict(), os.path.join(shared, "final.pt"))
    fresh, st = trainer(cfg)
    st, path = fresh.restore_latest(st)
    out["resume"] = {"step": st.step, "path": path,
                     "digest": _digest(fresh.det),
                     "optimizer_count": fresh.optimizer.count}
    fresh.close()

    # the stop: rank 1 alone asks after its second step
    steps.clear()
    stop_cfg = build_cfg(tc, root, runs, exp="stop", max_steps=50,
                         multihost_sync_every=1)
    tr, st = trainer(stop_cfg)
    if rank == 1:
        hooks.append(lambda n: tr.request_stop() if n == 2 else None)
    st = tr.fit(max_steps=50, state=st, log_every=1)
    hooks.clear()
    tr.close()
    out["stop"] = {"step": st.step, "files": sorted(os.listdir(tr.run_dir)),
                   "run_dir": tr.run_dir}

    # sharded eval of the randomized weights, all-gathered
    det = Detector(cfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(det, weights["rand"])
    out["eval"] = {
        "stream": T.run_streaming_eval(det, cfg, "val", device="cpu"),
        "tta": run_tta_eval(det, cfg, "val", device="cpu")}

    # online SSOD with a teacher of this rank's rows
    steps.clear()
    tr, st = trainer(ssod_cfg(tc, root, runs), "rand")
    st = tr.fit(max_steps=STEPS, state=st, log_every=1)
    tr.close()
    out["ssod"] = {"step": st.step, "losses": [s["loss"] for s in steps],
                   "digests": [s["digest"] for s in steps],
                   "teacher_rows": int(tr.ssod_batcher.states[0][0].shape[0]),
                   "merged": list(tr.ssod_batcher.merged)}
    np.savez(os.path.join(shared, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(shared, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _one_process(shared: str) -> None:
    """The port in one process on the same weights: eval and online SSOD
    (the references of the sharded eval and of the per-rank teachers)."""
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import leod_tpu_torch.train.trainer as T
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.convert import load_jax_variables
    from leod_tpu_torch.eval.tta import run_tta_eval
    from leod_tpu_torch.models.detector import Detector

    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    root, rand = weights["root"], weights["rand"]
    runs = os.path.join(shared, "one")
    cfg = build_cfg(tc, root, runs)
    det = Detector(cfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(det, rand)
    out = {"eval": {
        "stream": T.run_streaming_eval(det, cfg, "val", device="cpu"),
        "tta": run_tta_eval(det, cfg, "val", device="cpu")}}
    tr = T.Trainer(ssod_cfg(tc, root, runs), dtype=torch.float32,
                   device="cpu")
    st = tr.init_state(B)
    load_jax_variables(tr.det, rand)
    tr.fit(max_steps=STEPS, state=st, log_every=1)
    tr.close()
    out["ssod"] = [r["loss"] for r in _records(tr.run_dir) if "loss" in r]
    out["ssod_merged"] = list(tr.ssod_batcher.merged)
    with open(os.path.join(shared, "one.json"), "w") as f:
        json.dump(out, f)


def _jax_ssod(shared: str) -> None:
    """The JAX package's online SSOD on `make_mesh(2)` of 8 CPU devices
    from the randomized weights (one teacher over the global batch):
    its losses, the reference of the ranks' per-rank teachers."""
    sys.path[:0] = [TESTS, REPO]
    import conftest  # noqa: F401  the 8 CPU devices, the compile cache
    import jax.numpy as jnp
    from leod_tpu import config as jc
    from leod_tpu.parallel.mesh import make_mesh, shard_params
    from leod_tpu.train.trainer import Trainer as JTrainer

    with open(os.path.join(shared, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    mesh = make_mesh(WORLD)
    tr = JTrainer(ssod_cfg(jc, weights["root"], os.path.join(shared, "jax")),
                  dtype=jnp.float32, mesh=mesh)
    st = tr.init_state(B)
    tr.fit(max_steps=STEPS, log_every=1, state=st._replace(
        variables=shard_params(mesh, weights["rand"])))
    tr.close()
    with open(os.path.join(shared, "jax_ssod.json"), "w") as f:
        json.dump([r["loss"] for r in _records(tr.run_dir) if "loss" in r],
                  f)


# ---------------------------------------------------------------------------
# The fixture: the ranks, and the references meanwhile
# ---------------------------------------------------------------------------

def _launch(shared: str):
    init_file = os.path.join(shared, "group_init")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    jax_env = dict(env)
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    argv = [[str(r), init_file, shared] for r in range(WORLD)] + \
        [["one", shared], ["jax_ssod", shared]]
    envs = [env] * (WORLD + 1) + [jax_env]
    logs = [open(os.path.join(shared, f"{a[0]}.log"), "w") for a in argv]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)] + a, stdout=f,
        stderr=subprocess.STDOUT, env=e) for a, f, e in zip(argv, logs, envs)]
    return procs, logs


def _wait(procs, logs, shared: str) -> tuple:
    """(each rank's results, the one-process run's); a process that fails
    or outlives RANK_TIMEOUT_S is killed, and so are the others, and the
    fixture fails."""
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
    res = []
    for r in range(WORLD):
        with open(os.path.join(shared, f"rank{r}.json")) as f:
            res.append(json.load(f))
        res[-1]["arrays"] = dict(np.load(os.path.join(shared,
                                                      f"rank{r}.npz")))
    with open(os.path.join(shared, "one.json")) as f:
        return res, json.load(f)


def _records(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run_all(shared: str) -> dict:
    import jax
    import jax.numpy as jnp
    from leod_tpu import config as jc
    from leod_tpu.data.synthetic import generate_dataset
    from leod_tpu.parallel.mesh import make_mesh as j_make_mesh
    from leod_tpu.train.trainer import Trainer as JTrainer
    from test_torch_port_serve import _randomize

    root = generate_dataset(os.path.join(shared, "synth"), **SPLIT)
    jcfg = build_cfg(jc, root, os.path.join(shared, "jax"))
    jtr = JTrainer(jcfg, dtype=jnp.float32, mesh=j_make_mesh(WORLD))
    jstate = jtr.init_state(B)
    init = jax.tree.map(np.asarray, jstate.variables)
    rand = _randomize(init, np.random.default_rng(0))
    with open(os.path.join(shared, "weights.pkl"), "wb") as f:
        pickle.dump({"root": root, "init": init, "rand": rand}, f)
    procs, logs = _launch(shared)
    try:
        jstate = jtr.fit(max_steps=STEPS, state=jstate, log_every=1)
        jtr.close()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks, one = _wait(procs, logs, shared)
    with open(os.path.join(shared, "jax_ssod.json")) as f:
        jax_ssod = json.load(f)
    return {"root": root, "ranks": ranks, "one": one,
            "jax_steps": [r for r in _records(jtr.run_dir) if "loss" in r],
            "jax_final": jax.tree.map(np.asarray, jstate.variables),
            "jax_ssod": jax_ssod}


def _shared_dir(tmp_path_factory) -> str:
    """One directory for the whole session: under pytest-xdist the
    workers' base temp dirs share a parent."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = os.path.join(str(base), "torch_port_parallel")
    os.makedirs(d, exist_ok=True)
    return d


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    shared = _shared_dir(tmp_path_factory)
    done = os.path.join(shared, "results.pkl")
    with open(os.path.join(shared, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(done):
            res = _run_all(shared)
            with open(done + ".tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(done + ".tmp", done)
    with open(done, "rb") as f:
        return pickle.load(f)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Training against the JAX mesh
# ---------------------------------------------------------------------------

def test_two_rank_losses_match_jax_mesh(run):
    want = run["jax_steps"]
    assert len(want) == STEPS
    for r in run["ranks"]:
        got = r["train"]["steps"]
        assert r["train"]["step"] == len(got) == STEPS
        for key in ("loss", "grad_norm", "num_fg"):
            np.testing.assert_allclose([s[key] for s in got],
                                       [w[key] for w in want],
                                       rtol=2e-4, atol=1e-5, err_msg=key)


def test_ranks_local_num_fg_differ(run):
    """The ranks' own foreground counts differ in some step (so a local
    normalizer could not pass unseen), and the global count is their
    sum."""
    a, b = (r["train"]["steps"] for r in run["ranks"])
    assert any(x["local_fg"] != y["local_fg"] for x, y in zip(a, b))


def test_ranks_bit_equal_after_every_step(run):
    a, b = (r["train"]["steps"] for r in run["ranks"])
    assert [s["digest"] for s in a] == [s["digest"] for s in b]
    assert len({s["digest"] for s in a}) == STEPS


def test_final_weights_match_jax_mesh(run):
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.convert import _leaves, _target
    from leod_tpu_torch.models.detector import Detector
    cfg = build_cfg(tc, run["root"], "unused")
    det = Detector(cfg.model, dtype=torch.float32, device="cpu",
                   trainable=True)
    det.load_state_dict(torch.load(os.path.join(
        os.path.dirname(run["root"]), "final.pt"), weights_only=True))
    for coll in ("params", "batch_stats"):
        for path, arr in _leaves(run["jax_final"][coll]):
            module = det.get_submodule(".".join(path[:-1]))
            name, want = _target(module, path[-1], arr)
            got = getattr(module, name).detach().numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg="/".join(path))


# ---------------------------------------------------------------------------
# Global BN
# ---------------------------------------------------------------------------

def test_global_batch_norm_equals_concatenated_batch(run):
    y, gout, bn = _bn_data()
    want = _bn_run(y, gout, bn)
    lo = 0
    for r, n in enumerate(BN_FRAMES):
        got = run["ranks"][r]["arrays"]
        for k in ("out", "dy"):
            np.testing.assert_allclose(got[f"bn_{k}"], want[k][lo:lo + n],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[f"bn_{k}"], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        lo += n
    for k in ("dw", "db"):
        got = sum(r["arrays"][f"bn_{k}"] for r in run["ranks"])
        np.testing.assert_allclose(got, want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_global_batch_norm_matches_jax_on_concatenated_batch(run):
    """The two ranks' BN against flax's `nn.BatchNorm` as the JAX package
    builds it (`leod_tpu/models/layers.py` `ConvBNAct`: momentum 0.9,
    epsilon 1e-5, train mode) on the concatenated frames, its output,
    input and weight gradients by `jax.vjp`, and its running
    statistics, within 1e-5: flax's own fp32 weight gradient lies 5.2e-6
    from the float64 value on this data (a sum of 72 terms whose
    magnitudes add to 42), so the 1e-6 that holds the ranks to the
    port's one-process BN would test flax's rounding."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    y, gout, bn = _bn_data()

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
    want = {"out": nchw(out), "dy": nchw(dy), "dw": np.asarray(dp["scale"]),
            "db": np.asarray(dp["bias"]), "mean": np.asarray(upd["mean"]),
            "var": np.asarray(upd["var"])}
    lo = 0
    for r, n in enumerate(BN_FRAMES):
        got = run["ranks"][r]["arrays"]
        for k in ("out", "dy"):
            np.testing.assert_allclose(got[f"bn_{k}"], want[k][lo:lo + n],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[f"bn_{k}"], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        lo += n
    for k in ("dw", "db"):
        got = sum(r["arrays"][f"bn_{k}"] for r in run["ranks"])
        np.testing.assert_allclose(got, want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Files, resume and stop
# ---------------------------------------------------------------------------

def test_rank0_alone_writes_checkpoint_and_metrics(run):
    r0, r1 = (r["train"] for r in run["ranks"])
    assert "ckpt_last.pt" in r0["files"] and "metrics.jsonl" in r0["files"]
    assert not [f for f in r1["files"] if f.startswith("ckpt_")
                or f == "metrics.jsonl"]
    assert len([r for r in _records(r0["run_dir"]) if "loss" in r]) == STEPS


def test_resume_gives_both_ranks_rank0_checkpoint(run):
    r0, r1 = (r["resume"] for r in run["ranks"])
    assert r0["step"] == r1["step"] == STEPS
    assert r0["path"] == r1["path"]
    assert r0["path"].startswith(run["ranks"][0]["train"]["run_dir"])
    assert r0["digest"] == r1["digest"] \
        == run["ranks"][0]["train"]["steps"][-1]["digest"]
    assert r0["optimizer_count"] == r1["optimizer_count"] == STEPS


def test_stop_on_one_rank_stops_both(run):
    s0, s1 = (r["stop"] for r in run["ranks"])
    assert s0["step"] == s1["step"] == 2
    assert "ckpt_last.pt" in s0["files"]
    assert not [f for f in s1["files"] if f.startswith("ckpt_")]
    payload = torch.load(os.path.join(s0["run_dir"], "ckpt_last.pt"),
                         weights_only=True)
    assert payload["step"] == 2


# ---------------------------------------------------------------------------
# Sharded eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["stream", "tta"])
def test_sharded_eval_metrics(run, kind):
    """The all-gathered metrics are the same on both ranks and equal the
    one-process run's on the same weights."""
    m0, m1 = (r["eval"][kind] for r in run["ranks"])
    want = run["one"]["eval"][kind]
    assert m0 is not None and set(m0) == set(m1) == set(want)
    assert want["AP"] > 0.0
    for k in m0:
        assert m0[k] == pytest.approx(m1[k], abs=1e-9), k
        assert m0[k] == pytest.approx(want[k], abs=1e-9), k


# ---------------------------------------------------------------------------
# Online SSOD
# ---------------------------------------------------------------------------

def test_online_ssod_teacher_per_rank(run):
    s0, s1 = (r["ssod"] for r in run["ranks"])
    assert s0["step"] == s1["step"] == STEPS
    assert s0["teacher_rows"] == s1["teacher_rows"] == B // WORLD
    assert s0["digests"] == s1["digests"]
    # pseudo boxes merged after the burn-in, on the ranks together as in
    # one process
    one = run["one"]
    assert [a + b for a, b in zip(s0["merged"], s1["merged"])][:STEPS] \
        == one["ssod_merged"][:STEPS]
    assert sum(one["ssod_merged"][1:STEPS]) > 0
    np.testing.assert_allclose(s0["losses"], one["ssod"], rtol=1e-4)
    np.testing.assert_allclose(s1["losses"], one["ssod"], rtol=1e-4)


def test_online_ssod_matches_jax_mesh(run):
    """The two ranks' online SSOD losses (a teacher a rank over its own
    rows) against the JAX package's `Trainer` on `make_mesh(2)` (one
    teacher over the global batch), from the same randomized weights."""
    want = run["jax_ssod"]
    assert len(want) == STEPS
    for r in run["ranks"]:
        np.testing.assert_allclose(r["ssod"]["losses"], want, rtol=2e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The loaders a rank builds (no subprocess)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from leod_tpu.data.synthetic import generate_dataset
    return generate_dataset(str(tmp_path_factory.mktemp("par")), **SPLIT)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("sampling", ["random", "mixed"])
def test_rank_loader_matches_jax(root, tmp_path, monkeypatch, sampling, rank):
    """Process `rank` of 2 builds the JAX package's process loader: its
    own rows and seeds of the global slot table."""
    import jax.numpy as jnp
    from leod_tpu import config as jc
    from leod_tpu.parallel import distributed as jdist
    from leod_tpu.train.trainer import Trainer as JTrainer
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.parallel import distributed as tdist
    from leod_tpu_torch.train.trainer import Trainer
    from test_torch_port_train_loop import _same_batch

    monkeypatch.setattr(jdist, "process_shard", lambda: (rank, WORLD))
    monkeypatch.setattr(tdist, "process_shard", lambda: (rank, WORLD))

    def cfg(cm, sub):
        c = build_cfg(cm, root, str(tmp_path / sub))
        return replace(c, dataset=replace(c.dataset,
                                          train_sampling=sampling))
    jtr = JTrainer(cfg(jc, "j"), dtype=jnp.float32)
    ttr = Trainer(cfg(tc, "t"), dtype=torch.float32, device="cpu")
    (jl, jb), (tl, tb) = jtr.make_train_loader(5), ttr.make_train_loader(5)
    assert tb == jb == B
    jit_, tit = iter(jl), iter(tl)
    for _ in range(3):
        got, want = next(tit), next(jit_)
        assert got["ev"].shape[1] == B // WORLD
        _same_batch(got, want)
    jtr.close()
    ttr.close()


# ---------------------------------------------------------------------------
# The helpers at a world of one
# ---------------------------------------------------------------------------

def test_process_shard_and_local_batch_slice_in_one_process():
    from leod_tpu_torch.parallel import distributed as tdist
    assert tdist.process_shard() == (0, 1)
    assert tdist.local_batch_slice(8) == slice(0, 8)
    assert tdist.is_primary()
    tdist.maybe_initialize()                       # one process: no group
    assert not torch.distributed.is_initialized()


def test_allgather_pack_roundtrip():
    from leod_tpu_torch.data.labels import PROPH_DTYPE
    from leod_tpu_torch.eval.prophesee import PropheseeEvaluator
    from leod_tpu_torch.parallel.distributed import _pack_buffers, _unpack_into

    src = PropheseeEvaluator("gen1", False)
    frame = np.zeros((2,), PROPH_DTYPE)
    frame["t"] = (100, 100)
    frame["x"] = (1.5, 2.5)
    src.add_labels([frame])
    src.add_predictions([frame[:1]])
    dst = PropheseeEvaluator("gen1", False)
    _unpack_into(dst, _pack_buffers(src))
    assert len(dst.labels) == 1 and len(dst.predictions) == 1
    np.testing.assert_array_equal(dst.labels[0], frame)
    np.testing.assert_array_equal(dst.predictions[0], frame[:1])


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(num_devices=2), ValueError, "process group has 1"),
    (dict(space=2), ValueError, "does not divide the 1 ranks"),
    (dict(model=2), ValueError, "does not divide the 1 ranks")])
def test_make_mesh_refusals(kwargs, error, match):
    from leod_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(error, match=match):
        make_mesh(**kwargs)
    assert make_mesh().size == make_mesh(1).size == 1


def test_one_rank_group_step_is_bit_equal(root, tmp_path):
    """Two train steps in a one-rank gloo group (every collective runs:
    the loss sums, the gradient all-reduce, the metrics') are the steps
    without a group, bit for bit."""
    import torch.distributed as dist
    from leod_tpu_torch import config as tc
    from leod_tpu_torch.config import stem_fold_hw
    from leod_tpu_torch.data.loader import harvest_frames
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.parallel.mesh import make_mesh
    from leod_tpu_torch.train.optim import make_optimizer
    from leod_tpu_torch.train.step import TrainState, make_train_step
    from leod_tpu_torch.train.trainer import Trainer

    cfg = build_cfg(tc, root, str(tmp_path), batch_size_train=2)
    loader, _ = Trainer(cfg, dtype=torch.float32,
                        device="cpu").make_train_loader(0)
    it = iter(loader)
    mc = cfg.model
    batches = [harvest_frames(next(it), 2, mc.head.max_gt,
                              mc.backbone.in_res_hw,
                              fold_hw=stem_fold_hw(mc)) for _ in range(2)]

    def steps(mesh):
        det = Detector(mc, dtype=torch.float32, device="cpu", seed=0,
                       trainable=True)
        opt, _ = make_optimizer(cfg.training, det.parameters())
        step = make_train_step(det, opt, mesh=mesh)
        state = TrainState(states=det.init_states(2), step=0)
        ms = []
        for hb in batches:
            state, m = step(state, hb)
            ms.append({k: float(v) for k, v in m.items()})
        return ms, det.state_dict()

    want, want_sd = steps(None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        assert mesh.group is not None
        got, got_sd = steps(mesh)
    finally:
        dist.destroy_process_group()
    assert got == want
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


if __name__ == "__main__":
    if sys.argv[1] == "one":
        _one_process(sys.argv[2])
    elif sys.argv[1] == "jax_ssod":
        _jax_ssod(sys.argv[2])
    else:
        _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
