"""The port's raw-event ingestion and C++ host ops on the CPU against the
JAX package: the voxelizers exactly (seeded events with out-of-canvas,
padded and bin-edge events, the cutoff, all-padding windows), the .dat
writer and reader, `import_recording` / `import_split` (label and index
files byte for byte, frames equal to JAX's h5, through the frame store
and through the h5 branch, `--ds2`, the class map, the .dat/.npy
dedupe, the CLI), and the native NMS and COCO matcher exactly."""
import os
import zipfile

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import leod_tpu.native as j_native
from leod_tpu.data.import_raw import import_split as j_import_split
from leod_tpu.data.psee import RawEventReader as JRawEventReader
from leod_tpu.data.psee import write_dat as j_write_dat
from leod_tpu.eval.coco import COCOEvaluator as JCOCOEvaluator
from leod_tpu.eval.coco import _evaluate_image_all_areas as j_eval_image
from leod_tpu.ops import voxel as jv

import leod_tpu_torch.native as native
from leod_tpu_torch.cli import import_raw as cli_import_raw
from leod_tpu_torch.config import DatasetConfig
from leod_tpu_torch.data.import_raw import (_parse_class_map,
                                            import_recording, import_split)
from leod_tpu_torch.data.loader import open_split_sequences
from leod_tpu_torch.data.psee import (EVENT_DTYPE, RawEventReader,
                                      load_boxes, parse_dat_header,
                                      write_dat)
from leod_tpu_torch.eval.coco import COCOEvaluator, _evaluate_image_all_areas
from leod_tpu_torch.ops import voxel as tv
from leod_tpu_torch.ops.nms import batched_nms_numpy, nms_numpy

H, W, BINS, DT = 48, 64, 4, 50_000
REPR = "stacked_histogram_dt=50_nbins=4"


# ---------------------------------------------------------------------------
# Voxelization
# ---------------------------------------------------------------------------

def _events(rng, n, h, w, t_max, out_of_canvas=0.0, pad=0.0):
    x = rng.integers(0, w, n)
    y = rng.integers(0, h, n)
    bad = rng.uniform(size=n) < out_of_canvas
    x[bad] = rng.choice([-1, w, w + 7], bad.sum())
    y[bad & (rng.uniform(size=n) < 0.5)] = h
    p = rng.integers(0, 2, n)
    t = np.sort(rng.integers(0, t_max, n))
    valid = rng.uniform(size=n) >= pad
    return x, y, p, t, valid


def _both(fn_j, fn_t, args, **kw):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in args), **kw))
    got = fn_t(*(torch.from_numpy(np.asarray(a)) for a in args), **kw)
    return got.numpy(), want


CASES = {
    "seeded": dict(n=5000, h=H, w=W, bins=10, t_max=50_000),
    "out_of_canvas_and_padding": dict(n=4000, h=H, w=W, bins=10,
                                      t_max=50_000, out_of_canvas=0.2,
                                      pad=0.3),
    "cutoff": dict(n=3000, h=4, w=4, bins=1, t_max=300, cutoff=7),
    "all_padding": dict(n=64, h=16, w=16, bins=3, t_max=100, pad=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_histogram_matches_jax(case):
    c = dict(CASES[case])
    rng = np.random.default_rng(len(case))
    args = _events(rng, c["n"], c["h"], c["w"], c["t_max"],
                   c.get("out_of_canvas", 0.0), c.get("pad", 0.0))
    kw = dict(bins=c["bins"], height=c["h"], width=c["w"],
              count_cutoff=c.get("cutoff", 255))
    got, want = _both(jv.stacked_histogram, tv.stacked_histogram, args, **kw)
    assert got.dtype == np.uint8 and got.shape == (2 * c["bins"], c["h"],
                                                   c["w"])
    np.testing.assert_array_equal(got, want)
    if case == "cutoff":
        assert got.max() == 7
    if case == "all_padding":
        assert not got.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_mixed_density_stack_matches_jax(case):
    c = dict(CASES[case])
    rng = np.random.default_rng(10 + len(case))
    args = _events(rng, c["n"], c["h"], c["w"], c["t_max"],
                   c.get("out_of_canvas", 0.0), c.get("pad", 0.0))
    kw = dict(bins=min(c["bins"], 6), height=c["h"], width=c["w"],
              count_cutoff=c.get("cutoff"))
    got, want = _both(jv.mixed_density_stack, tv.mixed_density_stack, args,
                      **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_bin_edges_and_batch_match_jax():
    """Events exactly on the temporal bin edges (t a multiple of the
    window's span / bins, and powers of two of it for the log bins) in a
    batch of windows of other spans and paddings."""
    rng = np.random.default_rng(3)
    b, n, bins = 3, 400, 10
    x = rng.integers(0, W, (b, n))
    y = rng.integers(0, H, (b, n))
    p = rng.integers(0, 2, (b, n))
    spans = (100_000, 49_990, 1_000)
    t = np.stack([np.sort(np.concatenate([
        np.arange(bins + 1) * (s // bins),
        s // 2 ** np.arange(1, 8),
        rng.integers(0, s + 1, n - bins - 8)])) for s in spans])
    valid = np.ones((b, n), bool)
    valid[1, 350:] = False
    args = (x, y, p, t, valid)
    kw = dict(bins=bins, height=H, width=W)
    got, want = _both(jv.stacked_histogram_batch, tv.stacked_histogram_batch,
                      args, **kw)
    assert got.shape == (b, 2 * bins, H, W)
    np.testing.assert_array_equal(got, want)
    for i in range(b):
        g, w = _both(jv.mixed_density_stack, tv.mixed_density_stack,
                     [a[i] for a in args], bins=6, height=H, width=W)
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# .dat files and the import
# ---------------------------------------------------------------------------

def _make_raw(raw_dir, name="rec_000", n=6000, n_windows=5, seed=0,
              legacy_label_names=True):
    """A seeded .dat recording and its labels (`tests/test_import_raw.py`
    `_make_raw`): boxes at the end of window 2, 7 us into window 3 and
    at the end of window 4, classes 0, 1 and 3, the Prophesee label
    names of the Gen1 release where asked."""
    rng = np.random.default_rng(seed)
    ev = np.empty(n, dtype=EVENT_DTYPE)
    ev["t"] = np.sort(rng.integers(0, n_windows * DT, n).astype(np.uint32))
    ev["x"] = rng.integers(0, W, n)
    ev["y"] = rng.integers(0, H, n)
    ev["p"] = rng.integers(0, 2, n)
    write_dat(os.path.join(raw_dir, f"{name}.dat"), ev, height=H, width=W)
    names = (["ts", "x", "y", "w", "h", "class_id", "confidence"]
             if legacy_label_names else
             ["t", "x", "y", "w", "h", "class_id", "class_confidence"])
    boxes = np.zeros(3, dtype=[(nm, "<i8" if nm in ("t", "ts") else
                                ("<u4" if nm == "class_id" else "<f4"))
                               for nm in names])
    boxes[names[0]] = [2 * DT, 2 * DT + 7, 4 * DT]
    boxes["x"] = [5, 20, 8]
    boxes["y"] = [6, 10, 12]
    boxes["w"] = [12, 14, 16]
    boxes["h"] = [10, 12, 9]
    boxes["class_id"] = [0, 1, 3]
    boxes[names[-1]] = 1.0
    np.save(os.path.join(raw_dir, f"{name}_bbox.npy"), boxes)
    return ev


def test_dat_round_trip_matches_jax_reader(tmp_path):
    """`write_dat` writes the JAX writer's bytes; the port's reader gives
    JAX's reader's header, events and cursor at every step."""
    rng = np.random.default_rng(0)
    ev = np.empty(5000, dtype=EVENT_DTYPE)
    ev["t"] = np.sort(rng.integers(0, 1_000_000, 5000).astype(np.uint32))
    ev["x"] = rng.integers(0, 320, 5000)
    ev["y"] = rng.integers(0, 240, 5000)
    ev["p"] = rng.integers(0, 2, 5000)
    path, jpath = str(tmp_path / "a.dat"), str(tmp_path / "b.dat")
    write_dat(path, ev)
    j_write_dat(jpath, ev)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    with open(path, "rb") as f:
        assert parse_dat_header(f)[1:] == (8, (240, 320))
    ours, theirs = RawEventReader(path), JRawEventReader(path)
    assert len(ours) == len(theirs) == 5000 and ours.size == theirs.size
    for step in (50_000, 7, 120_000, 50_000, 300_000, 1_000_000):
        a, b = ours.load_delta_t(step), theirs.load_delta_t(step)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (ours.current_time, ours.done) == (theirs.current_time,
                                                   theirs.done)
    for op, arg in (("seek_time", 400_000), ("load_n_events", 333),
                    ("seek_event", 4990), ("load_n_events", 100)):
        a, b = getattr(ours, op)(arg), getattr(theirs, op)(arg)
        assert (a is None and b is None) or np.array_equal(a, b)
        assert (ours.current_time, ours.done) == (theirs.current_time,
                                                   theirs.done)
    np.testing.assert_array_equal(ours.load_delta_t(10), ev[:0])


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def _same_split(port_root, jax_root, split, names, frames=None, ds2=False):
    """Label and index files byte for byte, frames (the store's or the
    h5's) equal to the JAX h5's."""
    suffix = "_ds2_nearest" if ds2 else ""
    for name in names:
        a, b = (os.path.join(r, split, name) for r in (port_root, jax_root))
        assert _npz_members(f"{a}/labels_v2/labels.npz") == \
            _npz_members(f"{b}/labels_v2/labels.npz")
        ev = f"event_representations_v2/{REPR}"
        with open(f"{a}/{ev}/objframe_idx_2_repr_idx.npy", "rb") as f, \
                open(f"{b}/{ev}/objframe_idx_2_repr_idx.npy", "rb") as g:
            assert f.read() == g.read()
        with h5py.File(f"{b}/{ev}/event_representations{suffix}.h5") as f:
            want = f["data"][:]
        if frames is None:
            with h5py.File(f"{a}/{ev}/event_representations{suffix}.h5") as f:
                got = f["data"][:]
        else:
            got = frames[f"{split}/{name}"]
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """Three recordings: two .dat with labels, one also as .npy (imported
    once), and one unlabelled."""
    d = tmp_path_factory.mktemp("raw")
    _make_raw(str(d), "rec_000", seed=0)
    ev = _make_raw(str(d), "rec_001", n=3000, n_windows=3, seed=1,
                   legacy_label_names=False)
    np.save(str(d / "rec_001.npy"), ev)
    ev = _make_raw(str(d), "rec_002", n=2000, n_windows=2, seed=2)
    os.remove(str(d / "rec_002_bbox.npy"))
    return str(d)


@pytest.mark.parametrize("ds2,class_map", [(False, None),
                                           (False, {0: 0, 1: 1, 3: 2}),
                                           (True, None)])
def test_import_split_matches_jax(raw_dir, tmp_path, ds2, class_map):
    """`import_split` into the frame store and into h5 files against the
    JAX package's `import_split` of the same raw files (batch 2, so
    windows span device calls)."""
    kw = dict(height=H, width=W, bins=BINS, dt_us=DT, batch=2, ds2=ds2,
              class_map=class_map)
    jroot, hroot, sroot = (str(tmp_path / r) for r in ("j", "h", "s"))
    assert j_import_split(raw_dir, jroot, "train", **kw) == 3
    assert import_split(raw_dir, hroot, "train", device="cpu", **kw) == 3
    store = {}
    assert import_split(raw_dir, sroot, "train", frames=store,
                        device="cpu", **kw) == 3
    names = ["rec_000", "rec_001", "rec_002"]
    assert sorted(store) == [f"train/{n}" for n in names]
    _same_split(hroot, jroot, "train", names, ds2=ds2)
    _same_split(sroot, jroot, "train", names, frames=store, ds2=ds2)
    if not ds2:
        cfg = DatasetConfig(path=sroot, resolution_hw=(H, W),
                            ev_repr_name=REPR)
        seqs = open_split_sequences(cfg, "train", frames=store)
        np.testing.assert_array_equal(seqs[0].objframe_idx_2_repr_idx,
                                      [1, 2, 3])
        lab, _ = seqs[0].labels_at_repr_idx(3)
        assert int(lab.arr[0, 5]) == (2 if class_map else 3)


def test_import_recording_returns_and_cli(raw_dir, tmp_path):
    """`import_recording`'s counts and the CLI's flags against the JAX
    package's import: `--cpu --bins --dt-ms --batch --class-map`, into a
    frame store."""
    n_reprs, n_lab = import_recording(
        os.path.join(raw_dir, "rec_000.dat"),
        os.path.join(raw_dir, "rec_000_bbox.npy"),
        str(tmp_path / "one" / "train" / "rec_000"), height=H, width=W,
        bins=BINS, dt_us=DT, device="cpu", frames={})
    assert (n_reprs, n_lab) == (5, 3)
    store = {}
    n = cli_import_raw.main(
        ["--raw-dir", raw_dir, "--out", str(tmp_path / "cli"), "--split",
         "val", "--cpu", "--height", str(H), "--width", str(W), "--bins",
         str(BINS), "--dt-ms", "50", "--batch", "3", "--class-map",
         "0:0,1:1"], frames=store)
    assert n == 3 and sorted(store) == ["val/rec_000", "val/rec_001",
                                        "val/rec_002"]
    jroot = str(tmp_path / "j")
    j_import_split(raw_dir, jroot, "val", height=H, width=W, bins=BINS,
                   dt_us=DT, batch=3, class_map={0: 0, 1: 1})
    _same_split(str(tmp_path / "cli"), jroot, "val",
                ["rec_000", "rec_001", "rec_002"], frames=store)
    assert _parse_class_map("0:0,2:1") == {0: 0, 2: 1}
    assert _parse_class_map(None) is None
    assert load_boxes(os.path.join(raw_dir, "rec_000_bbox.npy"))[
        "class_confidence"].tolist() == [1.0, 1.0, 1.0]


# ---------------------------------------------------------------------------
# C++ host ops
# ---------------------------------------------------------------------------

def _numpy_only(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def _boxes(rng, n):
    xy = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    wh = rng.uniform(2, 60, (n, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + wh], 1)
    dup = rng.integers(0, n, n // 3)
    b[dup] = b[rng.integers(0, n, len(dup))] + rng.normal(0, 2, (len(dup), 4))
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[: n // 10] = scores[0]                      # ties
    return b, scores, rng.integers(0, 3, n).astype(np.float32)


@pytest.mark.parametrize("n", [1, 40, 1000])
def test_native_nms_matches_numpy_and_jax(n, monkeypatch):
    """The port's native NMS index for index against its numpy path and
    the JAX package's native NMS, class-agnostic and class-aware."""
    assert native.get_lib() is not None and j_native.get_lib() is not None
    rng = np.random.default_rng(n)
    b, s, c = _boxes(rng, n)
    for thr in (0.3, 0.65):
        got = [nms_numpy(b, s, thr), batched_nms_numpy(b, s, c, thr),
               native.nms(b, s, c, thr)]
        want = [j_native.nms(b, s, None, thr), j_native.nms(b, s, c, thr),
                j_native.nms(b, s, c, thr)]
        with monkeypatch.context() as m:
            _numpy_only(m)
            assert native.nms(b, s, c, thr) is None
            plain = [nms_numpy(b, s, thr), batched_nms_numpy(b, s, c, thr)]
        for g, w in zip(got + plain, want + want[:2]):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)


def _coco_case(rng, d, g):
    gt = np.abs(rng.normal(30, 40, (g, 4))) + 1
    gt[:, :2] = rng.uniform(0, 200, (g, 2))
    dt = (gt[rng.integers(0, g, d)] + rng.normal(0, 6, (d, 4)) if g
          else rng.uniform(1, 100, (d, 4)))
    dt[:, 2:] = np.abs(dt[:, 2:]) + 1
    return gt, rng.uniform(size=g) < 0.2, np.abs(dt), rng.uniform(0, 1, d)


def test_coco_matcher_matches_jax(monkeypatch):
    """The per-image matcher (native, and the numpy fallback) exactly
    against the JAX package's, then whole evaluations' stats."""
    rng = np.random.default_rng(0)
    for d, g in [(0, 0), (5, 0), (0, 5), (1, 1), (7, 3), (40, 12),
                 (60, 25), (150, 30)]:
        gt, gti, dt, scores = _coco_case(rng, d, g)
        want = j_eval_image(gt, gti, dt, scores, 100)
        got = _evaluate_image_all_areas(gt, gti, dt, scores, 100)
        with monkeypatch.context() as m:
            _numpy_only(m)
            plain = _evaluate_image_all_areas(gt, gti, dt, scores, 100)
        for a, b, c in zip(got, plain, want):
            np.testing.assert_array_equal(a, c, err_msg=f"d={d} g={g}")
            np.testing.assert_array_equal(b, c, err_msg=f"d={d} g={g}")

    def fill(ev, seed):
        r = np.random.default_rng(seed)
        for _ in range(12):
            gt, gti, dt, scores = _coco_case(r, 10, 6)
            ev.add_image(gt, r.integers(0, 2, 6), dt, r.integers(0, 2, 10),
                         scores, gti)
        return ev.summarize()

    assert fill(COCOEvaluator(2), 5) == fill(JCOCOEvaluator(2), 5)
