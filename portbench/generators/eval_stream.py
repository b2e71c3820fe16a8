"""Offline streaming traffic: `run_streaming_eval` passes back to back.

The split is `traffic["sequences"]` sequences of `traffic["reprs"]`
reprs made from the seed, dealt by the program over B slots. Set-up
makes the weights from the seed (the BN statistics those of the
reference's training forward over the first frames, as a trained
model's match its activations), loads them into an inference
`Detector` and runs the
first `warm_batches` batches of a pass (every shape of the cell, and
the op library's build on a checkout's first run). The window runs
whole passes one after another; the harness's `on_batch` callback stops
the pass in flight at the window's end (the pass-end `evaluate()` falls
outside), and an evaluator of the harness's takes what the program
hands it.

Correctness, once the window has closed, for `checked_slots` slots
drawn from the seed: the reference runs a share of the window's batches
drawn from the seed (`checked_batch_share`, and every pass's first) at
those slots in float32 from the state the program's step took in, so
that a batch's numbers do not hang on how far a recurrent net drifts
over hundreds of frames (the state each batch hands on is judged
apart). The numbers: the 99th percentile over every anchor of every
labeled frame of the gap of an objectness or class probability
(`score_gap_p99`), the mean gap of a box's centre in strides or its log
size (`box_gap_mean`); the largest gap, over the reference's largest
magnitude, between the state the program hands the next batch and the
reference's from the same start (`state_gap`); and the detection rows
in which the program's NMS differs from the reference NMS run over the
program's own predictions (`nms_rows_differing`, exact). A pass's
first batch starts from a reset, so the start is judged without any
state of the program.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import bench, data, trace, work
from portbench.reference.model import (Anchors, Numerics, fold_frames,
                                       reset_rows)
from portbench.reference.nms import postprocess

WEIGHT_SEED_OFFSET = 1


class _Stop(Exception):
    """Raised from `on_batch` at the window's end."""


class Evaluator:
    """Stands in for the Prophesee evaluator: takes what the loop hands
    it, and its pass-end COCO evaluation is not run."""

    def add_labels(self, xs):
        pass

    def add_predictions(self, xs):
        pass

    def evaluate(self):
        return {}


def deal(n_seqs: int, slots: int) -> List[List[int]]:
    """The sequences of each slot, as the eval loader deals equal-length
    sequences: in order, over the slots 0..B-1, B-1..0, 0.. (LEOD's
    `stream_sharded_datapipe.py` pyramid)."""
    order = []
    while len(order) < n_seqs:
        order += list(range(slots)) + list(range(slots - 1, -1, -1))
    out: List[List[int]] = [[] for _ in range(slots)]
    for i in range(n_seqs):
        out[order[i]].append(i)
    return out


def first_window(tr: Dict, L: int) -> int:
    """The repr the streaming loader starts a sequence at: the window
    that ends on its first labeled repr starts there, or at 0 (LEOD's
    `sequence_streaming.py`)."""
    return max(tr["first_label"] - L + 1, 0)


def run(cell, seed: int, seconds: float, traced: bool, device: str,
        clock: bench.Clock) -> bench.Run:
    out, seqs, w0, checked, rec = program(cell, seed, seconds, traced,
                                          device, clock)
    out.checks = check(cell, seqs, w0, checked, rec, device)
    return out


def calibrate(cell, seed: int, device: str, seconds: float) -> Dict:
    """The readings of one seed after a window of `seconds`: the
    program's numbers (sound), the reference in fp8 in the program's
    place (the control) and under bf16 autocast (a witness at the
    program's precision), each checked as the program is; and the
    program's gaps against a free-running fp32 reference (no state
    handed over), for the look."""
    _, seqs, w0, checked, rec = program(cell, seed, seconds, False, device,
                                        bench.Clock())
    keys = _keys(rec)
    m = cell.config["model"]
    st = Anchors(m["in_res_hw"], m["strides"], device).strides
    fp32 = reference_run(cell, seqs, w0, checked, keys, device,
                         Numerics("fp32"), forced=_forced(rec))
    out = {"sound": dict(compare(cell, rec, fp32, device)),
           "sound_detail": dict(gaps(program_preds(rec), fp32["preds"], st,
                                     detail=True))}
    for name, kind in (("control_fp8", "fp8"), ("witness_bf16", "bf16")):
        other = reference_run(cell, seqs, w0, checked, keys, device,
                              Numerics(kind))
        ref = reference_run(cell, seqs, w0, checked, keys, device,
                            Numerics("fp32"), forced=other["states_in"])
        out[name] = dict(gaps(other["preds"], ref["preds"], st, detail=True)
                         + [carry_gap(other["states_in"], ref["states_out"])])
    free = reference_run(cell, seqs, w0, checked, keys, device,
                         Numerics("fp32"))
    out["free_running"] = dict(gaps(program_preds(rec), free["preds"], st,
                                    detail=True))
    out["rows"] = len(free["preds"])
    var = [v for k, v in w0.items() if k.endswith("running_var")]
    allv = torch.cat([v.reshape(-1) for v in var]).float()
    out["bn_var"] = {"min": float(allv.min()), "median": float(allv.median()),
                     "below_1e-2": int((allv < 1e-2).sum()), "n": len(allv)}
    return out


def program(cell, seed: int, seconds: float, traced: bool, device: str,
            clock: bench.Clock):
    """Set-up and the window: (run, sequences, weights, checked slots,
    what the window produced at them)."""
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.train.trainer import (default_frames_per_slot,
                                              run_streaming_eval)
    tr, cfgf = cell.traffic, cell.config
    cfg = bench.port_config(cfgf, "")
    B, L = tr["batch_size"], cfgf["dataset"]["sequence_length"]
    seqs = data.sequences(cfgf, tr, seed, device)
    ref = bench.reference_model(cfgf, device)
    w0 = bench.seeded_state(ref, seed + WEIGHT_SEED_OFFSET, tr["weights"],
                            device)
    bench.settle_bn(ref, w0, torch.as_tensor(seqs[0].frames[:B]),
                    tr["settle_steps"], device)
    del ref
    det = Detector(cfg.model, dtype=bench.compute_dtype(cfgf), device=device)
    det.load_state_dict(w0)
    cuda = det.device.type == "cuda"
    M = default_frames_per_slot(L)
    rng = np.random.default_rng(seed)
    checked = sorted(rng.choice(B, tr["checked_slots"], replace=False).tolist())
    lo = first_window(tr, L)
    per_pass = -(-(tr["reprs"] - lo) // L)

    def pass_(on_batch, max_batches=None, timings=None):
        try:
            run_streaming_eval(det, cfg, "val", batch_size=B,
                               frames_per_slot=M, sequences=seqs,
                               evaluator=Evaluator(), device=device,
                               on_batch=on_batch, max_batches=max_batches,
                               timings=timings)
        except _Stop:
            pass

    if traced:
        _span_layers()
    pass_(None, max_batches=tr["warm_batches"])
    taps = _tap_states(checked)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = bench.Run()
    out.setup_s = clock.now()
    rec: List[Dict] = []
    state = {"frames": 0, "batches": 0, "head_frames": 0, "pass": 0,
             "done": False}
    timings = {} if traced else None
    # the profiled batches give the kernel time a frame in every run on
    # the card, and the per-layer readings in a traced one
    prof = _Profiler(tr["profile_from"], tr["profile_batches"], cfgf, B, M) \
        if cuda else None
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def on_batch(bi, hb, preds, dets, valid):
        k = bi % per_pass
        n = min(L, tr["reprs"] - lo - k * L)
        state["frames"] += B * n
        state["batches"] += 1
        state["head_frames"] += B * M
        rows = [b * M + m for b in checked for m in range(M)]
        # the state this batch's step took in (its step ran just before)
        rec.append({"pass": state["pass"], "k": k, "states_in": taps[-1],
                    "frame_t": hb["frame_t"][checked].copy(),
                    "mask": hb["frame_mask"][checked].copy(),
                    "preds": preds[rows].float().clone(),
                    "dets": torch.as_tensor(dets[rows]),
                    "valid": torch.as_tensor(valid[rows])})
        if prof is not None:
            prof.batch(state["batches"], state["frames"])
        # the window ends with the first batch past its seconds, and not
        # before the profiled batches have closed
        if time.perf_counter() >= deadline and (prof is None
                                                or prof.done()):
            state["end"] = time.perf_counter()
            raise _Stop

    while "end" not in state:
        pass_(on_batch, timings=timings)
        state["pass"] += 1
    _tap_states(None)
    if traced:
        _span_layers(undo=True)
    # the batches the reference judges: a share drawn from the seed, and
    # every pass's first (the start, from a reset)
    pick = np.random.default_rng(seed + 2).random(len(rec))
    for r, u in zip(rec, pick):
        r["checked"] = r["k"] == 0 or u < tr["checked_batch_share"]
    out.window_s = state["end"] - t0
    out.attempted = state["batches"]
    out.values["frames"] = state["frames"]
    out.memory_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    if prof is not None:
        out.trace["window"] = prof.close()
        if prof.frames:
            out.values["profiled_frames"] = prof.frames
        out.values.update(prof.rooflines())
    if traced:
        out.values["harvest_ms"] = statistics.mean(timings["harvest_ms"])
        out.values["step_ms"] = statistics.mean(timings["step_ms"])
        bb, head = work.forward_flops(cfgf)
        out.values["flops"] = (B * L * state["batches"] * bb
                               + state["head_frames"] * head)
    del det
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out, seqs, w0, checked, rec


_SPANNED = ("harvest_frames", "make_eval_step", "postprocess")
_ORIGINAL: Dict = {}


def _span_layers(undo: bool = False) -> None:
    """Harness spans around the eval loop's calls into its layers (the
    host harvest, the step, the NMS), for the trace's idle gaps; undo
    puts the loop's own functions back."""
    from leod_tpu_torch.train import trainer as tr_mod
    if undo:
        for n, f in _ORIGINAL.items():
            setattr(tr_mod, n, f)
        _ORIGINAL.clear()
        return

    def spanned(name, fn):
        def call(*a, **k):
            with trace.span(name):
                return fn(*a, **k)
        return call

    for n in _SPANNED:
        f = getattr(tr_mod, n)
        _ORIGINAL[n] = f
        if n == "make_eval_step":
            setattr(tr_mod, n, lambda *a, _f=f, **k: spanned(
                "eval_step", _f(*a, **k)))
        else:
            setattr(tr_mod, n, spanned(n, f))


class _Profiler:
    """Profiles batches [first, first + n) of the window (by their
    `on_batch` count; a later n where the profiler lost events,
    `trace.Stretch`) and keeps what the rooflines need."""

    def __init__(self, first, n, cfgf, B, M):
        self.first, self.n = first, n
        self.cfgf, self.B, self.M = cfgf, B, M
        self.stretch = trace.Stretch(count_kernels=True)
        self.window = None
        self.opened_at = 0
        self.frames = 0      # reprs the profiled batches streamed

    def batch(self, count, frames):
        """After batch `count`'s NMS, with `frames` reprs streamed so
        far in the window."""
        if self.stretch.prof is not None and count == self.first + self.n:
            self.close(frames)
        if self.window is None and self.stretch.prof is None \
                and count == self.first \
                and self.stretch.tries < trace.PROFILE_TRIES:
            self.stretch.open()
            self.opened_at = frames

    def close(self, frames=None):
        """The profiled stretch's window; `frames` None closes one that
        the window's end cut short (no frame count then)."""
        if self.stretch.prof is not None:
            self.window = self.stretch.close()
            if self.window is None:
                self.first += self.n
            else:
                self.window.outside = "eval loop outside harvest, step " \
                    "and NMS (bridge, on_batch)"
                if frames is not None:
                    self.frames = frames - self.opened_at
        return self.window

    def done(self) -> bool:
        """The stretch closed with its events, or every try lost them."""
        return self.window is not None or (
            self.stretch.prof is None
            and self.stretch.tries >= trace.PROFILE_TRIES)

    def rooflines(self) -> Dict[str, float]:
        """{kernel: least seconds / device seconds} over the profiled
        batches' launches, each launch's least time from its stage's
        shape at this batch."""
        w = self.window
        if w is None:
            return {}
        m = self.cfgf["model"]
        shapes = work.stage_shapes(m)
        out = {}
        for k, launches in w.kernel_us().items():
            least = 0.0
            for name, _ in launches:
                c = _width(name)
                if c not in shapes:
                    continue
                s = shapes[c]
                n_tok = self.B * s["tokens"]
                if k == "block_attention_kernel":
                    f, b = work.attn_work(c, s["t"], n_tok, False)
                elif k == "block_mlp_kernel":
                    f, b = work.mlp_work(c, s["inner"], n_tok)
                elif k == "lstm_update_kernel":
                    f, b = work.lstm_work(c, n_tok)
                else:
                    continue
                least += work.bound(f, b, work.PEAK_BF16)[0]
            dev = sum(us for _, us in launches) / 1e6
            if least > 0:
                out[k] = least / dev
        return {f"roofline.{k}": v for k, v in out.items()}


def _width(name: str) -> int:
    import re
    mm = re.search(r"_kernel<(\d+)", name)
    return int(mm.group(1)) if mm else -1


_TAPPED: Dict = {}


def _tap_states(checked):
    """From now, every eval step's incoming (h, c) at the `checked` rows
    (before its reset) is kept, in step order, in the returned list;
    None puts the loop's own `make_eval_step` back."""
    from leod_tpu_torch.train import trainer as tr_mod
    if checked is None:
        tr_mod.make_eval_step = _TAPPED.pop("make")
        return None
    make = tr_mod.make_eval_step
    _TAPPED["make"] = make
    kept: List = []
    rows = torch.as_tensor(checked)

    def tapped(*a, **k):
        step = make(*a, **k)

        def run(states, batch):
            kept.append([tuple(x[rows.to(x.device)].clone() for x in hc)
                         for hc in states])
            return step(states, batch)
        return run
    tr_mod.make_eval_step = tapped
    return kept


def _keys(rec) -> Dict:
    """{(pass, batch k): [(slot index, row m, frame t), ...]} of the
    labeled frames at the checked slots of the checked batches."""
    out: Dict = {}
    for r in rec:
        if not r["checked"]:
            continue
        rows = out.setdefault((r["pass"], r["k"]), [])
        for j in range(r["mask"].shape[0]):
            for mm_ in range(r["mask"].shape[1]):
                if r["mask"][j, mm_]:
                    rows.append((j, mm_, int(r["frame_t"][j, mm_])))
    return out


def _forced(rec) -> Dict:
    """{(pass, k): the program's incoming state of that batch}."""
    return {(r["pass"], r["k"]): r["states_in"] for r in rec}


def check(cell, seqs, w0, checked, rec, device) -> list:
    """[(name, value)] of the numbers compared (module docstring)."""
    ref = reference_run(cell, seqs, w0, checked, _keys(rec), device,
                        Numerics("fp32"), forced=_forced(rec))
    return compare(cell, rec, ref, device)


def reference_run(cell, seqs, w0, checked, keys, device, nm: Numerics,
                  forced=None) -> Dict:
    """The reference over the window's batches at the checked slots:
    {"preds": {(pass, k, slot index, m): [A, 5 + C]} at the labeled
    frames, "states_in"/"states_out": {(pass, k): [(h, c) a stage]}}.
    Each batch starts from `forced[(pass, k)]` (the program's incoming
    state, in fp32) where given, else from the state the reference
    carried; a pass's first batch resets it, as the program does."""
    cfgf, tr = cell.config, cell.traffic
    m = cfgf["model"]
    L = cfgf["dataset"]["sequence_length"]
    slots = deal(len(seqs), tr["batch_size"])
    lo = first_window(tr, L)
    n = len(checked)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"preds": {}, "states_in": {}, "states_out": {}}
    try:
        model = bench.reference_model(cfgf, device)
        model.load_state_dict(w0)
        anchors = Anchors(m["in_res_hw"], m["strides"], device)
        dev_type = torch.device(device).type
        states = model.zero_states(n, device)
        with torch.no_grad(), nm.region(dev_type):
            for (p, k) in sorted(keys):
                if forced is not None:
                    states = [tuple(x.to(device).float() for x in hc)
                              for hc in forced[(p, k)]]
                out["states_in"][(p, k)] = states
                if k == 0:
                    states = reset_rows(states, torch.ones(
                        n, dtype=torch.bool, device=device))
                xs = []
                for s in checked:
                    seq = seqs[slots[s][0]]
                    a = lo + k * L
                    b = min(a + L, seq.num_ev_repr)
                    fr = torch.as_tensor(seq.read_ev_repr(a, b), device=device)
                    if b - a < L:
                        fr = torch.cat([fr, fr.new_zeros(
                            (L - (b - a),) + fr.shape[1:])])
                    xs.append(fold_frames(fr, m["in_res_hw"]))
                x = torch.stack(xs, 1)                 # [L, n, H, W, C]
                feats = []
                for t in range(L):
                    f, states = model.backbone_step(x[t], states, nm)
                    feats.append(f)
                states = [tuple(v.float() for v in hc) for hc in states]
                out["states_out"][(p, k)] = states
                for j, mm_, t in keys[(p, k)]:
                    fj = [lv[j:j + 1] for lv in feats[t]]
                    out["preds"][(p, k, j, mm_)] = model.detect(
                        fj, anchors, nm, train=False, sigmoid=True)[0].float()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def program_preds(rec) -> Dict:
    """{(pass, batch k, slot index, row m): the program's preds} at the
    labeled frames of the checked slots."""
    out = {}
    for r in rec:
        M = r["mask"].shape[1]
        for j in range(r["mask"].shape[0]):
            for mm_ in range(M):
                if r["mask"][j, mm_]:
                    out[(r["pass"], r["k"], j, mm_)] = r["preds"][j * M + mm_]
    return out


def _gap_values(got: Dict, want: Dict, strides):
    """(every probability gap, every box gap) over the frames of `want`."""
    sg, bg = [], []
    for key, w in want.items():
        g = got[key].to(w.device).float()
        sg.append((g[:, 4:] - w[:, 4:]).abs().reshape(-1))
        dxy = (g[:, :2] - w[:, :2]).abs() / strides[:, None]
        dwh = (torch.log(g[:, 2:4].clamp(min=1e-12))
               - torch.log(w[:, 2:4].clamp(min=1e-12))).abs()
        bg.append(torch.cat([dxy, dwh], -1).reshape(-1))
    return torch.cat(sg), torch.cat(bg)


def _q(v: torch.Tensor, q: float) -> float:
    return float(v.kthvalue(max(1, int(math.ceil(q * len(v))))).values)


def gaps(got: Dict, want: Dict, strides, detail: bool = False) -> list:
    """Over every anchor of every frame of `want`: the 99th percentile of
    the gaps of an objectness or class probability (score_gap_p99), and
    the mean gap of a box's centre in strides or its log width or height
    (box_gap_mean; its 99th percentile did not separate the control by
    3x, PERF.md); with `detail`, the largest gaps, means and 99th and
    99.9th percentiles of both, for the look."""
    sg, bg = _gap_values(got, want, strides)
    out = [("score_gap_p99", _q(sg, 0.99)), ("box_gap_mean", float(bg.mean()))]
    if detail:
        for name, v in (("score", sg), ("box", bg)):
            out += [(f"{name}_gap", float(v.max())),
                    (f"{name}_mean", float(v.mean())),
                    (f"{name}_p99", _q(v, 0.99)),
                    (f"{name}_p999", _q(v, 0.999))]
    return out


def carry_gap(states_in: Dict, ref_out: Dict):
    """("state_gap", the largest gap between the state a batch hands the
    next (the producer's incoming state of batch k + 1) and the
    reference's outgoing state of batch k from the same start, over the
    reference's largest magnitude of that stage's h or c)."""
    worst = 0.0
    for (p, k), ref in ref_out.items():
        nxt = states_in.get((p, k + 1))
        if nxt is None:
            continue
        for hc, rhc in zip(nxt, ref):
            for a, b in zip(hc, rhc):
                scale = float(b.abs().max()) + 1e-12
                worst = max(worst, float((a.to(b.device).float() - b).abs()
                                         .max()) / scale)
    return ("state_gap", worst)


def compare(cell, rec, ref: Dict, device) -> list:
    """The gaps of the program's predictions and carried state, and the
    detection rows in which the program's NMS differs from the reference
    NMS run over the program's own predictions."""
    m, pp = cell.config["model"], cell.config["postprocess"]
    st = Anchors(m["in_res_hw"], m["strides"], device).strides
    out = gaps(program_preds(rec), ref["preds"], st)
    out.append(carry_gap(_forced(rec), ref["states_out"]))
    got_rows, det_rows, valid_rows = [], [], []
    for r in rec:
        M = r["mask"].shape[1]
        for j in range(r["mask"].shape[0]):
            for mm_ in range(M):
                if (r["pass"], r["k"], j, mm_) in ref["preds"]:
                    got_rows.append(r["preds"][j * M + mm_].to(device))
                    det_rows.append(r["dets"][j * M + mm_])
                    valid_rows.append(r["valid"][j * M + mm_])
    differ = 0
    for i in range(0, len(got_rows), NMS_CHUNK):
        d_ref, v_ref = postprocess(
            torch.stack(got_rows[i:i + NMS_CHUNK]), m["num_classes"],
            pp["confidence_threshold"], pp["nms_threshold"],
            pp["pre_nms_topk"], pp["max_dets"])
        d_got = torch.stack(det_rows[i:i + NMS_CHUNK]).to(device)
        v_got = torch.stack(valid_rows[i:i + NMS_CHUNK]).to(device)
        differ += int((v_got != v_ref).sum())
        both = v_got & v_ref
        differ += int((d_got[both] != d_ref[both]).any(-1).sum())
    return out + [("nms_rows_differing", float(differ))]


NMS_CHUNK = 64
