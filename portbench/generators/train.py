"""Training traffic: `Trainer.fit` over sequences made from the seed.

Set-up builds one `Trainer`, loads the seeded weights into it and runs
`fit` for the checked steps (`traffic["checked_steps"]`), recording what
each of those steps was fed and returned; the same trainer then runs
`fit` again in the window, its steps back to back, and asks it to stop
(`request_stop`) after the first step that ends past the window's
seconds, once the profiled steps are done. No validation, panel or
timed checkpoint falls inside; the checkpoints `fit` writes when it
stops are not written (the harness replaces `save_checkpoint` with a
clock that reads the end of the last step).

Once the window has closed, the reference (`portbench/reference/`)
follows the checked steps from the same weights on the same fed batches
(the loader's sampling and augmentation are the program's, held to the
JAX package's loaders by the repo's CPU tests), and the harness compares
the first step's carried (h, c) and BN batch statistics and every
leaf's change over the checked steps (`check_numbers`). The loss stage
is checked from the program's own forward: the reference works out the
first step's gradient of the prediction layers at the maps that those
layers gave in the program (the loss with SimOTA over every row, the
clip), and the harness compares it with the gradient the program's
optimizer took (from its AdamW moment after step 1); the maps
themselves are held to the ones the weights give from the inputs those
layers took. Each step's loss
and every leaf's first gradient against the reference's own are
measured by `calibrate` and not compared (`PERF.md` says why).
"""
from __future__ import annotations

import contextlib
import gc
import shutil
import statistics
import tempfile
import time
from typing import Dict, List, Optional

import torch

from portbench import bench, data, trace, work
from portbench.reference import loss as ref_loss
from portbench.reference.model import (Anchors, ConvBN, Numerics, decode,
                                       nchw, nhwc, reset_rows, unfold_ev_hw)

WEIGHT_SEED_OFFSET = 1
BN_MOMENTUM = 0.9       # running = 0.9 running + 0.1 batch (LEOD's flax BN)


def _dup_half(v: torch.Tensor) -> torch.Tensor:
    """A batch tensor whose second half of rows repeats its first: the
    fault of a step that leaves out half of the batch and takes the
    mean over the rest (rows lead, but in `ev` [L, B, ...])."""
    v = v.clone()
    dim = 1 if v.dim() == 5 else 0
    b = v.shape[dim]
    src = v.narrow(dim, 0, b // 2)
    v.narrow(dim, b - b // 2, b // 2).copy_(src)
    return v


def drop_half_labels(batch: Dict[str, torch.Tensor]) -> Dict:
    """The batch with the second half of its rows' `frame_mask` and
    `labels` zeroed: the fault of a step that runs the forward over
    every row but takes its loss, and so its gradient, over the first
    half (the mask enters only the loss)."""
    out = dict(batch)
    for k in ("frame_mask", "labels"):
        v = batch[k].clone()
        b = v.shape[0]
        v[b - b // 2:] = 0
        out[k] = v
    return out


class Recorder:
    """Wraps the program's train step: keeps the checked steps' batches,
    losses and first moments; opens the traced window's profiler."""

    def __init__(self, trainer, checked: int):
        self.trainer = trainer
        self.checked = checked
        self.batches: List[Dict[str, torch.Tensor]] = []
        self.losses: List[torch.Tensor] = []
        self.terms: List[Dict[str, torch.Tensor]] = []
        self.first_grads: Dict[str, torch.Tensor] = {}
        self.states1: List = []       # (h, c) a stage after step 1
        self.bn1: Dict[str, torch.Tensor] = {}   # BN running stats after it
        self.pred_taps: List = []    # step 1's prediction layers
        self.calls = 0
        self.on_step = None          # the window's hook, (index, fn) -> out
        self.after_step = None       # called at the end of every step

    def wrap(self, step):
        def run(state, batch):
            i = self.calls
            self.calls += 1
            if i < self.checked:
                self.batches.append({k: v.clone() for k, v in batch.items()})
            hooks = _tap_predictions(self.trainer.det.head,
                                     self.pred_taps) if i == 0 else []
            if self.on_step is not None:
                out = self.on_step(i, lambda: step(state, batch))
            else:
                with trace.span("train_step"):
                    out = step(state, batch)
            for h in hooks:
                h.remove()
            if self.after_step is not None:
                self.after_step()
            if i < self.checked:
                self.losses.append(out[1]["loss"].detach().clone())
                self.terms.append({k: out[1][k].detach().clone() for k in
                                   ("iou_loss", "conf_loss", "cls_loss",
                                    "num_fg")})
            if i == 0:
                self.states1 = [tuple(x.detach().float().clone() for x in hc)
                                for hc in out[0].states]
                self.bn1 = {f"{part}.{n}": b.detach().float().clone()
                            for part, bufs in
                            self.trainer.det.batch_stats().items()
                            for n, b in bufs.items()}
                opt = self.trainer.optimizer.adamw
                for n, p in self.trainer.det.named_parameters():
                    # AdamW's first moment after one update is
                    # (1 - b1) * the clipped gradient; none, if the
                    # optimizer took no step
                    m = opt.state.get(p, {}).get("exp_avg")
                    self.first_grads[n] = (torch.zeros_like(p) if m is None
                                           else m / 0.1)
            return out
        return run


def _tap_predictions(head, taps: List) -> List:
    """Forward hooks that keep in `taps`, per level k, what the program's
    prediction layers first took and gave, in fp32 NCHW: [box input
    (`reg_pred{k}`'s, which `obj_pred{k}` shares), class input, the map
    of box, objectness and class outputs]."""
    hooks = []
    k = 0
    while hasattr(head, f"reg_pred{k}"):
        slot: Dict = {}
        taps.append(slot)
        for name in ("reg_pred", "obj_pred", "cls_pred"):
            def hook(mod, args, out, slot=slot, name=name):
                if name not in slot:
                    slot[name] = (None if name == "obj_pred" else
                                  args[0].detach().float().clone(),
                                  out.detach().float().clone())
            hooks.append(getattr(head, f"{name}{k}").register_forward_hook(
                hook))
        k += 1
    return hooks


def _tapped(taps: List) -> List:
    """`_tap_predictions`' slots as (box input, class input, map)."""
    return [(t["reg_pred"][0], t["cls_pred"][0],
             torch.cat([t[n][1] for n in ("reg_pred", "obj_pred",
                                           "cls_pred")], 1))
            for t in taps]


class _TracedSteps:
    """Profiles `k` window steps from call index `first`; where the
    profiler lost events, the next `k` steps (`trace.Stretch`)."""

    def __init__(self, first: int, k: int):
        self.first, self.k = first, k
        self.stretch = trace.Stretch(count_kernels=False)
        self.window = None
        self.whole = False      # the window holds all k steps

    def close(self, whole: bool = False):
        """The profiled stretch's window; `whole` where it ends after its
        k-th step, not where the window's end cut it short."""
        if self.stretch.prof is not None:
            self.window = self.stretch.close()
            if self.window is None:
                self.first += self.k
            else:
                self.window.outside = "fit loop outside the step (the wait " \
                    "for the prefetch thread's batch)"
                self.whole = whole
        return self.window

    def done(self) -> bool:
        """The stretch closed with its events, or every try lost them."""
        return self.window is not None or (
            self.stretch.prof is None
            and self.stretch.tries >= trace.PROFILE_TRIES)

    def step(self, i: int, fn):
        if self.window is None and i == self.first \
                and self.stretch.tries < trace.PROFILE_TRIES:
            self.stretch.open()
        with trace.span("train_step"):
            res = fn()
        if i == self.first + self.k - 1:
            self.close(whole=True)
        return res


def build(cell, seed: int, device: str):
    """(trainer, recorder, state after the checked steps, initial
    weights, run dir): set-up through the checked steps."""
    from leod_tpu_torch.train import trainer as tr_mod
    cfg_file, traffic = cell.config, cell.traffic
    run_dir = tempfile.mkdtemp(prefix="portbench_")
    cfg = bench.port_config(cfg_file, run_dir)
    seqs = data.sequences(cfg_file, traffic, seed, device)
    trainer = tr_mod.Trainer(cfg, dtype=bench.compute_dtype(cfg_file),
                             device=device)
    rec = Recorder(trainer, traffic["checked_steps"])
    orig = tr_mod.make_train_step
    tr_mod.make_train_step = lambda *a, **k: rec.wrap(orig(*a, **k))
    marks = {}

    def save_checkpoint(state, name="last"):
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        marks["end"] = time.perf_counter()
    trainer.save_checkpoint = save_checkpoint
    b = traffic["batch_size"]
    if b != cfg_file["training"]["batch_size"] or \
            traffic["seq_len"] != cfg_file["dataset"]["sequence_length"]:
        raise ValueError("the traffic's batch or window is not the "
                         "configuration's")
    state = trainer.init_state(b)
    ref = bench.reference_model(cfg_file, device)
    w0 = bench.seeded_state(ref, seed + WEIGHT_SEED_OFFSET,
                            traffic["weights"], device)
    trainer.det.load_state_dict(w0)
    # the loader's sampling and augmentation draw from the traffic's own
    # seed, so that every run's window does the same work (the inputs
    # and weights draw from the run's)
    state = trainer.fit(max_steps=traffic["checked_steps"],
                        seed=traffic["loader_seed"], state=state,
                        sequences=seqs)
    trainer.seqs, trainer.marks, trainer.run_dir = seqs, marks, run_dir
    return trainer, rec, state, w0, orig


def run(cell, seed: int, seconds: float, traced: bool, device: str,
        clock: bench.Clock) -> bench.Run:
    from leod_tpu_torch.train import trainer as tr_mod
    trainer, rec, state, w0, orig = build(cell, seed, device)
    after = {n: p.detach().clone() for n, p in trainer.det.named_parameters()}
    out = bench.Run()
    timings: Optional[Dict[str, list]] = {} if traced else None
    tr = cell.traffic
    cuda = trainer.device.type == "cuda"
    # the profiled steps give the kernel time a frame in every run on
    # the card, and the per-layer readings in a traced one
    prof = _TracedSteps(tr["checked_steps"] + tr["profile_from"],
                        tr["profile_steps"]) if cuda else None
    if prof is not None:
        rec.on_step = prof.step
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out.setup_s = clock.now()
    step0 = state.step
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def after_step():
        # the window ends with the first step past its seconds, and not
        # before the profiled steps have closed
        if time.perf_counter() >= deadline and (prof is None or prof.done()):
            trainer.request_stop()
    rec.after_step = after_step
    state = trainer.fit(max_steps=10 ** 9, seed=tr["loader_seed"] + 1,
                        state=state, sequences=trainer.seqs, timings=timings)
    t_end = trainer.marks["end"]
    tr_mod.make_train_step = orig
    out.window_s = t_end - t0
    out.attempted = state.step - step0
    out.memory_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    b, L = tr["batch_size"], tr["seq_len"]
    out.values["frames"] = b * L * out.attempted
    if prof is not None:
        out.trace["window"] = prof.close()
        if prof.whole:
            out.values["profiled_frames"] = b * L * prof.k
    if traced:
        out.values["step_ms"] = statistics.mean(timings["step_ms"])
        out.values["wait_ms"] = statistics.mean(timings["wait_ms"])
        bb, head = work.forward_flops(cell.config)
        m = _frames_per_slot(cell)
        out.values["flops"] = 3 * (b * L * bb + b * m * head) * out.attempted
    batches = rec.batches
    prog = program_readings(cell, rec, w0, after)
    taps = rec.pred_taps
    shutil.rmtree(trainer.run_dir, ignore_errors=True)
    del trainer, rec, after
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    prog.update(pred_check(cell, w0, _tapped(taps), batches[0], device))
    del taps
    refr = reference_steps(cell, w0, batches, device, Numerics("fp32"))
    out.checks = list(check_numbers(prog, refr).items())
    return out


def program_readings(cell, rec, w0, after) -> Dict:
    """The program's side of `check_numbers`."""
    dh = cell.config["model"]["dim_head"]
    grad_t = dict(leaf_tensors(rec.first_grads.items(), dh))
    update_t = dict(leaf_tensors(((n, after[n] - w0[n]) for n in after), dh))
    return {"losses": [float(x) for x in rec.losses],
            "grads": {n: t.norm().item() for n, t in grad_t.items()},
            "updates": {n: t.norm().item() for n, t in update_t.items()},
            "grad_t": grad_t,
            "states1": rec.states1,
            "bn1": {k: (v - BN_MOMENTUM * w0[k].float()) / (1 - BN_MOMENTUM)
                    for k, v in rec.bn1.items()},
            "terms": [{k: float(v) for k, v in t.items()} for t in rec.terms]}


def _frames_per_slot(cell) -> int:
    from leod_tpu_torch.train.trainer import default_frames_per_slot
    return default_frames_per_slot(cell.traffic["seq_len"])


@contextlib.contextmanager
def _exact():
    """TF32 off for the reference's products, and memory handed back
    after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def pred_check(cell, w0, taps, batch, device) -> Dict:
    """The prediction layers of the first step, from what they took and
    gave (`taps`, per level (box input, class input, output map), NCHW):
    "pred_out_gap", the largest relative L2 gap of a level's map against
    the one the weights w0 give from those inputs in float32; "pred_t",
    the clipped gradients of `head.{reg,obj,cls}_pred{k}.{weight,bias}`
    that the loss with SimOTA over every row of the fed batch gives at
    those maps, worked out in float32."""
    m = cell.config["model"]
    clip = cell.config["training"]["gradient_clip_val"]
    with _exact():
        model = bench.reference_model(cell.config, device)
        model.load_state_dict(w0)
        nm = Numerics("fp32")
        gap, maps = 0.0, []
        with torch.no_grad():
            for k, (rf, cf, y) in enumerate(taps):
                want = nchw(model.head.predict(k, rf.to(device),
                                               cf.to(device), nm))
                gap = max(gap, float((y.to(device) - want).norm())
                          / (float(want.norm()) + 1e-12))
                maps.append(y.to(device).requires_grad_(True))
        anchors = Anchors(m["in_res_hw"], m["strides"], device)
        out = decode([nhwc(y) for y in maps], anchors, False)
        labels = batch["labels"].to(device).float()
        mask = batch["frame_mask"].to(device).bool()
        loss, _ = ref_loss.yolox_loss(
            out.float(), labels.reshape((-1,) + labels.shape[2:]),
            mask.reshape(-1), anchors.centers, anchors.strides,
            m["num_classes"])
        grads = {}
        for k, ((rf, cf, _), d) in enumerate(
                zip(taps, torch.autograd.grad(loss, maps))):
            for name, part, x in (("reg_pred", d[:, :4], rf),
                                  ("obj_pred", d[:, 4:5], rf),
                                  ("cls_pred", d[:, 5:], cf)):
                w = torch.einsum("nohw,nchw->oc", part, x.to(device))
                grads[f"head.{name}{k}.weight"] = w[..., None, None]
                grads[f"head.{name}{k}.bias"] = part.sum((0, 2, 3))
        del model
        return {"pred_out_gap": gap,
                "pred_t": {n: g.clamp(-clip, clip) for n, g in grads.items()}}


def reference_steps(cell, w0, batches, device, nm: Numerics,
                    half_batch: str = "") -> Dict:
    """The reference's checked steps from weights w0 on the fed batches:
    {"losses", "grads" (leaf norms of the first clipped gradient),
    "updates" (leaf norms of the change over the steps), "grad_t" (the
    first clipped gradient's leaves), "states1", "bn1", and
    `pred_check`'s readings of the reference's own prediction layers}. half_batch
    plants the fault of a step that leaves out the second half of the
    batch and takes the mean over the rest: "rows" feeds the first half
    twice, "loss" runs every row forward and the loss over the first
    half (`drop_half_labels`)."""
    m = cell.config["model"]
    tcfg = dict(cell.config["training"])
    with _exact():
        model = bench.reference_model(cell.config, device)
        model.load_state_dict(w0)
        params = [p for _, p in model.named_parameters()]
        names = [n for n, _ in model.named_parameters()]
        opt = ref_loss.AdamW(params, tcfg)
        anchors = Anchors(m["in_res_hw"], m["strides"], device)
        b = batches[0]["is_first"].shape[0]
        states = model.zero_states(b, device)
        losses, grads = [], {}
        terms = []
        dev_type = torch.device(device).type
        for k, batch in enumerate(batches):
            if half_batch == "rows":
                batch = {k2: _dup_half(v) for k2, v in batch.items()}
            elif half_batch == "loss":
                batch = drop_half_labels(batch)
            states = reset_rows(states, batch["is_first"].to(device).bool())
            x = unfold_ev_hw(batch["ev"].to(device).float())
            seq = []
            with nm.region(dev_type):
                for t in range(x.shape[0]):
                    f, states = model.backbone_step(x[t], states, nm)
                    seq.append(f)
                frame_t = batch["frame_t"].to(device).long()
                rows = torch.arange(b, device=device)[:, None]
                feats = []
                for lvl in range(len(seq[0])):
                    st = torch.stack([s[lvl] for s in seq])
                    g = st[frame_t, rows]
                    feats.append(g.reshape((-1,) + g.shape[2:]))
                model.head.tap = [] if k == 0 else None
                out = model.detect(feats, anchors, nm, train=True,
                                   sigmoid=False)
                if k == 0:
                    taps = model.head.tap
            labels = batch["labels"].to(device).float()
            mask = batch["frame_mask"].to(device).bool()
            loss, tk = ref_loss.yolox_loss(
                out.float(), labels.reshape((-1,) + labels.shape[2:]),
                mask.reshape(-1), anchors.centers, anchors.strides,
                m["num_classes"])
            terms.append({k2: v.item() for k2, v in tk.items()})
            g = torch.autograd.grad(loss, params, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi
                 for p, gi in zip(params, g)]
            clipped = opt.step(g)
            if k == 0:
                grad_t = dict(leaf_tensors(zip(names, clipped),
                                           m["dim_head"]))
                grads = {n: t.norm().item() for n, t in grad_t.items()}
                states1 = [tuple(x.detach().float().clone() for x in hc)
                           for hc in states]
                bn1 = {}
                for mod_name, mod in model.named_modules():
                    if isinstance(mod, ConvBN):
                        bn1[f"{mod_name}.bn.running_mean"] = \
                            mod.seen[0].float().clone()
                        bn1[f"{mod_name}.bn.running_var"] = \
                            mod.seen[1].float().clone()
            losses.append(loss.item())
            states = [tuple(s.detach().float() for s in st) for st in states]
            del out, loss, g, feats, seq
        update_t = dict(leaf_tensors(((n, p.detach() - w0[n])
                                      for n, p in zip(names, params)),
                                     m["dim_head"]))
        del model, params, opt
    return {"losses": losses, "grads": grads,
            "updates": {n: t.norm().item() for n, t in update_t.items()},
            "grad_t": grad_t, "terms": terms, "states1": states1, "bn1": bn1,
            **pred_check(cell, w0, taps, batches[0], device)}


def leaf_tensors(named, dim_head: int):
    """(leaf, fp32 tensor) of (name, tensor) pairs, where a packed
    attention projection (`attn.qkv`, rows head * 3 * dh + {q, k, v} *
    dh) counts as its three parts `<name>#q`, `#k`, `#v`: a key's bias
    gets no gradient under softmax, a query's and a value's do."""
    for n, t in named:
        t = t.detach().float()
        if ".attn.qkv." in n:
            parts = t.reshape((-1, 3, dim_head) + t.shape[1:])
            for j, part in enumerate("qkv"):
                yield f"{n}#{part}", parts[:, j]
        else:
            yield n, t



GRAD_FLOOR = 1e-3   # leaves whose reference gradient is under this share
                    # of the median leaf's move by rounding alone


def _update_gaps(prog: Dict, ref: Dict) -> List[float]:
    """Each kept leaf's gap between the program's and the reference's
    norms of the change over the checked steps, against the larger of
    the reference leaf's norm and the median kept leaf's; a leaf is kept
    where its reference gradient is at least GRAD_FLOOR of the median
    leaf's."""
    gmed = statistics.median(ref["grads"].values())
    kept = [n for n, g in ref["grads"].items() if g >= GRAD_FLOOR * gmed]
    umed = statistics.median(ref["updates"][n] for n in kept)
    return [abs(prog["updates"][n] - ref["updates"][n])
            / max(ref["updates"][n], umed, 1e-30) for n in kept]


def _pred_gaps(side: Dict) -> List[float]:
    """Each prediction leaf's norm of the difference between the first
    clipped gradient that the side's optimizer took and the one
    `pred_check` works out at the side's own prediction maps, against
    the larger of the leaf's norm and the median leaf's."""
    pt = side["pred_t"]
    pmed = statistics.median(float(t.norm()) for t in pt.values())
    return [float((side["grad_t"][n].to(t.device) - t).norm())
            / max(float(t.norm()), pmed, 1e-30) for n, t in pt.items()]


def check_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared (PERF.md gives why these):
    state_gap: the (h, c) the first step carries out, the largest gap of
      a stage over that stage's largest magnitude (the backbone's
      forward over the window, before any update);
    bn_gap: the first step's BN batch statistics (the FPN's and head's
      forward), the largest relative L2 gap of a layer's mean or
      variance;
    update_gap_median: the median kept leaf's gap of the change over the
      checked steps (`_update_gaps`);
    pred_out_gap: the first step's prediction maps against the ones the
      weights give from the inputs that those layers took in the program
      (`pred_check`);
    pred_grad_gap_median: the median prediction leaf's gap of the first
      clipped gradient against the one worked out at the program's own
      prediction maps (`_pred_gaps`): the loss with SimOTA, its backward
      into the last layer, the clip."""
    state_gap = 0.0
    for hc, rhc in zip(prog["states1"], ref["states1"]):
        for a, b in zip(hc, rhc):
            state_gap = max(state_gap, float((a.to(b.device) - b).abs().max())
                            / (float(b.abs().max()) + 1e-12))
    bn_gap = 0.0
    for k, b in ref["bn1"].items():
        a = prog["bn1"][k].to(b.device)
        bn_gap = max(bn_gap, float((a - b).norm()) / (float(b.norm()) + 1e-12))
    return {"state_gap": state_gap, "bn_gap": bn_gap,
            "update_gap_median": statistics.median(_update_gaps(prog, ref)),
            "pred_out_gap": prog["pred_out_gap"],
            "pred_grad_gap_median": statistics.median(_pred_gaps(prog))}


def unchecked_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Numbers measured for the look and not compared (PERF.md): the
    worst step's and the first step's loss gap; the worst and the median
    leaf's gap of the first clipped gradient's norm; the worst leaf's
    gaps of `_update_gaps` and `_pred_gaps`."""
    gmed = statistics.median(ref["grads"].values())
    leaf = [abs(prog["grads"][n] - g) / max(g, gmed, 1e-30)
            for n, g in ref["grads"].items()]
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-12)
                            for a, b in zip(prog["losses"], ref["losses"])),
            "loss_gap1": abs(prog["losses"][0] - ref["losses"][0])
            / max(abs(ref["losses"][0]), 1e-12),
            "grad_gap": max(leaf), "grad_gap_median": statistics.median(leaf),
            "update_gap": max(_update_gaps(prog, ref)),
            "pred_grad_gap": max(_pred_gaps(prog))}


def worst(prog: Dict, ref: Dict, key: str, n: int = 5) -> List:
    """The n leaves with the largest gap of `key` norms: (name, program,
    reference)."""
    med = statistics.median(ref[key].values())
    rows = sorted(ref[key], key=lambda k: -abs(prog[key][k] - ref[key][k])
                  / max(ref[key][k], med, 1e-30))
    return [(k, prog[key][k], ref[key][k]) for k in rows[:n]]


def calibrate(cell, seed: int, device: str, seconds: float = 0.0) -> Dict:
    """The readings of one seed: the program's numbers (sound), the
    reference in fp8 in the program's place (the control), the reference
    under bf16 autocast (a witness at the program's precision), and the
    two planted half-batch faults, the first half of the rows fed twice
    ("fault_half_rows") and the loss taken over the first half of the
    rows after a forward over all ("fault_half_loss"); a step that
    leaves the state unchanged reads 1 on the change by construction.
    Beside each, the numbers not compared, and each step's loss terms and
    the leaves that gap most, for the look."""
    trainer, rec, state, w0, orig = build(cell, seed, device)
    from leod_tpu_torch.train import trainer as tr_mod
    tr_mod.make_train_step = orig
    after = {n: p.detach().clone() for n, p in trainer.det.named_parameters()}
    prog = program_readings(cell, rec, w0, after)
    batches, taps = rec.batches, rec.pred_taps
    shutil.rmtree(trainer.run_dir, ignore_errors=True)
    del trainer, rec, after
    gc.collect()
    prog.update(pred_check(cell, w0, _tapped(taps), batches[0], device))
    del taps
    t = time.perf_counter()
    fp32 = reference_steps(cell, w0, batches, device, Numerics("fp32"))
    out = {"reference_s": time.perf_counter() - t,
           "sound": check_numbers(prog, fp32),
           "sound_unchecked": unchecked_numbers(prog, fp32)}
    for name, kw in (("control_fp8", dict(nm=Numerics("fp8"))),
                     ("witness_bf16", dict(nm=Numerics("bf16"))),
                     ("fault_half_rows", dict(nm=Numerics("fp32"),
                                              half_batch="rows")),
                     ("fault_half_loss", dict(nm=Numerics("fp32"),
                                              half_batch="loss"))):
        r = reference_steps(cell, w0, batches, device, **kw)
        out[name] = check_numbers(r, fp32)
        out[name + "_unchecked"] = unchecked_numbers(r, fp32)
        del r
    out["terms"] = {"program": prog["terms"], "reference": fp32["terms"]}
    out["worst_grads"] = worst(prog, fp32, "grads")
    return out
