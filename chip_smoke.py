#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port `leod_tpu_torch` on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

1. Build: every CUDA source under leod_tpu_torch/csrc/ is compiled with
   nvcc for sm_90a, one nvcc per source, all started together.

Phases 2-4 run for two paths in turn, each a seeded model at full width
and depth: RVT-B Gen1 (`experiment_preset("gen1", "base")`: stages
64/128/256/512, heads of 32) and RVT-S Gen1 (`experiment_preset("gen1",
"small")`: stages 48/96/192/384, heads of 24). The first path alone
also runs the variant phase (2b) and the eval phase (5), never a width
or a shape less.

2. Kernel phase: each kernel's wrapper against its plain PyTorch version
   on the card, on the same inputs, at the Gen1 shapes the serving
   path gives it (B = 8 slots): the partition-attention block pair and
   the whole stage at all four stage shapes, from warm non-zero (h, c),
   each kernel of a stage alone at the same four shapes (the attention
   half `block_attention`, window and grid, the per-token half
   `block_mlp` and the ConvLSTM update `lstm_update`, each also at
   B = 6 (the cycle's pseudo-label batch) and B = 1, where their plans
   of windows, heads, row tiles and clusters differ, with the plan the
   launch took), and the NMS keep mask at
   K = 1000, exact, on random boxes and on staircases (box i suppresses
   only i + 1, so kept and suppressed boxes alternate across every
   32-box word), with the build's and the sweep's device time on each.
   Each row carries
   its bound (bytes or tensor-core operations). Timed with CUDA events
   (median of 20 runs after warm-up); "host_us" is the host time of one
   wrapper call alone (what it costs the host to launch).
2b. Variant phase (first path): `lstm_update` at the stage shapes with
   every cluster size its K takes, forced, and with c in fp32, by device
   time, each against its plain version; and the NMS sweep's design
   latency floor: ceil(K/32) dependent steps of its chain (`sweep_tile`
   in csrc/nms.cu: a 32-box word resolved in registers, a shuffle, an
   OR of the kept rows), at the latency a one-warp probe built beside
   the kernels from that same source measures with clock64 and
   %globaltimer.
3. Slice phase: the path's seeded `Detector` behind `ServingEngine`
   answers requests from client threads, one of which forces an LRU
   eviction. Every kernel's launch count must rise by what the path
   implies per step. One step through the plain versions is held
   against the kernel step, at B = 8 and at B = 1, and the step is
   timed at B = 1 and B = 8.

Tolerances, fixed before any run: the kernels compute in bf16 with fp32
accumulation and round at other points than the plain bf16 version
(which rounds every op's output), so an output may differ by a few bf16
ulps of the largest value: |kernel - plain| <= 2^-5 * max|plain| per
tensor. The slice compounds that through four stages, the FPN and the
head, and the box decode's exp turns absolute into relative error:
2^-4 * max|plain| per tensor. The NMS keep mask must match exactly.
All comparisons are in bf16 or in fp32 elementwise arithmetic; TF32 is
switched off for the fp32 products of the plain ConvLSTM update.

4. Profile: torch.profiler over a few serve steps at B = 1 and B = 8:
   the device-busy time per step, its idle share against the
   unprofiled step time, and the kernels by device time. Every
   `__global__` kernel in leod_tpu_torch/csrc/ must show up in the
   profiled steps.
5. Eval phase (first path): streaming evaluation through
   `run_streaming_eval`, the port's second entry point. Data: 8 Gen1
   val sequences of 42 reprs at 240 x 304 (labeled every 4 reprs from
   repr 3), made in memory by `data/synthetic.py`'s renderer (seed 0)
   as array-backed sequences; `harvest_frames` pads them to 256 x 320
   and folds them to [64, 80, 320]. Shapes: B = `batch_size_eval` = 8
   slots, L = `sequence_length` = 21, M = `default_frames_per_slot(21)`
   = 6 frames a slot: two eval batches of 21 backbone steps, 5 labeled
   frames a slot a window, and 48 images of K = 1000 candidates into the
   NMS a batch (conf_threshold = 0). The eval runs once through the
   kernels (their launches counted), once through the plain versions,
   and once more through the kernels (timed only). The run fails unless
   (a) each batch's preds is within 2^-4 * max|plain| of the plain
   run's, (b) the NMS keep mask of the kernel on the kernel run's preds
   at 48 images equals the plain mask exactly, (c) every kernel launched
   exactly what the eval implies (21 steps a batch of a serve step's
   block and ConvLSTM launches, one `nms_mask` of 48 images a batch),
   and (d) the two runs' AP, AP_50 and AP_75 agree within 0.01
   (absolute). Reports host ms a batch (harvest, eval step ending in a
   synchronize, postprocess, the evaluator's bridging; the median over
   the batches after the first) and of `evaluate()`, frames/s = B L /
   step ms, the device-busy ms and idle share of one profiled eval step
   and its NMS, the host-clock time of the step's host-to-device copy of
   the folded window alone, the 48-image NMS's times, and the peak
   memory.

6. Train phases, after both paths. (d) One fp32 train step of an
   RVT-T-wide model at 64 x 96 (B 2, L 3, M 2; TF32 off) on the card
   and on the CPU from one seed's weights and one batch: the loss within
   1e-4 and each module's gradient norm within 1e-3, relative (the CPU
   step is held against `leod_tpu` by the CPU tests). Then (a)
   `Trainer.fit`, the port's third entry point: RVT-B Gen1 at full width
   and depth, B = `batch_size_train` = 8 (4 stream slots and 4
   random-access ones), L = 21, M = 6, remat "full", bf16 autocast over
   fp32 parameters, TRAIN_STEPS = 6 steps on 8 train sequences rendered
   in memory as the eval phase's (seed 0, with 8 val sequences after
   them), validating once, at the last step, through
   `run_streaming_eval` and the kernels. (b) It reports the host ms of
   every step (ending in a synchronize; the median of steps 2..N),
   frames/s = B L / step ms, the time the loop waited for the prefetch
   thread, the validation's seconds, the peak memory, the losses at
   every step, and one more step profiled (device busy ms, idle share
   against that step's host ms, the top device operations). (c) It
   fails unless every loss is finite, most parameters and BN running
   statistics changed, the carried states are finite, the steps
   launched no kernel and the validation launched every one, and
   `restore_latest` gives back the checkpoint's step.

7. Self-training phase, after the train phases: LEOD's cycle at RVT-B
   Gen1 full width and depth (B 8, L 21), on phase 6's rendered split
   with the WSOD label ratio ST_RATIO = 0.25 on the train sequences (so
   withheld GT exists; the val ones keep every label). Thresholds, the
   low ones of the JAX package's shard test: obj and class 0.01 per
   class, the postprocess's obj * cls confidence 0.005, tracklets
   shorter than 2 frames ignored. The teacher is phase 6's model
   (`Trainer.load_weights` of its checkpoint, `eval_detector()`): six
   warmup steps leave it at its initialization, every score at the
   YOLOX prior (about 0.0101 for obj and class, 1.0e-4 for their
   product), so no box passes; `perturb_teacher` sets its LayerScale
   from seed 0, as the serving phases do, and scales its obj and class
   prediction kernels so that each kind's logits have a standard
   deviation of 1 over the first train window (a trained detector's
   spread); both maxima are reported. Its checkpoint is written as the
   student's starting point.
   (a) `PseudoLabelRunner` with h-flip and t-flip over the 8 train
   sequences of 42 reprs: 2 passes x 2 batches of 16 slots x 21
   backbone steps, 336 images into the NMS a batch; once through the
   kernels (launches counted, timed), once through the plain versions.
   Fails unless each batch's preds are within 2^-4 * max|plain| of the
   plain run's, the box columns and the score columns each against
   their own largest plain value; the NMS keep mask of the kernel on the kernel run's
   preds (336 images, K = 1000 at conf 0) equals the plain one exactly;
   every kernel launched what the runs imply (21 steps a batch of a
   serve step's launches, one NMS a batch); the written dataset holds
   at least one pseudo box, one tracker-ignored box (the ignore label
   with the teacher's scores) and one inpainted box (the ignore label,
   zero scores); `verify_pseudo_dataset` passes on every sequence; and
   the kernel and plain runs' datasets agree: at least ST_MATCH_FRAC =
   90 % of either run's boxes matched one to one, greedily by IoU, at
   IoU >= 0.5 with the same class id (the ignore label a class of its
   own). (The bound allows for bf16 box coordinates, 2 px apart above
   256, and for boxes at a threshold whose flip the tracker carries on.)
   Reports frames/s = views x frames / wall s, host ms a batch
   (harvest, step, postprocess, routing), `save`'s seconds (aggregation,
   tracker, writer), the boxes by kind, the peak memory.
   (b) The soft student: `experiment_preset("gen1", "base", soft=True)`
   from the teacher's checkpoint, `Trainer.fit` for 4 steps on the
   pseudo split (`load_pseudo_sequences`) with `max_det_frames` = 21,
   validating once through the kernels. Fails unless every loss is
   finite, a box with the ignore label reached one of the steps (the
   labels of the batches fit harvested for its steps, read as fit
   harvests them), most parameters moved, and the validation launched
   every kernel. Reports step ms, wait ms, peak memory, and per step
   the ignore-labelled boxes and the other pseudo boxes under the soft
   head's per-class thresholds.
   (c) `run_tta_eval` of the student on the 8 val sequences with h-flip
   and t-flip, through the kernels and the plain versions: preds within
   2^-4 * max|plain| a batch (boxes and scores apart), the NMS mask exact (96 images), AP, AP_50
   and AP_75 within 0.01, the launches as implied; frames/s.
   (d) Online SSOD: `Trainer.fit` of RVT-B Gen1, B 8, L 21 from the
   teacher's checkpoint with `ssod_online` on (burn-in 1, thresholds
   0.01), 3 steps. Fails unless the losses are finite, the teacher moved
   by the EMA formula at every step on `head.obj_pred0.weight` (within
   1e-6 of its largest), pseudo boxes merged into every step after the
   burn-in and none before, and the teacher's eval launched a batch's
   kernels for every batch it labelled (at least one a step). Reports
   step ms, the wait for the prefetch thread that runs the teacher, the
   teacher's ms a batch and its update's ms.

8. CLI phase, after phase 7: the CLIs as users start them, through
   their `main` functions, at RVT-B Gen1 full width and depth (B 8,
   L 21). (a) `leod_tpu_torch.cli.selftrain_cycle` at a short schedule:
   its synthetic split (6 train and 4 val sequences of 64 reprs, labels
   every 2 from repr 11, the label files on disk and the frames in
   memory), CLI_TEACHER_STEPS = 4 WSOD teacher steps at ratio 0.25 with
   gradflow on and a panel every CLI_VIZ_EVERY = 2 steps (set by wrapping
   `cli.train.build_config`: no CLI flag sets them), the teacher's
   `cli.val`, 2 `cli.predict` shards with h-flip TTA, `cli.val_dst
   --verify`, CLI_STUDENT_STEPS = 2 soft-student steps and the student's
   `cli.val`. Fails unless every stage finished and wrote its outputs
   (checkpoints, eval and score JSON, the 6 pseudo sequences), the
   logged `gradflow/*` keys are exactly the JAX names of the model's
   parameters (`convert.jax_paths`), a panel's payload was built and
   postprocessed at steps 2 and 4 of the teacher and 2 of the student
   (and its PNG written where cv2 imports), and every block and
   ConvLSTM kernel launched a whole number of L-step windows' worth.
   Then the kernels at the cycle's own shapes: predict shard 0 runs
   again through the plain versions (`PseudoLabelRunner(plain=True)`),
   and its preds (6 slots x L frames a batch) must agree with the
   kernel run's batch by batch, box and score columns each within
   2^-4 * max|plain|; the NMS keep mask must be exact on every batch of
   the kernel run (6 x L images, K = 1000 at conf 0) and on each panel's
   image (at the panel's confidence and at conf 0). These comparisons'
   launches are made after the counts are read.
   (b) `cli.val --tta` of the student: finite AP, the kernels launched.
   (c) `cli.train --torch-weight` from a reference-layout Lightning
   checkpoint (`reference_state_dict` of a seed-7 model): after one
   step every parameter is within CLI_TORCH_WEIGHT_TOL = 1e-3 of that
   model's, and further from a seed-0 model's. Reports each stage's
   seconds, the AP, the pseudo score, the panels and the launches.

Prints the kernels' JSON line (each kernel wrapper of each path: its
RVT-B entry under its own name, its RVT-S entry as "<name>[RVT-S]";
an RVT-B entry's launches are the slice phase's, the eval phase's, the
train phase's validation's, the self-training phase's and the CLI
phase's),
the card's name and power limit, and the result JSON as the last line.
Any failure exits non-zero; so does a machine without a CUDA device, or
a directory without the package.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B = 8                       # serving slots
# the batches each kernel of a stage is held at alone: the serving slots,
# the cycle's pseudo-label batch (3 sequences doubled by h-flip, phase 8)
# and one stream; their plans differ
KERNEL_BATCHES = (B, 6, 1)
PEAK_BF16 = 989e12          # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12           # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s
KERNEL_TOL = 2.0 ** -5
SLICE_TOL = 2.0 ** -4
REPS = 20
PROFILE_STEPS = 10
# torch.profiler may lose a window's device events (seen with CUDA 12.8
# on an H100: a first profiling session that recorded no launch at all, a
# B = 1 window short of 7 events a step): a measurement is taken again
# when its events are incomplete, at most this many times in all
PROFILE_TRIES = 3
SWEEP_STEPS = 1 << 14
# the eval phase's rendered val split: EVAL_SEQS sequences of EVAL_REPRS
# Gen1 reprs (two windows of L = 21), labeled every EVAL_LABEL_EVERY from
# repr EVAL_FIRST_LABEL (5 frames a window); the kernel and plain runs'
# AP may differ by EVAL_AP_TOL (absolute) in AP, AP_50 and AP_75
EVAL_SEQS = 8
EVAL_REPRS = 42
EVAL_FIRST_LABEL = 3
EVAL_LABEL_EVERY = 4
EVAL_AP_TOL = 0.01
# the train phase: TRAIN_STEPS optimizer steps of RVT-B Gen1 at B 8, L 21,
# M 6 through `Trainer.fit`, validating once, at the last step; the
# rendered split holds TRAIN_SEQS train and as many val sequences, of
# EVAL_REPRS reprs labeled as the eval phase's
TRAIN_STEPS = 6
TRAIN_SEQS = 8
# the train check on the card against the CPU: one fp32 step of an
# RVT-T-wide model at 64 x 96, B 2, L 3, M 2, G 6 from one seed and batch;
# the loss within TRAIN_LOSS_RTOL and each module's grad norm within
# TRAIN_NORM_RTOL, relative
TRAIN_CHECK = dict(hw=(64, 96), partition=(2, 3), B=2, L=3, M=2, G=6)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_NORM_RTOL = 1e-3
# the self-training phase (7): WSOD label ratio of the train split; the
# pseudo-label thresholds (obj and class per class, the postprocess's
# obj * cls confidence, the tracker's shortest kept tracklet); the
# teacher's logit spread (`perturb_teacher`); the kernel and plain runs'
# pseudo datasets must match ST_MATCH_FRAC of either run's boxes one to
# one at IoU >= ST_MATCH_IOU with the same class; soft-student and
# online-SSOD steps; the EMA's relative tolerance on one checked leaf
ST_RATIO = 0.25
ST_OBJ = ST_CLS = 0.01
ST_CONF = 0.005
ST_MIN_TRACK = 2
ST_LOGIT_STD = 1.0
ST_MATCH_IOU = 0.5
ST_MATCH_FRAC = 0.9
STUDENT_STEPS = 4
SSOD_STEPS = 3
SSOD_EMA_RTOL = 1e-6
# the CLI phase (8): the cycle driver's teacher and student steps and the
# panel cadence; `cli.train --torch-weight` takes one step from a
# reference checkpoint, after which each parameter is within
# CLI_TORCH_WEIGHT_TOL of it (one AdamW step at the warmup learning rate)
CLI_TEACHER_STEPS = 4
CLI_STUDENT_STEPS = 2
CLI_VIZ_EVERY = 2
CLI_TORCH_WEIGHT_TOL = 1e-3

# One warp runs n dependent steps of the NMS sweep's chain, `sweep_tile`
# of csrc/nms.cu (row tile i mod 32; each step takes the keep word the
# one before left), on 32 rows in registers, between two reads of
# clock64 and %globaltimer: the latency of one word step, loads aside.
SWEEP_PROBE = r"""
#include "nms.cu"

__global__ void sweep_chain_kernel(int n, const uint32_t* rows,
                                   long long* out) {
  const int lane = threadIdx.x;
  uint32_t r[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) r[q] = rows[32 * q + lane];
  uint32_t kw = rows[32 * 32 + lane];
  unsigned long long t0, t1;
  __syncwarp();
  const long long c0 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int i = 0; i < n; ++i) kw = sweep_tile(kw, r, i & 31);
  asm volatile("" ::"r"(kw) : "memory");  // the chain ends before the clocks
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (lane == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(t1 - t0);
    out[2] = kw;
  }
}

// out: SM cycles, ns and the chain's last keep word, of a second launch
// on staircase rows (box q of every word suppresses box q + 1)
extern "C" int sweep_chain(int n, long long* out) {
  uint32_t h[33 * 32];
  for (int q = 0; q < 32; ++q)
    for (int l = 0; l < 32; ++l) h[32 * q + l] = q < 31 ? 2u << q : 0u;
  for (int l = 0; l < 32; ++l) h[32 * 32 + l] = ~0u;
  char* d = nullptr;
  cudaError_t e = cudaMalloc(&d, sizeof h + 3 * sizeof(long long));
  if (e != cudaSuccess) return e;
  long long* o = reinterpret_cast<long long*>(d + sizeof h);
  e = cudaMemcpy(d, h, sizeof h, cudaMemcpyHostToDevice);
  for (int r = 0; r < 2 && e == cudaSuccess; ++r)
    sweep_chain_kernel<<<1, 32>>>(n, reinterpret_cast<uint32_t*>(d), o);
  if (e == cudaSuccess)
    e = cudaMemcpy(out, o, 3 * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(d);
  return e != cudaSuccess ? e : cudaGetLastError();
}
"""


def port_kernels():
    """Names of the `__global__` kernels in leod_tpu_torch/csrc/*.cu."""
    names = set()
    for path in glob.glob(os.path.join(REPO, "leod_tpu_torch", "csrc",
                                       "*.cu")):
        with open(path) as f:
            names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                    r"\([^)]*\)\s*)?(\w+)", f.read()))
    return tuple(sorted(names))


def sweep_step_latency(lib_path: str):
    """(SM cycles, ns) of one word step of the NMS sweep's chain, from
    SWEEP_STEPS steps of the probe on the card."""
    import ctypes
    lib = ctypes.CDLL(lib_path)
    out = (ctypes.c_longlong * 3)()
    rc = lib.sweep_chain(ctypes.c_int(SWEEP_STEPS), out)
    if rc != 0:
        fail(f"the sweep-chain probe failed: CUDA error {rc}")
    return out[0] / SWEEP_STEPS, out[1] / SWEEP_STEPS


def device_us(fn, kernel: str, reps: int = REPS) -> float:
    """Mean device time of one launch of `kernel` in fn(), in us
    (torch.profiler over reps calls after warm-up; fn launches it once).
    A window that recorded another number of launches than reps is
    profiled again (PROFILE_TRIES)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and re.search(rf"\b{kernel}\b", e.name)]
        if len(times) == reps:
            return sum(times) / reps
    fail(f"profiled {len(times)} launches of {kernel}, not {reps}, "
         f"{PROFILE_TRIES} times")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median host time of fn() + synchronize, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def enqueue_us(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median host time of fn() alone, in us: what a call costs the host
    to launch, with the device idle at the start of each run."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak_ops: float):
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def compare(got, want, rel_tol: float):
    """(max |got - want|, tolerance, ok) for one tensor."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return float("inf"), 0.0, False
    err = float((got - want).abs().max())
    tol = rel_tol * float(want.abs().max())
    return err, tol, err <= tol


def compare_all(got, want, rel_tol: float):
    """compare() over one output or a tuple of them: the error and
    tolerance of the tensor nearest its tolerance, and whether all pass."""
    if not isinstance(got, tuple):
        return compare(got, want, rel_tol)
    errs = [compare(a, b, rel_tol) for a, b in zip(got, want)]
    err, tol, _ = max(errs, key=lambda e: e[0] / max(e[1], 1e-30))
    return err, tol, all(e[2] for e in errs)


# ---------------------------------------------------------------------------
# Work counts of the kernels (for the bound), from the modules' shapes
# ---------------------------------------------------------------------------

def _block_work(blk, n_tok: int):
    """(bf16 tensor-core FLOPs, weight bytes) of one PartitionAttention
    block over n_tok tokens: qkv, q k^T and p v, proj, the two MLP
    layers."""
    c = blk.dim
    t = blk.partition_size[0] * blk.partition_size[1]
    flops = 2 * n_tok * c * 3 * c + 2 * 2 * n_tok * t * c + 2 * n_tok * c * c
    flops += 2 * n_tok * c * blk.mlp.proj_in.out_features
    flops += 2 * n_tok * blk.mlp.proj_out.in_features * c
    wbytes = sum(p.numel() * p.element_size() for p in blk.parameters())
    return flops, wbytes


def mlp_work(blk, n_tok: int):
    """(bf16 tensor-core FLOPs, bytes) of the per-token half over n_tok
    tokens: the projection and both MLP layers; its weights and vectors,
    x and o read and the output written once, in bf16."""
    c = blk.dim
    flops = 2 * n_tok * c * c + 2 * n_tok * c * blk.mlp.proj_in.out_features
    flops += 2 * n_tok * blk.mlp.proj_out.in_features * c
    mods = [blk.attn.proj, blk.norm2, blk.mlp]
    wbytes = sum(p.numel() * p.element_size() for m in mods
                 for p in m.parameters())
    wbytes += sum(p.numel() * p.element_size() for p in (blk.ls1, blk.ls2)
                  if p is not None)
    return flops, wbytes + 3 * n_tok * c * 2


def attn_work(blk, n_tok: int):
    """(bf16 tensor-core FLOPs, bytes) of the attention half over n_tok
    tokens: q|k|v, q k^T and p v; x read and o written once in bf16, the
    q|k|v weights and LN1's vectors."""
    c = blk.dim
    t = blk.partition_size[0] * blk.partition_size[1]
    flops = 2 * n_tok * c * 3 * c + 4 * n_tok * t * c
    mods = [blk.attn.qkv] + ([] if blk.skip_first_norm else [blk.norm1])
    wbytes = sum(p.numel() * p.element_size() for m in mods
                 for p in m.parameters())
    return flops, wbytes + 2 * n_tok * c * 2


def lstm_work(gates, x, c_state):
    """(bf16 tensor-core FLOPs, bytes) of the ConvLSTM update: the
    [4C, 2C] gate mix over every token; x, h in and h' out in x's dtype,
    c in and c' out in c's dtype, the gate weights."""
    n_tok = x.shape[0] * x.shape[1] * x.shape[2]
    c = x.shape[-1]
    wbytes = sum(p.numel() * p.element_size() for p in gates.parameters())
    io = 3 * x.numel() * x.element_size() + 2 * c_state.numel() * \
        c_state.element_size()
    return 2 * n_tok * 2 * c * 4 * c, wbytes + io


def pair_work(pair, x):
    n_tok = x.shape[0] * x.shape[1] * x.shape[2]
    flops = wbytes = 0
    for blk in pair:
        f, w = _block_work(blk, n_tok)
        flops += f
        wbytes += w
    return flops, wbytes + 2 * x.numel() * x.element_size()


def stage_work(pairs, gates, x, c_state):
    flops = wbytes = 0
    for pair in pairs:
        f, w = pair_work(pair, x)
        flops += f
        wbytes += w - 2 * x.numel() * x.element_size()
    f, nbytes = lstm_work(gates, x, c_state)
    return flops + f, wbytes + nbytes


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build() -> str:
    """Build the port's sources and, beside them, the sweep-chain probe;
    returns the probe's library."""
    from leod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    probe = os.path.join(_build.BUILD_DIR, "sweep_chain.cu")
    with open(probe, "w") as f:
        f.write(SWEEP_PROBE)
    probe_lib = probe[:-3] + ".so"
    nvcc = subprocess.Popen(
        [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-I", _build.CSRC, "-o", probe_lib, probe],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    paths = _build.build_all()
    probe_log = nvcc.communicate(timeout=300)[0]
    if nvcc.returncode != 0:
        fail(f"nvcc failed for the sweep-chain probe:\n{probe_log}")
    dt = time.perf_counter() - t0
    for p in paths:
        with open(p + ".log") as f:
            report = [ln.strip() for ln in f if "spill" in ln
                      or ("ptxas info" in ln and ("Used" in ln
                                                  or "Compiling entry" in ln))]
        emit({"build": os.path.relpath(p, REPO), "ptxas": report})
    emit({"build_seconds": round(dt, 3)})
    return probe_lib


def perturb_layerscale(det, seed: int) -> None:
    """LayerScale at its init (1e-5) would make every attention block
    nearly the identity; seeded values in [0.1, 0.5] make the blocks'
    branches count in every comparison."""
    import torch
    from leod_tpu_torch.models.layers import PartitionAttention
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, PartitionAttention) and m.ls1 is not None:
                for p in (m.ls1, m.ls2):
                    p.copy_(torch.rand(p.shape, generator=g) * 0.4 + 0.1)


def stage_inputs(det, seed: int):
    """(stage, NHWC shape, x, h, c) at each stage's B-slot Gen1 shape:
    seeded bf16 input and warm non-zero (h, c)."""
    import torch
    bb = det.cfg.backbone
    h_in, w_in = bb.in_res_hw
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for k, (dim, stride) in enumerate(zip(bb.stage_dims, bb.stage_strides)):
        shape = (B, h_in // stride, w_in // stride, dim)
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        hs = (torch.randn(shape, device="cuda", generator=g) * 0.5
              ).to(torch.bfloat16)
        cs = (torch.randn(shape, device="cuda", generator=g) * 0.5
              ).to(torch.bfloat16)
        out.append((getattr(det.backbone, f"stage{k + 1}"), shape, x, hs, cs))
    return out


def phase_kernels(det):
    """Every kernel against its plain version at the model's stage shapes."""
    import torch
    from leod_tpu_torch.ops import maxvit_cuda as mc
    from leod_tpu_torch.models import layers as lay
    from leod_tpu_torch.ops import nms_cuda
    from leod_tpu_torch.ops.nms import nms_mask as nms_plain

    bb = det.cfg.backbone
    ps = bb.partition_size
    kw = dict(dim_head=bb.dim_head, act=bb.mlp_act, gated=bb.mlp_gated,
              eps=bb.norm_eps)
    g = torch.Generator(device="cuda").manual_seed(3)
    h_in, w_in = bb.in_res_hw
    rows = {"fused_block_pair": [], "fused_stage": [], "block_attention": [],
            "block_mlp": [], "lstm_update": []}

    def row(kern, plain, flops, nbytes, **extra):
        """One shape's entry: the kernel against its plain version."""
        err, tol, ok = compare_all(kern(), plain(), KERNEL_TOL)
        bms, by = bound(flops, nbytes, PEAK_BF16)
        return dict(extra, max_abs_err=err, tol=tol, ok=ok, ms=cuda_ms(kern),
                    plain_ms=cuda_ms(plain), host_us=enqueue_us(kern),
                    flops=flops, bytes=nbytes, bound_ms=bms, bound_by=by)

    for stage, shape, x, hs, cs in stage_inputs(det, seed=1):
        dim = shape[3]
        pairs = stage.pairs()
        wb, gb = pairs[0]

        n_tok = B * shape[1] * shape[2]
        rows["fused_block_pair"].append(row(
            lambda: mc.fused_block_pair(x, wb, gb, ps, True, **kw),
            lambda: mc.fused_block_pair_plain(x, wb, gb, ps),
            *pair_work(pairs[0], x), shape=list(shape)))

        o = torch.randn((n_tok, dim), device="cuda", generator=g
                        ).to(torch.bfloat16)
        # each half alone at each of KERNEL_BATCHES, whose plans differ:
        # the attention half, window block (LN1 skipped, as in a stage's
        # first pair) and grid block, on the NHWC map; the per-token half
        # on x and an attention output o as rows. "plan" is what the
        # launch took: (windows a CTA, CTAs a cluster), CTAs a row tile.
        for bsz in KERNEL_BATCHES:
            xb = x[:bsz]
            for blk, grid_kind in ((wb, False), (gb, True)):
                part, rev = ((lay.grid_partition, lay.grid_reverse)
                             if grid_kind
                             else (lay.window_partition, lay.window_reverse))

                def attn_p(xb=xb, blk=blk, part=part, rev=rev):
                    return rev(mc.block_attention_plain(part(xb, *ps), blk),
                               *ps, shape[1], shape[2])

                r = row(lambda xb=xb, blk=blk, grid_kind=grid_kind:
                        mc.block_attention(xb, blk, grid_kind, kw["eps"]),
                        attn_p, *attn_work(blk, xb.shape[0] * n_tok // B),
                        shape=list(xb.shape), batch=bsz,
                        kind="grid" if grid_kind else "window")
                r["plan"] = list(mc.block_attention.plan)
                rows["block_attention"].append(r)

            xr = xb.reshape(-1, dim)
            ob = o[:xr.shape[0]]
            r = row(lambda xr=xr, ob=ob: mc.block_mlp(
                        xr, ob, wb, kw["act"], kw["gated"], kw["eps"]),
                    lambda xr=xr, ob=ob: mc.block_mlp_plain(xr, ob, wb),
                    *mlp_work(wb, xr.shape[0]), shape=list(xr.shape),
                    batch=bsz)
            r["plan"] = mc.block_mlp.plan
            rows["block_mlp"].append(r)

        # the ConvLSTM update alone, from warm (h, c), at each of
        # KERNEL_BATCHES, whose plans differ: "plan" is (rows a tile,
        # channels a tile, CTAs a cluster splitting K)
        gates = stage.lstm.gates
        for bsz in KERNEL_BATCHES:
            xb, hb, cb = x[:bsz], hs[:bsz], cs[:bsz]
            r = row(lambda xb=xb, hb=hb, cb=cb: mc.lstm_update(xb, hb, cb,
                                                               gates),
                    lambda xb=xb, hb=hb, cb=cb: mc.lstm_update_plain(
                        xb, hb, cb, gates),
                    *lstm_work(gates, xb, cb), shape=list(xb.shape),
                    batch=bsz)
            r["plan"] = list(mc.lstm_update.plan)
            rows["lstm_update"].append(r)

        rows["fused_stage"].append(row(
            lambda: mc.fused_stage(x, hs, cs, pairs, gates, ps, True, **kw),
            lambda: mc.fused_stage_plain(x, hs, cs, pairs, gates, ps),
            *stage_work(pairs, gates, x, cs), shape=list(shape)))

    # K3: B images of K = 1000 score-sorted boxes, two classes, and the
    # staircases, whose chains run across every word of the sweep
    kk = det.cfg.postprocess.pre_nms_topk
    gc = torch.Generator().manual_seed(2)
    ctr = torch.rand(B, kk, 2, generator=gc) * torch.tensor([w_in, h_in])
    wh = torch.rand(B, kk, 2, generator=gc) * 70 + 6
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).cuda()
    valid = (torch.rand(B, kk, generator=gc) > 0.05).cuda()
    ids = torch.randint(0, 2, (B, kk), generator=gc).float().cuda()
    thr = det.cfg.postprocess.nms_threshold
    inputs = {"random": (boxes, valid, ids), "staircase": staircases(B, kk)}

    def nms_k():
        return nms_cuda.nms_mask(boxes, thr, valid, ids)

    def nms_p():
        return nms_plain(boxes, thr, valid, ids)

    mismatches, kept, device = 0, {}, {}
    for name, (bx, va, cl) in inputs.items():
        keep_k, keep_p = (nms_cuda.nms_mask(bx, thr, va, cl),
                          nms_plain(bx, thr, va, cl))
        torch.cuda.synchronize()
        mismatches += int((keep_k != keep_p).sum())
        kept[name] = int(keep_p.sum())

        def call(bx=bx, va=va, cl=cl):
            return nms_cuda.nms_mask(bx, thr, va, cl)

        device[name] = {k: device_us(call, f"nms_{k}_kernel")
                        for k in ("build", "sweep")}
    # per image: K (K-1) / 2 IoU tests of ~13 fp32 operations each
    ops = B * kk * (kk - 1) / 2 * 13
    nbytes = B * kk * (16 + 1 + 4 + 1)
    bms, by = bound(ops, nbytes, PEAK_FP32)
    # each kernel alone: nms_build_kernel does the IoU tests, reads the
    # boxes and class ids and writes the mask words on and above the
    # diagonal; nms_sweep_kernel reads those and valid and writes keep,
    # its bound (its design's latency floor is the variant phase's)
    words = (kk + 31) // 32
    mask_bytes = B * 4 * sum(min(32, kk - 32 * t) * (words - t)
                             for t in range(words))
    build_ms, build_by = bound(ops, B * kk * (16 + 4) + mask_bytes, PEAK_FP32)
    sweep_ms = (mask_bytes + 2 * B * kk) / PEAK_BYTES * 1e3
    nms_row = dict(shape=[B, kk, 4], max_abs_err=float(mismatches), tol=0.0,
                   ok=mismatches == 0, kept=kept, device_us=device,
                   ms=cuda_ms(nms_k), plain_ms=cuda_ms(nms_p), flops=ops,
                   bytes=nbytes, bound_ms=bms, bound_by=by,
                   build_bound_ms=build_ms, build_bound_by=build_by,
                   sweep_bound_ms=sweep_ms, sweep_bound_by="bytes")
    return rows, nms_row


def staircases(b: int, k: int):
    """(boxes, valid, class ids) on the card: b images of k boxes 10 wide
    in a staircase, box i 3 to the right of box i - 1, so that box i
    overlaps box i + 1 above the threshold (IoU 7/13) and no other, and
    kept and suppressed boxes alternate across every 32-box word. Image n
    starts its staircase at box n (the boxes before lie apart), makes box
    32 n + 16 invalid, and from image 4 on changes class every 31 + n
    boxes: either suppresses nothing, and where it falls on a box that
    would have been kept, turns the alternation over for the rest of the
    chain."""
    import torch
    i = torch.arange(k, dtype=torch.float32)
    boxes, valid, ids = [], [], []
    for n in range(b):
        apart = i < n
        x0 = torch.where(apart, 20 * i, 3 * i)
        y0 = torch.where(apart, torch.full_like(i, 500.0), torch.zeros_like(i))
        boxes.append(torch.stack([x0, y0, x0 + 10, y0 + 10], -1))
        valid.append(torch.arange(k) != (32 * n + 16) % k)
        ids.append(((torch.arange(k) // (31 + n)) % 2).float() if n >= 4
                   else torch.zeros(k))
    return (torch.stack(boxes).cuda(), torch.stack(valid).cuda(),
            torch.stack(ids).cuda())


def phase_variants(det, probe_lib: str):
    """Measures of the kernels' plans and variants, off the serve path.
    `lstm_update` at each stage shape by its plan (cluster None) and with
    every cluster size its K chunks take, forced: the device time of a
    launch, the evidence for the plan's rule of splitting; and with c in
    fp32, the kernel's accurate gates for c' ("c_rel_err" is
    |c' - plain| / max|plain|). Each against its plain version. Then the
    NMS sweep's design latency floor (not a bound of the function): its
    ceil(K/32) word steps are a dependent chain, at the latency a step
    takes in the probe on this card."""
    from leod_tpu_torch.ops import maxvit_cuda as mc

    clusters, c_fp32 = [], []
    for stage, shape, x, hs, cs in stage_inputs(det, seed=1):
        gates, dim = stage.lstm.gates, shape[3]
        for bsz in (B, 1):
            xb, hb, cb = x[:bsz], hs[:bsz], cs[:bsz]
            want = mc.lstm_update_plain(xb, hb, cb, gates)
            for cl in (None, 1, 2, 4, 8):
                if cl is not None and cl > max(2, 2 * dim // 64):
                    continue

                def kern(xb=xb, hb=hb, cb=cb, cl=cl):
                    return mc.lstm_update(xb, hb, cb, gates, cluster=cl)

                err, tol, ok = compare_all(kern(), want, KERNEL_TOL)
                clusters.append(dict(
                    shape=list(xb.shape), cluster=cl,
                    plan=list(mc.lstm_update.plan),
                    device_us=device_us(kern, "lstm_update_kernel"),
                    max_abs_err=err, tol=tol, ok=ok))
        cf = cs.float()

        def kern_f(x=x, hs=hs, cf=cf, gates=gates):
            return mc.lstm_update(x, hs, cf, gates)

        got, want = kern_f(), mc.lstm_update_plain(x, hs, cf, gates)
        err, tol, ok = compare_all(got, want, KERNEL_TOL)
        c_fp32.append(dict(
            shape=list(x.shape), device_us=device_us(kern_f,
                                                     "lstm_update_kernel"),
            max_abs_err=err, tol=tol, ok=ok,
            c_rel_err=float((got[1] - want[1]).abs().max()
                            / want[1].abs().max())))
    words = (det.cfg.postprocess.pre_nms_topk + 31) // 32
    step_cycles, step_ns = sweep_step_latency(probe_lib)
    return {"lstm_update_clusters": clusters, "lstm_update_c_fp32": c_fp32,
            "sweep_step_cycles": step_cycles, "sweep_step_ns": step_ns,
            "sweep_chain_floor_cycles": words * step_cycles,
            "sweep_chain_floor_ms": words * step_ns * 1e-6}


def _summary(name, replaces, source, shape_rows, launches, peak_ops):
    """One kernel's entry: times, work and bound summed over the shapes
    one B-slot serve step gives it (the rows at batch B, where a kernel
    was also run at B = 1); the worst error relative to its tolerance
    over every row."""
    worst = max(shape_rows, key=lambda r: r["max_abs_err"] / max(r["tol"],
                                                                 1e-30))
    step_rows = [r for r in shape_rows if r.get("batch", B) == B]
    tot = {k: sum(r[k] for r in step_rows)
           for k in ("ms", "plain_ms", "flops", "bytes")}
    bms, by = bound(tot["flops"], tot["bytes"], peak_ops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": worst["max_abs_err"], "tol": worst["tol"],
            "ms": tot["ms"], "kernel_ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": bms,
            "bound_by": by, "flops": tot["flops"], "bytes": tot["bytes"],
            "library_ms": None, "ok": all(r["ok"] for r in shape_rows),
            "per_shape": shape_rows}


def frames(rng, n, shape):
    """Sparse uint8 event-count frames (Poisson, mean 0.3 per bin)."""
    import numpy as np
    return [np.minimum(rng.poisson(0.3, shape), 255).astype(np.uint8)
            for _ in range(n)]


def launches_per_step(cfg):
    """Each wrapper's launches in one serve step of the model: the
    backbone's per timestep, and one NMS."""
    n_pairs = sum(cfg.model.backbone.num_blocks)
    n_stages = len(cfg.model.backbone.num_blocks)
    return {"fused_block_pair": n_pairs, "fused_stage": n_stages,
            "block_attention": 2 * n_pairs, "block_mlp": 2 * n_pairs,
            "lstm_update": n_stages, "nms_mask": 1}


def phase_slice(det, cfg):
    import numpy as np
    import torch
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.serve import (ServingEngine, make_serve_step,
                                      serve_input_shape)

    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    per_step = launches_per_step(cfg)
    shape = serve_input_shape(cfg, B)[1:]
    step = make_serve_step(det, conf_threshold=0.0)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    # warm up (cuDNN picks its algorithms) before counting
    step(det.init_states(B), torch.from_numpy(np.stack(
        frames(rng, B, shape))).to(dev), ones, ones)
    torch.cuda.synchronize()
    engine = ServingEngine(step, det.init_states(B), shape, device="cuda")
    answers, errors = [], []

    def client(sid, n, seed):
        try:
            for fr in frames(np.random.default_rng(seed), n, shape):
                answers.append((sid, engine.detect(sid, fr, timeout=300)))
        except Exception as e:  # reported below, fails the run
            errors.append(f"{sid}: {e!r}")

    def run_clients(specs):
        ts = [threading.Thread(target=client, args=s) for s in specs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        if any(t.is_alive() for t in ts):
            fail("a client thread did not finish")

    for w in wrappers:
        w.launches = 0
    run_clients([(f"s{i}", 4, i) for i in range(3)])     # 3 streams x 4
    run_clients([(f"s{i}", 1, i) for i in range(3, 8)])  # 8 resident
    run_clients([("s8", 1, 8)])                          # evicts the LRU one
    launches = {w.__name__: w.launches for w in wrappers}
    stats = engine.stats()
    engine.close()
    if errors:
        fail(f"requests failed: {errors}")
    steps = stats["steps"]
    for name, per in per_step.items():
        if launches[name] != per * steps or launches[name] == 0:
            fail(f"{name} launched {launches[name]} times in {steps} steps; "
                 f"the path implies {per} a step")
    if len(answers) != 3 * 4 + 5 + 1 or stats["streams"] != B:
        fail(f"{len(answers)} answers, {stats['streams']} resident streams")
    for sid, a in answers:
        if a.ndim != 2 or a.shape[1] != 7 or not np.isfinite(a).all() \
                or a.shape[0] > cfg.model.postprocess.max_dets:
            fail(f"answer for {sid}: shape {a.shape}, finite "
                 f"{np.isfinite(a).all()}")

    # one step through the plain versions against the kernel step, from
    # warm states, with some rows reset and some idle
    states = det.init_states(B)
    for fr in (frames(rng, B, shape), frames(rng, B, shape)):
        ev = torch.from_numpy(np.stack(fr)).to(dev)
        states, _, _ = step(states, ev, ones, ones)
    ev = torch.from_numpy(np.stack(frames(rng, B, shape))).to(dev)
    reset = torch.tensor([i % 4 == 0 for i in range(B)], device=dev)
    active = torch.tensor([i % 3 != 2 for i in range(B)], device=dev)
    from leod_tpu_torch.models.backbone import reset_states
    st0 = reset_states(states, reset)
    parity = {}
    # at B and at B = 1 (the last row, warm), where the kernels' plans
    # differ: clusters over heads and hidden chunks where windows and
    # row tiles are few
    for sl, tag in ((slice(0, B), ""), (slice(B - 1, B), "b1_")):
        st_b = [(h[sl], c[sl]) for h, c in st0]
        out = {}
        for plain in (False, True):
            feats, new = det.forward_backbone(ev[sl], st_b, plain=plain)
            preds, _ = det.forward_detect(feats)
            out[plain] = (new, preds)
        torch.cuda.synchronize()
        pairs = [(f"h{k + 1}", a[0], b[0]) for k, (a, b)
                 in enumerate(zip(out[False][0], out[True][0]))]
        pairs += [(f"c{k + 1}", a[1], b[1]) for k, (a, b)
                  in enumerate(zip(out[False][0], out[True][0]))]
        pk, pp = out[False][1], out[True][1]
        pairs += [("pred_xy", pk[..., :2], pp[..., :2]),
                  ("pred_wh", pk[..., 2:4], pp[..., 2:4]),
                  ("pred_scores", pk[..., 4:], pp[..., 4:])]
        for name, a, b in pairs:
            err, tol, ok = compare(a, b, SLICE_TOL)
            parity[tag + name] = [err, tol]
            if not ok:
                fail(f"slice parity {tag + name}: |kernel - plain| {err} > "
                     f"{tol}")
    k_step = step(st0, ev, reset, active)
    plain_step = make_serve_step(det, conf_threshold=0.0, plain=True)
    p_step = plain_step(st0, ev, reset, active)
    for (hk, ck), (hp, cp) in zip(k_step[0], p_step[0]):
        for a, b in ((hk, hp), (ck, cp)):
            err, tol, ok = compare(a, b, SLICE_TOL)
            if not ok:
                fail(f"serve-step state parity: {err} > {tol}")
    idle = ~active
    for (h0, c0), (hk, ck) in zip(st0, k_step[0]):
        if not (torch.equal(hk[idle], h0[idle].to(hk.dtype))
                and torch.equal(ck[idle], c0[idle].to(ck.dtype))):
            fail("an idle row's state changed in the step")
    if bool(k_step[2][idle].any()):
        fail("an idle row returned valid detections")

    timing = {}
    for bsz in (1, B):
        st = det.init_states(bsz)
        evb = torch.from_numpy(np.stack(frames(rng, bsz, shape))).to(dev)
        flags = torch.ones(bsz, dtype=torch.bool, device=dev)
        timing[f"step_ms_b{bsz}"] = host_ms(
            lambda: step(st, evb, flags, flags))
    evb = torch.from_numpy(np.stack(frames(rng, B, shape))).to(dev)
    flags = torch.ones(B, dtype=torch.bool, device=dev)
    st = det.init_states(B)
    timing[f"plain_step_ms_b{B}"] = host_ms(
        lambda: plain_step(st, evb, flags, flags), reps=10)
    return launches, steps, stats, parity, timing


def _busy_us(spans) -> float:
    """Length of the union of [start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        s = max(s, end)
        if e > s:
            busy += e - s
        end = max(end, e)
    return busy


def profile_calls(fn, calls: int, what: str):
    """(device events, tries) of `calls` calls of fn() under
    torch.profiler, after a synchronize. A window whose port-kernel events
    fall short of the launches the wrappers counted in it (one a call;
    two, build and sweep, a `nms_mask` call) lost events and is profiled
    again (PROFILE_TRIES)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    kernels = port_kernels()
    if not kernels:
        fail("found no __global__ kernel in leod_tpu_torch/csrc/")
    kernels_a_call = [(w, 1) for w in (maxvit_cuda.block_attention,
                                       maxvit_cuda.block_mlp,
                                       maxvit_cuda.lstm_update)]
    kernels_a_call.append((nms_cuda.nms_mask, 2))
    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        before = sum(w.launches * n for w, n in kernels_a_call)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = sum(w.launches * n for w, n in kernels_a_call) - before
        # device work only: a user annotation (the optimizer's step) is
        # laid on the device timeline too, as one span over its kernels
        # and the gaps between them
        dev_events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)]
        seen = sum(1 for e in dev_events if any(
            re.search(rf"\b{k}\b", e.name) for k in kernels))
        if seen == launched:
            return dev_events, tries
    fail(f"the profiled {what} recorded {seen} port-kernel launches of "
         f"{launched}, {PROFILE_TRIES} times")


def device_summary(dev_events, calls: int, host_ms: float, what: str,
                   kernels_expected: bool = True):
    """Where the device time of `calls` profiled calls went, a call: the
    device-busy time (the union of the events' intervals), its idle share
    against the unprofiled host time of a call, the port's kernels by
    name and by instantiation, and the largest events. Every port kernel
    must show up, unless `kernels_expected` is false (a train step, which
    runs the module forwards)."""
    kernels = port_kernels()
    by_name = {}
    for e in dev_events:
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += e.time_range.elapsed_us()
        tot[1] += 1
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev_events]) / 1e3 / calls
    # a kernel's profiler name is its signature, e.g.
    # "void (anonymous namespace)::block_mlp_kernel<512>(...)"
    per_kernel = {k: sum(v[0] for n, v in by_name.items()
                         if re.search(rf"\b{k}\b", n))
                  for k in kernels}
    missing = [k for k in kernels if not any(
        re.search(rf"\b{k}\b", n) for n in by_name)]
    if missing and kernels_expected:
        fail(f"port kernels absent from the profiled {what}: {missing}")
    # and by instantiation, e.g. block_attention_kernel<64>: by width
    by_inst = {}
    for n, v in by_name.items():
        m = re.search(r"\b(\w+(?:<[^>()]*>)?)\(", n)
        if m and m.group(1).split("<")[0] in kernels:
            by_inst[m.group(1)] = by_inst.get(m.group(1), 0.0) + v[0]
    port_ms = sum(per_kernel.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "device_busy_ms_per_step": busy_ms if dev_events else None,
        "idle_share": 1 - busy_ms / host_ms if dev_events else None,
        "port_kernels_ms_per_step": port_ms / calls,
        "port_kernel_ms_per_step": {
            k: v / 1e3 / calls for k, v in per_kernel.items()},
        "port_kernel_instances_ms_per_step": {
            k: v / 1e3 / calls for k, v in sorted(by_inst.items())},
        "device_events_per_step": len(dev_events) / calls,
        "top": [{"name": n[:90], "ms_per_step": v[0] / 1e3 / calls,
                 "per_step": v[1] / calls} for n, v in top]}


def phase_profile(det, cfg, timing):
    """Where a serve step's time goes: torch.profiler over PROFILE_STEPS
    steps at B = 1 and B. The device-busy time per step is the union of
    the device events' intervals; the idle share is measured against the
    unprofiled step time of the slice phase."""
    import numpy as np
    import torch
    from leod_tpu_torch.serve import make_serve_step, serve_input_shape

    step = make_serve_step(det, conf_threshold=0.0)
    shape = serve_input_shape(cfg, 1)[1:]
    rng = np.random.default_rng(5)
    out = {}
    for bsz in (1, B):
        st = det.init_states(bsz)
        ev = torch.from_numpy(np.stack(frames(rng, bsz, shape))).cuda()
        flags = torch.ones(bsz, dtype=torch.bool, device="cuda")
        for _ in range(3):
            step(st, ev, flags, flags)
        dev_events, tries = profile_calls(
            lambda: step(st, ev, flags, flags), PROFILE_STEPS,
            f"B = {bsz} steps")
        step_ms = timing[f"step_ms_b{bsz}"]
        out[f"b{bsz}"] = {"step_ms": step_ms, "profile_tries": tries,
                          **device_summary(dev_events, PROFILE_STEPS, step_ms,
                                           f"B = {bsz} steps")}
    return out


def _eval_preds_store(store):
    """run_streaming_eval's on_batch hook that keeps each batch's preds."""
    def on_batch(bi, hb, preds, dets, valid):
        store.append((preds.detach().clone(), hb["num_frames"],
                      int(valid.sum())))
    return on_batch


def phase_eval(det, cfg):
    """Streaming evaluation of a rendered val split through
    `run_streaming_eval`: with the kernels (launches counted), with the
    plain versions, and with the kernels again (timed only); the 48-image
    NMS keep mask against the plain one on the kernel run's preds; one
    eval step profiled."""
    import torch
    from leod_tpu_torch.config import stem_fold_hw
    from leod_tpu_torch.data.loader import EvalStreamLoader, harvest_frames
    from leod_tpu_torch.data.synthetic import render_array_sequences
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.ops.nms import nms_candidates, postprocess
    from leod_tpu_torch.ops.nms import nms_mask as nms_plain
    from leod_tpu_torch.train.step import make_eval_step
    from leod_tpu_torch.train.trainer import (default_frames_per_slot,
                                              run_streaming_eval)

    dst, pp = cfg.dataset, cfg.model.postprocess
    L, bv = dst.sequence_length, cfg.training.batch_size_eval
    m_slot = default_frames_per_slot(L)
    n_cls = cfg.model.head.num_classes
    t0 = time.perf_counter()
    seqs = render_array_sequences(
        dst, EVAL_SEQS, seed=0, num_reprs=EVAL_REPRS, hw=dst.resolution_hw,
        first_label_repr=EVAL_FIRST_LABEL, label_every=EVAL_LABEL_EVERY)
    render_s = time.perf_counter() - t0
    kw = dict(sequences=seqs, batch_size=bv, conf_threshold=0.0)
    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern, timings = [], {}
    for w in wrappers:
        w.launches = 0
    ap_kernel = run_streaming_eval(det, cfg, on_batch=_eval_preds_store(kern),
                                   timings=timings, **kw)
    launches = {w.__name__: w.launches for w in wrappers}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    plain = []
    ap_plain = run_streaming_eval(det, cfg, plain=True,
                                  on_batch=_eval_preds_store(plain), **kw)
    warm = {}
    run_streaming_eval(det, cfg, timings=warm, **kw)
    print(f"eval kernel AP {ap_kernel}", flush=True)
    print(f"eval plain AP {ap_plain}", flush=True)

    n_batches = len(kern)
    if n_batches != EVAL_SEQS * EVAL_REPRS // (L * bv) or len(plain) != \
            n_batches:
        fail(f"the eval ran {n_batches} batches with labeled frames "
             f"(plain: {len(plain)})")
    # (c) every kernel launched what the eval implies: a serve step's
    # backbone launches a timestep, one NMS a batch
    want = {k: v * L * n_batches for k, v in launches_per_step(cfg).items()}
    want["nms_mask"] = n_batches
    if launches != want:
        fail(f"eval launches {launches}; the eval implies {want}")
    # (a) each batch's preds within the slice tolerance of the plain step's
    parity = []
    for (pk, nk, _), (pl, npl, _) in zip(kern, plain):
        if pk.shape != (bv * m_slot,) + tuple(pl.shape[1:]) or nk != npl:
            fail(f"eval preds {tuple(pk.shape)} ({nk} frames) against plain "
                 f"{tuple(pl.shape)} ({npl} frames)")
        err, tol, ok = compare(pk, pl, SLICE_TOL)
        parts = {name: compare(pk[..., sl], pl[..., sl], SLICE_TOL)[:2]
                 for name, sl in (("xy", slice(0, 2)), ("wh", slice(2, 4)),
                                  ("scores", slice(4, None)))}
        parity.append({"preds": [err, tol], **parts})
        if not ok:
            fail(f"eval preds: |kernel - plain| {err} > {tol}")
    # (b) the NMS keep mask at the eval's B M images, exact
    thr = pp.nms_threshold
    mismatches, kept, nms = 0, 0, {}
    for pk, _, _ in kern:
        bx, va, ids, _, _ = nms_candidates(pk, n_cls, 0.0, pp.pre_nms_topk)
        keep_k = nms_cuda.nms_mask(bx, thr, va, ids)
        keep_p = nms_plain(bx, thr, va, ids)
        mismatches += int((keep_k != keep_p).sum())
        kept += int(keep_p.sum())
    if mismatches:
        fail(f"the eval's NMS keep mask differs from the plain one in "
             f"{mismatches} boxes")
    nb, nk_ = bx.shape[:2]

    def nms_k():
        return nms_cuda.nms_mask(bx, thr, va, ids)

    nms["images"], nms["k"] = nb, nk_
    nms["ms"] = cuda_ms(nms_k)
    nms["plain_ms"] = cuda_ms(lambda: nms_plain(bx, thr, va, ids), reps=5)
    nms["device_us"] = {k: device_us(nms_k, f"nms_{k}_kernel")
                        for k in ("build", "sweep")}
    ops = nb * nk_ * (nk_ - 1) / 2 * 13
    nms["bound_ms"], nms["bound_by"] = bound(ops, nb * nk_ * (16 + 1 + 4 + 1),
                                             PEAK_FP32)
    # (d) the two AP dicts agree
    ap_diff = {k: abs(ap_kernel[k] - ap_plain[k])
               for k in ("AP", "AP_50", "AP_75")}
    if not all(d <= EVAL_AP_TOL for d in ap_diff.values()):
        fail(f"eval AP with the kernels {ap_kernel} against plain "
             f"{ap_plain}: {ap_diff}")

    # host ms a batch: the counted run's batches after its first, and the
    # warm run's
    def med(key):
        return statistics.median(timings[key][1:] + warm[key])

    per_batch = {k: med(k) for k in ("harvest_ms", "step_ms",
                                     "postprocess_ms", "bridge_ms")}
    evaluate_ms = [timings["evaluate_ms"], warm["evaluate_ms"]]

    # one eval step and its NMS profiled, on the first batch harvested
    # anew; the idle share is against their host ms in the runs above
    loader = EvalStreamLoader(seqs, dst, bv)
    hb = harvest_frames(next(iter(loader)), m_slot, cfg.model.head.max_gt,
                        cfg.model.backbone.in_res_hw,
                        fold_hw=stem_fold_hw(cfg.model))
    step = make_eval_step(det)
    st = det.init_states(bv)

    def step_and_nms():
        postprocess(step(st, hb)[1], num_classes=n_cls, conf_threshold=0.0,
                    nms_threshold=thr, pre_topk=pp.pre_nms_topk,
                    max_dets=pp.max_dets)

    step_and_nms()
    dev_events, tries = profile_calls(step_and_nms, 1, "eval step")
    profile = {"profile_tries": tries, **device_summary(
        dev_events, 1, per_batch["step_ms"] + per_batch["postprocess_ms"],
        "eval step")}
    # the window's host-to-device copy: what the trace holds of it, and
    # the copy alone by the host clock (the step makes it from pageable
    # memory)
    profile["memcpy_ms_per_step"] = sum(
        e.time_range.elapsed_us() for e in dev_events
        if "memcpy" in e.name.lower()) / 1e3
    profile["window_bytes"] = hb["ev"].nbytes
    profile["window_h2d_ms"] = host_ms(
        lambda: torch.from_numpy(hb["ev"]).to("cuda"), reps=5, warmup=1)
    return {
        "sequences": EVAL_SEQS, "reprs": EVAL_REPRS, "render_s": render_s,
        "batch": bv, "window": L, "frames_per_slot": m_slot,
        "batches": n_batches, "frames": sum(n for _, n, _ in kern),
        "kept_dets": sum(k for _, _, k in kern),
        "launches": launches, "parity": parity,
        "nms_b48": dict(nms, mismatches=mismatches, kept=kept),
        "ap_kernel": {k: ap_kernel[k] for k in ("AP", "AP_50", "AP_75")},
        "ap_plain": {k: ap_plain[k] for k in ("AP", "AP_50", "AP_75")},
        "ap_abs_diff": ap_diff,
        "host_ms_per_batch": per_batch, "evaluate_ms": evaluate_ms,
        "batch_ms": sum(per_batch.values()),
        "frames_per_s": bv * L / per_batch["step_ms"] * 1e3,
        "step": profile, "peak_mem_gib": peak_gib}


# ---------------------------------------------------------------------------
# Train phase
# ---------------------------------------------------------------------------

def _train_batch(rng, cfg, b: int, L: int, m: int, g: int):
    """A harvested-shape train batch: a prefolded uint8 window, up to g
    boxes on each of m frames a slot, the last slot's last frame padded."""
    import numpy as np
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
    mask = np.ones((b, m), bool)
    mask[-1, -1] = False
    labels[~mask] = 0.0
    return {"ev": np.minimum(rng.poisson(1.5, (L, b, h // 4, w // 4, 16 * c)),
                             255).astype(np.uint8),
            "is_first": np.ones(b, bool),
            "frame_t": np.tile(np.linspace(0, L - 1, m).astype(np.int32),
                               (b, 1)),
            "frame_mask": mask, "labels": labels}


def phase_train_parity():
    """(d) One fp32 train step of a small model on the card and on the
    CPU, from one seed's weights and one batch, TF32 off: the loss and
    each module's gradient norm."""
    from dataclasses import replace
    import numpy as np
    import torch
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.train.optim import make_optimizer
    from leod_tpu_torch.train.step import TrainState, make_train_step

    tc = TRAIN_CHECK
    cfg = experiment_preset("gen1", "tiny")
    bb = replace(cfg.model.backbone, in_res_hw=tc["hw"],
                 partition_size=tc["partition"])
    cfg = replace(cfg, model=replace(cfg.model, backbone=bb))
    batch = _train_batch(np.random.default_rng(3), cfg, tc["B"], tc["L"],
                         tc["M"], tc["G"])
    out = {}
    for dev in ("cpu", "cuda"):
        det = Detector(cfg.model, dtype=torch.float32, device=dev, seed=0,
                       trainable=True)
        opt, _ = make_optimizer(cfg.training, det.parameters())
        _, m = make_train_step(det, opt)(
            TrainState(states=det.init_states(tc["B"]), step=0), batch)
        out[dev] = {k: float(v) for k, v in m.items()}
    rel = {k: abs(out["cuda"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]),
                                                        1e-30)
           for k in out["cpu"]}
    checks = {"loss": TRAIN_LOSS_RTOL, **{
        f"grad_norm/{mod}": TRAIN_NORM_RTOL
        for mod in ("backbone", "fpn", "head")}}
    bad = {k: (out["cuda"][k], out["cpu"][k]) for k, tol in checks.items()
           if not rel[k] <= tol}
    if bad or not all(np.isfinite(v) for v in out["cuda"].values()):
        fail(f"the fp32 train step on the card disagrees with the CPU's: "
             f"{bad} (card, CPU)")
    return {"config": f"RVT-T widths at {tc['hw']}, B {tc['B']}, "
                      f"L {tc['L']}, M {tc['M']}, fp32, TF32 off",
            "card": out["cuda"], "cpu": out["cpu"], "rel_diff": rel,
            "tolerances": checks}


def phase_train():
    """(a) `Trainer.fit` for TRAIN_STEPS bf16 steps of RVT-B Gen1 at its
    full width and depth (B 8, L 21, M 6, remat "full") on a rendered
    train split, validating once through `run_streaming_eval` and the
    kernels; (b) its step times, frames/s, peak memory, losses and one
    profiled step; (c) its checks."""
    import shutil
    from dataclasses import replace
    import numpy as np
    import torch
    from leod_tpu_torch.config import experiment_preset, stem_fold_hw
    from leod_tpu_torch.data.loader import harvest_frames
    from leod_tpu_torch.data.synthetic import render_array_dataset
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.train.step import make_train_step
    from leod_tpu_torch.train.trainer import Trainer, default_frames_per_slot

    cfg = experiment_preset("gen1", "base")
    dst = cfg.dataset
    L, bt = dst.sequence_length, cfg.training.batch_size_train
    run_root = os.path.join(REPO, "runs", "chip_smoke_train")
    shutil.rmtree(run_root, ignore_errors=True)
    cfg = replace(cfg, save_dir=run_root, exp_name="rvt_b_gen1",
                  training=replace(cfg.training,
                                   val_check_interval=TRAIN_STEPS))
    t0 = time.perf_counter()
    splits = render_array_dataset(
        dst, TRAIN_SEQS, TRAIN_SEQS, 0, seed=0, num_reprs=EVAL_REPRS,
        hw=dst.resolution_hw, first_label_repr=EVAL_FIRST_LABEL,
        label_every=EVAL_LABEL_EVERY)
    render_s = time.perf_counter() - t0

    trainer = Trainer(cfg)                        # bf16 compute, on the card
    state = trainer.init_state(bt)
    if any(p.dtype != torch.float32 for p in trainer.det.parameters()):
        fail("the trainable model's parameters are not fp32")
    params0 = [p.detach().clone() for p in trainer.det.parameters()]
    stats0 = [b.detach().clone() for part in trainer.det.batch_stats().values()
              for b in part.values()]
    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    records, before_val = [], {}

    def sink(rec):
        records.append(rec)
        if rec.get("step") == TRAIN_STEPS and "loss" in rec:
            before_val.update({w.__name__: w.launches for w in wrappers})

    trainer.logger.add_sink(sink)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    state = trainer.fit(max_steps=TRAIN_STEPS, state=state, log_every=1,
                        sequences=splits["train"],
                        val_sequences=splits["val"], timings=timings)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # (c) the checks
    steps = [r for r in records if "loss" in r]
    vals = [r for r in records if "val/AP" in r]
    keys = ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg",
            "grad_norm")
    if state.step != TRAIN_STEPS or len(steps) != TRAIN_STEPS or \
            len(vals) != 1:
        fail(f"fit took {state.step} steps, logged {len(steps)} and "
             f"validated {len(vals)} times")
    if not all(np.isfinite(r[k]) for r in steps for k in keys):
        fail(f"a train loss is not finite: {steps}")
    moved = sum(not torch.equal(a, b)
                for a, b in zip(params0, trainer.det.parameters()))
    stats = [b for part in trainer.det.batch_stats().values()
             for b in part.values()]
    stats_moved = sum(not torch.equal(a, b) for a, b in zip(stats0, stats))
    n_params = len(params0)
    if moved < n_params // 2 or stats_moved < len(stats) // 2:
        fail(f"{moved} of {n_params} parameters and {stats_moved} of "
             f"{len(stats)} BN statistics changed")
    if not all(bool(t.isfinite().all()) for s_ in state.states for t in s_):
        fail("a carried LSTM state is not finite")
    if any(before_val.get(k) for k in launches) or not before_val:
        fail(f"the train steps launched the kernels: {before_val}")
    quiet = [k for k, n in launches.items() if n == 0]
    if quiet:
        fail(f"the validation launched no {quiet}: {launches}")
    restored, path = trainer.restore_latest(trainer.init_state(bt))
    if path is None or restored.step != TRAIN_STEPS:
        fail(f"restore_latest gave step {restored.step} from {path}")

    # one train step profiled, on a batch harvested anew
    loader, _ = trainer.make_train_loader(1, splits["train"])
    hb = harvest_frames(next(iter(loader)), default_frames_per_slot(L),
                        cfg.model.head.max_gt, cfg.model.backbone.in_res_hw,
                        fold_hw=stem_fold_hw(cfg.model))
    dev = {k: torch.from_numpy(np.ascontiguousarray(hb[k])).cuda()
           for k in ("ev", "is_first", "frame_t", "frame_mask", "labels")}
    step = make_train_step(trainer.det, trainer.optimizer,
                           remat=cfg.training.remat)
    st = restored
    st, _ = step(st, dev)
    step_alone_ms = host_ms(lambda: step(st, dev), reps=2, warmup=0)
    dev_events, tries = profile_calls(lambda: step(st, dev), 1, "train step")
    profile = {"profile_tries": tries, "step_ms": step_alone_ms,
               **device_summary(dev_events, 1, step_alone_ms, "train step",
                                kernels_expected=False)}
    trainer.close()
    del trainer, step, st, restored, params0, stats0
    torch.cuda.empty_cache()

    step_ms = timings["step_ms"][1:]
    med = statistics.median(step_ms)
    return {
        "config": "RVT-B gen1 (experiment_preset('gen1', 'base'))",
        "batch": bt, "window": L,
        "frames_per_slot": default_frames_per_slot(L),
        "remat": cfg.training.remat, "compute": "bf16, fp32 parameters",
        "sampling": dst.train_sampling, "train_sequences": TRAIN_SEQS,
        "val_sequences": TRAIN_SEQS, "reprs": EVAL_REPRS,
        "render_s": render_s, "fit_s": fit_s, "steps": state.step,
        "step_ms": timings["step_ms"], "step_ms_median_2_to_n": med,
        "wait_ms": timings["wait_ms"], "val_s": timings["val_s"],
        "frames_per_s": bt * L / med * 1e3, "peak_mem_gib": peak_gib,
        "losses": [{k: r[k] for k in ("step",) + keys + (
            "grad_norm/backbone", "grad_norm/fpn", "grad_norm/head", "lr")}
            for r in steps],
        "val": vals[0], "launches": launches,
        "params_changed": [moved, n_params],
        "bn_stats_changed": [stats_moved, len(stats)],
        "restored_step": TRAIN_STEPS,
        "profile": profile, "checkpoint": path}


# ---------------------------------------------------------------------------
# Self-training phase
# ---------------------------------------------------------------------------

def _count(wrappers):
    return {w.__name__: w.launches for w in wrappers}


def _zero(wrappers):
    for w in wrappers:
        w.launches = 0


def _implied(cfg, steps: int, nms: int):
    """Launches of `steps` backbone steps of the model (one a block, one
    a ConvLSTM, whatever the slot count) and `nms` NMS calls."""
    want = {k: v * steps for k, v in launches_per_step(cfg).items()}
    want["nms_mask"] = nms
    return want


def _logits(p):
    import torch
    p = p.float().clamp(1e-7, 1 - 1e-7)
    return torch.log(p) - torch.log1p(-p)


def perturb_teacher(trainer, seqs, cfg):
    """The phase-6 model barely leaves its initialization in six warmup
    steps: LayerScale at 1e-5 and the YOLOX prior put every score at
    about 0.0101 (obj and class), so no box passes a threshold. As the
    serving phases do, the LayerScale is set from a seed (0); then the
    obj and class prediction kernels are scaled so that each kind's
    logits have a standard deviation of ST_LOGIT_STD over the first
    train window (B slots, L frames), as a trained detector's scores
    spread. Returns the unperturbed and perturbed max obj * cls score of
    that window."""
    import torch
    from leod_tpu_torch.data.loader import EvalStreamLoader
    from leod_tpu_torch.selftrain.runner import harvest_all_frames
    from leod_tpu_torch.train.step import make_eval_step

    dst = cfg.dataset
    hb = harvest_all_frames(next(iter(EvalStreamLoader(
        seqs, dst, cfg.training.batch_size_eval, start_from_zero=True))), cfg)

    def window_preds():
        det = trainer.eval_detector()
        return make_eval_step(det)(det.init_states(hb["ev"].shape[1]), hb)[1]

    def max_score(p):
        return float((p[..., 4].float() * p[..., 5:].float().max(-1).values
                      ).max())

    before = max_score(window_preds())
    perturb_layerscale(trainer.det, seed=0)
    p = window_preds()
    scale = {"obj_pred": ST_LOGIT_STD / float(_logits(p[..., 4]).std()),
             "cls_pred": ST_LOGIT_STD / float(_logits(p[..., 5:]).std())}
    with torch.no_grad():
        for name, prm in trainer.det.head.named_parameters():
            kind = name[:8]
            if kind in scale and name.endswith("weight"):
                prm.mul_(scale[kind])
    return before, max_score(window_preds()), scale


def _dataset_counts(root, dst):
    """Boxes of a written pseudo split: pseudo (a class id), tracker-
    ignored (the ignore label with the teacher's scores kept) and
    inpainted (the ignore label with zero scores), and the GT ones."""
    import numpy as np
    from leod_tpu_torch.data.sequence import list_sequence_dirs
    from leod_tpu_torch.selftrain.pseudo_labeler import PseudoLabelConfig
    ign = PseudoLabelConfig().ignore_label
    n = dict(pseudo=0, ignored=0, inpainted=0, gt=0, frames=0)
    for d in list_sequence_dirs(root, "train"):
        z = np.load(os.path.join(d, "labels_v2", "labels.npz"))
        lab = z["labels"]
        n["frames"] += len(z["objframe_idx_2_label_idx"])
        is_ign = lab["class_id"] == ign
        scored = lab["objectness"] > 0
        n["gt"] += int(((lab["t"] != 0) & ~is_ign).sum())
        n["pseudo"] += int(((lab["t"] == 0) & ~is_ign).sum())
        n["ignored"] += int((is_ign & scored).sum())
        n["inpainted"] += int((is_ign & ~scored).sum())
    return n


def _frame_boxes(root, dst):
    """{(sequence, repr index): [n, 5] (x, y, w, h, class id)} of a
    written pseudo split."""
    import numpy as np
    from leod_tpu_torch.data.sequence import ev_repr_dir, list_sequence_dirs
    out = {}
    for d in list_sequence_dirs(root, "train"):
        z = np.load(os.path.join(d, "labels_v2", "labels.npz"))
        lab, f2l = z["labels"], z["objframe_idx_2_label_idx"]
        f2r = np.load(os.path.join(ev_repr_dir(d, dst.ev_repr_name),
                                   "objframe_idx_2_repr_idx.npy"))
        ends = list(f2l[1:]) + [len(lab)]
        for r, a, b in zip(f2r, f2l, ends):
            rows = lab[a:b]
            out[(os.path.basename(d), int(r))] = np.stack(
                [rows["x"], rows["y"], rows["w"], rows["h"],
                 rows["class_id"]], -1).astype(np.float64)
    return out


def _matched(a, b):
    """Boxes of `a` matched one to one to `b`'s, greedily by IoU in
    descending order, at IoU >= ST_MATCH_IOU with the same class id."""
    import numpy as np
    if len(a) == 0 or len(b) == 0:
        return 0
    ax0, ay0 = a[:, 0], a[:, 1]
    ax1, ay1 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx0, by0 = b[:, 0], b[:, 1]
    bx1, by1 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.clip(np.minimum(ax1[:, None], bx1) - np.maximum(ax0[:, None],
                                                             bx0), 0, None)
    ih = np.clip(np.minimum(ay1[:, None], by1) - np.maximum(ay0[:, None],
                                                             by0), 0, None)
    inter = iw * ih
    iou = inter / (a[:, 2:3] * a[:, 3:4] + (b[:, 2] * b[:, 3])[None] - inter)
    iou[a[:, 4][:, None] != b[:, 4][None]] = 0.0
    n = 0
    while iou.size and iou.max() >= ST_MATCH_IOU:
        i, j = np.unravel_index(np.argmax(iou), iou.shape)
        iou[i, :] = 0.0
        iou[:, j] = 0.0
        n += 1
    return n


def _compare_datasets(root_a, root_b, dst):
    fa, fb = _frame_boxes(root_a, dst), _frame_boxes(root_b, dst)
    import numpy as np
    empty = np.zeros((0, 5))
    matched = sum(_matched(fa.get(k, empty), fb.get(k, empty))
                  for k in set(fa) | set(fb))
    na = sum(len(v) for v in fa.values())
    nb = sum(len(v) for v in fb.values())
    return {"boxes_kernel": na, "boxes_plain": nb, "matched": matched,
            "frac_kernel": matched / max(na, 1),
            "frac_plain": matched / max(nb, 1)}


def _preds_hook(store):
    """The runners' and TTA eval's on_batch hook that keeps each batch's
    preds and its kept detections."""
    def on_batch(pi, bi, hb, preds, dets, valid):
        store.append((preds.detach().clone(), int(valid.sum())))
    return on_batch


def _parity(kern, plain, what):
    rows = []
    if len(kern) != len(plain) or not kern:
        fail(f"{what}: {len(kern)} kernel batches against {len(plain)} "
             f"plain ones")
    for (pk, _), (pl, _) in zip(kern, plain):
        if pk.shape != pl.shape:
            fail(f"{what} preds {tuple(pk.shape)} against plain "
                 f"{tuple(pl.shape)}")
        # the box columns (pixels) and the score columns ([0, 1]) each
        # against their own largest plain value
        row = []
        for cols, k, p in (("boxes", pk[..., :4], pl[..., :4]),
                           ("scores", pk[..., 4:], pl[..., 4:])):
            err, tol, ok = compare(k, p, SLICE_TOL)
            row += [err, tol]
            if not ok:
                fail(f"{what} preds, {cols}: |kernel - plain| {err} > {tol}")
        rows.append(row)
    return rows


def _nms_exact(kern, cfg, what, conf: float = 0.0):
    """The NMS keep mask of the kernel on the kernel run's preds (every
    image of a batch, K = pre_nms_topk candidates at confidence `conf`)
    against the plain one; the last batch's NMS timed."""
    from leod_tpu_torch.ops import nms_cuda
    from leod_tpu_torch.ops.nms import nms_candidates
    from leod_tpu_torch.ops.nms import nms_mask as nms_plain
    pp, n_cls = cfg.model.postprocess, cfg.model.head.num_classes
    thr = pp.nms_threshold
    mismatches = kept = 0
    for pk, _ in kern:
        bx, va, ids, _, _ = nms_candidates(pk, n_cls, conf, pp.pre_nms_topk)
        keep_k = nms_cuda.nms_mask(bx, thr, va, ids)
        keep_p = nms_plain(bx, thr, va, ids)
        mismatches += int((keep_k != keep_p).sum())
        kept += int(keep_p.sum())
    if mismatches:
        fail(f"{what}: the NMS keep mask differs from the plain one in "
             f"{mismatches} boxes")
    nb, nk = bx.shape[:2]
    ops = nb * nk * (nk - 1) / 2 * 13
    bms, by = bound(ops, nb * nk * (16 + 1 + 4 + 1), PEAK_FP32)
    return {"images": nb, "k": nk, "mismatches": 0, "kept": kept,
            "ms": cuda_ms(lambda: nms_cuda.nms_mask(bx, thr, va, ids)),
            "plain_ms": cuda_ms(lambda: nms_plain(bx, thr, va, ids), reps=3),
            "bound_ms": bms, "bound_by": by}


def _med(xs):
    return statistics.median(xs) if xs else None


def phase_selftrain(checkpoint: str):
    """Phase 7: LEOD's self-training cycle at RVT-B Gen1 full width and
    depth (B 8, L 21) on the rendered train and val splits of phase 6
    (seed 0), label ratio ST_RATIO: (a) pseudo-labels, (b) the soft
    student, (c) TTA eval, (d) online SSOD. Returns its report and the
    launches of (a)-(d) together."""
    import shutil
    from dataclasses import replace
    import numpy as np
    import torch
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.data.synthetic import render_array_dataset
    from leod_tpu_torch.eval.tta import run_tta_eval
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.selftrain import online
    from leod_tpu_torch.selftrain.pseudo_labeler import (
        PseudoLabelConfig, load_pseudo_sequences, pseudo_dataset_config)
    from leod_tpu_torch.selftrain.runner import PseudoLabelRunner
    from leod_tpu_torch.selftrain.verify import (score_pseudo_dataset,
                                                 verify_pseudo_dataset)
    from leod_tpu_torch.train.trainer import Trainer, default_frames_per_slot

    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    root = os.path.join(REPO, "runs", "chip_smoke_selftrain")
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()

    def cfg_of(soft=False, **training):
        cfg = experiment_preset("gen1", "base", soft=soft)
        pp = replace(cfg.model.postprocess, confidence_threshold=ST_CONF)
        return replace(cfg, dataset=replace(cfg.dataset, ratio=ST_RATIO),
                       model=replace(cfg.model, postprocess=pp),
                       save_dir=root, training=replace(
                           cfg.training, **{"val_check_interval": 0,
                                            **training}))

    cfg = cfg_of()
    dst = cfg.dataset
    L, bt = dst.sequence_length, cfg.training.batch_size_train
    n_cls = cfg.model.head.num_classes
    # phase 6's split: the train sequences with the WSOD ratio applied,
    # the val ones with every label
    render = dict(num_train=TRAIN_SEQS, num_val=TRAIN_SEQS, num_test=0,
                  seed=0, num_reprs=EVAL_REPRS, hw=dst.resolution_hw,
                  first_label_repr=EVAL_FIRST_LABEL,
                  label_every=EVAL_LABEL_EVERY)
    splits = {"train": render_array_dataset(dst, **render)["train"],
              "val": render_array_dataset(replace(dst, ratio=-1.0),
                                          **render)["val"]}
    total = {w.__name__: 0 for w in wrappers}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # the teacher: phase 6's model, perturbed from a seed
    teacher_tr = Trainer(replace(cfg, exp_name="teacher"))
    st0 = teacher_tr.init_state(bt)
    teacher_tr.load_weights(checkpoint, st0)
    score0, score1, scale = perturb_teacher(teacher_tr, splits["train"], cfg)
    teacher_tr.save_checkpoint(st0, "teacher")
    teacher_ckpt = teacher_tr._ckpt_path("teacher")
    teacher = teacher_tr.eval_detector()

    # (a) pseudo-labels through the kernels, then the plain versions
    pl = PseudoLabelConfig(obj_thresh=(ST_OBJ, ST_OBJ),
                           cls_thresh=(ST_CLS, ST_CLS),
                           min_track_len=ST_MIN_TRACK, tta_hflip=True,
                           tta_tflip=True)
    pse = {k: os.path.join(root, f"pseudo_{k}") for k in ("kernel", "plain")}
    kern, plain, tim = [], [], {}
    _zero(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = PseudoLabelRunner(teacher, cfg, pl, pse["kernel"],
                                sequences=splits["train"],
                                on_batch=_preds_hook(kern),
                                timings=tim).run()
    wall = time.perf_counter() - t0
    launches_a = _count(wrappers)
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    PseudoLabelRunner(teacher, cfg, pl, pse["plain"],
                      sequences=splits["train"], plain=True,
                      on_batch=_preds_hook(plain)).run()
    n_batches = len(kern)
    want = _implied(cfg, L * n_batches, n_batches)
    if n_batches != 2 * TRAIN_SEQS * EVAL_REPRS // (L * bt) or \
            launches_a != want:
        fail(f"pseudo-labelling: {n_batches} batches, launches "
             f"{launches_a}; the runs imply {want}")
    add(launches_a)
    parity_a = _parity(kern, plain, "pseudo-labels")
    if kern[0][0].shape[0] != 2 * bt * L:
        fail(f"pseudo-label preds {tuple(kern[0][0].shape)}: not "
             f"{2 * bt} slots x {L} frames")
    nms_a = _nms_exact(kern, cfg, "pseudo-labels")
    counts = {k: _dataset_counts(v, dst) for k, v in pse.items()}
    c = counts["kernel"]
    if min(c["pseudo"], c["ignored"], c["inpainted"]) < 1:
        fail(f"the pseudo dataset lacks pseudo, tracker-ignored or "
             f"inpainted boxes: {c}")
    checked = verify_pseudo_dataset(pse["kernel"], dst, sample_frac=1.0,
                                    sequences=splits["train"])
    score = score_pseudo_dataset(pse["kernel"], dst, pl, n_cls, dst.classes,
                                 sequences=splits["train"])
    agree = _compare_datasets(pse["kernel"], pse["plain"], dst)
    if min(agree["frac_kernel"], agree["frac_plain"]) < ST_MATCH_FRAC:
        fail(f"the kernel and plain runs' pseudo datasets disagree: {agree}")
    views_frames = sum(2 * bt * L for _ in kern)
    report_a = {
        "teacher_max_score_unperturbed": score0,
        "teacher_max_score": score1, "pred_kernel_scale": scale,
        "thresholds": {"obj": ST_OBJ, "cls": ST_CLS, "conf": ST_CONF,
                       "min_track_len": ST_MIN_TRACK},
        "batches": n_batches, "slots": 2 * bt, "window": L,
        "nms_images_a_batch": 2 * bt * L, "launches": launches_a,
        "parity": parity_a, "nms": nms_a, "boxes": counts,
        "verified_sequences": checked, "agreement": agree,
        "metrics": {k: v for k, v in metrics.items()
                    if k.startswith(("ssod/teacher_AP", "ssod/teacher_AR"))},
        "score": {k: v for k, v in score.items() if "AR@50" in k},
        "wall_s": wall, "frames_per_s": views_frames / wall,
        "host_ms_per_batch": {k: _med(tim[k][1:]) for k in (
            "harvest_ms", "step_ms", "postprocess_ms", "consume_ms")},
        "pass_s": tim["pass_s"], "save_s": tim["save_s"],
        "peak_mem_gib": peak_a}
    emit({"selftrain_pseudo": report_a})
    del kern, plain

    # (b) the soft student on the pseudo split, from the teacher's weights
    scfg = cfg_of(soft=True, max_det_frames=L,
                  val_check_interval=STUDENT_STEPS)
    scfg = replace(scfg, dataset=pseudo_dataset_config(dst, pse["kernel"]),
                   exp_name="student")
    pseudo_seqs = load_pseudo_sequences(pse["kernel"], splits["train"], dst)
    student = Trainer(scfg)
    sst = student.init_state(bt)
    student.load_weights(teacher_ckpt, sst)
    params0 = [p.detach().clone() for p in student.det.parameters()]
    # the labels of the batches that fit harvests for its steps: the
    # train harvest alone passes `ignore_label`, and the prefetch queue
    # hands the batches to the steps in the order they were harvested
    from leod_tpu_torch.train import trainer as trainer_mod
    harvested = []
    orig_harvest = trainer_mod.harvest_frames

    def recording_harvest(*args, **kw):
        hb = orig_harvest(*args, **kw)
        if "ignore_label" in kw:
            harvested.append(hb["labels"].copy())
        return hb

    records = []
    student.logger.add_sink(records.append)
    _zero(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stim = {}
    t0 = time.perf_counter()
    trainer_mod.harvest_frames = recording_harvest
    try:
        sst = student.fit(max_steps=STUDENT_STEPS, state=sst, log_every=1,
                          sequences=pseudo_seqs, val_sequences=splits["val"],
                          timings=stim)
    finally:
        trainer_mod.harvest_frames = orig_harvest
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_b = _count(wrappers)
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    steps = [r for r in records if "loss" in r]
    keys = ("loss", "iou_loss", "conf_loss", "cls_loss", "grad_norm")
    if len(steps) != STUDENT_STEPS or not all(
            np.isfinite(r[k]) for r in steps for k in keys):
        fail(f"soft student losses: {steps}")
    # per step: boxes with the ignore label, and the other pseudo boxes
    # under the soft head's per-class thresholds (`ops/simota.py`
    # mark_low_conf_as_ignore)
    hc = scfg.model.head
    thr = np.asarray(hc.ignore_bbox_thresh, np.float32)
    ignore_a_step, soft_a_step = [], []
    for lab in harvested[:STUDENT_STEPS]:
        real = lab.sum(-1) > 0
        ign = real & (lab[..., 0] == hc.ignore_label)
        per_box = thr[np.clip(lab[..., 0].astype(np.int64), 0,
                              len(thr) - 1)]
        soft = real & ~ign & ((lab[..., 5] < per_box)
                              | (lab[..., 6] < per_box))
        ignore_a_step.append(int(ign.sum()))
        soft_a_step.append(int(soft.sum()))
    if len(harvested) < STUDENT_STEPS or not any(ignore_a_step):
        fail(f"no ignore-labelled box reached the soft student's steps: "
             f"{ignore_a_step} in {len(harvested)} harvested batches")
    moved = sum(not torch.equal(a, b)
                for a, b in zip(params0, student.det.parameters()))
    if moved < len(params0) // 2:
        fail(f"{moved} of {len(params0)} student parameters moved")
    quiet = [k for k, n in launches_b.items() if n == 0]
    if quiet:
        fail(f"the student's validation launched no {quiet}")
    add(launches_b)
    report_b = {
        "config": "experiment_preset('gen1', 'base', soft=True), "
                  "max_det_frames = L", "steps": STUDENT_STEPS,
        "frames_per_slot": L, "fit_s": fit_s,
        "step_ms": stim["step_ms"], "wait_ms": stim["wait_ms"],
        "val_s": stim["val_s"], "peak_mem_gib": peak_b,
        "ignore_label_boxes_a_step": ignore_a_step,
        "soft_ignored_boxes_a_step": soft_a_step,
        "losses": [{k: r[k] for k in ("step",) + keys} for r in steps],
        "val": [r for r in records if "val/AP" in r],
        "params_changed": [moved, len(params0)], "launches": launches_b}
    emit({"selftrain_student": report_b})
    del params0

    # (c) TTA eval of the student, through the kernels and the plain ones
    sdet = student.eval_detector()
    kern, plain, ttim = [], [], {}
    kw = dict(split="val", hflip=True, tflip=True, sequences=splits["val"])
    _zero(wrappers)
    t0 = time.perf_counter()
    ap_k = run_tta_eval(sdet, scfg, on_batch=_preds_hook(kern), timings=ttim,
                        **kw)
    tta_s = time.perf_counter() - t0
    launches_c = _count(wrappers)
    ap_p = run_tta_eval(sdet, scfg, plain=True, on_batch=_preds_hook(plain),
                        **kw)
    nb = len(kern)
    want = _implied(scfg, L * 2 * (TRAIN_SEQS * EVAL_REPRS // (L * bt)), nb)
    if nb != 2 * TRAIN_SEQS * EVAL_REPRS // (L * bt) or launches_c != want:
        fail(f"TTA eval: {nb} batches with frames, launches {launches_c}; "
             f"the eval implies {want}")
    add(launches_c)
    parity_c = _parity(kern, plain, "TTA eval")
    nms_c = _nms_exact(kern, scfg, "TTA eval")
    ap_diff = {k: abs(ap_k[k] - ap_p[k]) for k in ("AP", "AP_50", "AP_75")}
    if not all(d <= EVAL_AP_TOL for d in ap_diff.values()):
        fail(f"TTA AP with the kernels {ap_k} against plain {ap_p}")
    m_slot = default_frames_per_slot(L)
    report_c = {
        "batches": nb, "slots": 2 * bt, "frames_per_slot": m_slot,
        "launches": launches_c, "parity": parity_c, "nms": nms_c,
        "ap_kernel": {k: ap_k[k] for k in ("AP", "AP_50", "AP_75")},
        "ap_plain": {k: ap_p[k] for k in ("AP", "AP_50", "AP_75")},
        "ap_abs_diff": ap_diff, "wall_s": tta_s,
        "frames_per_s": nb * 2 * bt * L / tta_s,
        "host_ms_per_batch": {k: _med(ttim[k][1:]) for k in (
            "harvest_ms", "step_ms", "postprocess_ms", "bridge_ms")},
        "evaluate_ms": ttim["evaluate_ms"]}
    emit({"selftrain_tta": report_c})
    del kern, plain, sdet
    student.close()
    del student
    torch.cuda.empty_cache()

    # (d) online SSOD: an EMA teacher inside Trainer.fit
    ocfg = cfg_of(ssod_online=replace(
        cfg.training.ssod_online, enabled=True, burn_in_steps=1,
        obj_thresh=ST_OBJ, cls_thresh=ST_CLS))
    ocfg = replace(ocfg, exp_name="ssod")
    ssod_tr = Trainer(ocfg)
    ost = ssod_tr.init_state(bt)
    ssod_tr.load_weights(teacher_ckpt, ost)
    ema_checks = []
    orig_update = online.OnlineSSODBatcher.update_teacher

    def checked_update(self, student_det, step):
        name = "head.obj_pred0.weight"
        t_before = self.teacher[name].clone()
        s = student_det.state_dict()[name].float().clone()
        orig_update(self, student_det, step)
        a = min(1.0 - 1.0 / (step + 1.0), ocfg.training.ssod_online.alpha)
        want_t = a * t_before.double() + (1 - a) * s.double()
        rel = float((self.teacher[name].double() - want_t).abs().max()
                    / want_t.abs().max())
        ema_checks.append({"step": step, "alpha_t": a, "rel_err": rel,
                           "moved": not torch.equal(t_before,
                                                    self.teacher[name])})

    online.OnlineSSODBatcher.update_teacher = checked_update
    records = []
    ssod_tr.logger.add_sink(records.append)
    _zero(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    otim = {}
    t0 = time.perf_counter()
    try:
        ost = ssod_tr.fit(max_steps=SSOD_STEPS, state=ost, log_every=1,
                          sequences=splits["train"], timings=otim)
    finally:
        online.OnlineSSODBatcher.update_teacher = orig_update
    torch.cuda.synchronize()
    ssod_s = time.perf_counter() - t0
    launches_d = _count(wrappers)
    batcher = ssod_tr.ssod_batcher
    steps = [r for r in records if "loss" in r]
    if len(steps) != SSOD_STEPS or not all(
            np.isfinite(r[k]) for r in steps for k in keys):
        fail(f"online SSOD losses: {steps}")
    if len(ema_checks) != SSOD_STEPS or not all(
            e["rel_err"] <= SSOD_EMA_RTOL and e["moved"] for e in ema_checks):
        fail(f"the EMA teacher did not move by the formula: {ema_checks}")
    merged = batcher.merged[:SSOD_STEPS]
    if merged[0] != 0 or not all(merged[1:]):
        fail(f"pseudo boxes merged into the steps: {merged} (burn-in 1)")
    n_teacher = batcher.batches_out
    want = _implied(ocfg, L * n_teacher, n_teacher)
    if n_teacher < SSOD_STEPS or launches_d != want:
        fail(f"online SSOD: {n_teacher} teacher batches, launches "
             f"{launches_d}; they imply {want}")
    add(launches_d)
    report_d = {
        "steps": SSOD_STEPS, "burn_in": 1, "teacher_batches": n_teacher,
        "merged_pseudo_boxes": batcher.merged, "ema": ema_checks,
        "fit_s": ssod_s, "step_ms": otim["step_ms"],
        "wait_ms": otim["wait_ms"],
        "teacher_update_ms": otim["teacher_update_ms"],
        "teacher_ms": batcher.teacher_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": [{k: r[k] for k in ("step",) + keys} for r in steps],
        "launches": launches_d}
    emit({"selftrain_ssod": report_d})
    ssod_tr.close()
    teacher_tr.close()
    del ssod_tr, teacher_tr, teacher, batcher
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"phase_s": time.perf_counter() - t_phase,
            "launches": total}


# ---------------------------------------------------------------------------
# CLI phase
# ---------------------------------------------------------------------------

_REF_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
             "var": "running_var"}


def reference_key(path, gated: bool = False) -> str:
    """The reference LEOD/RVT state-dict key of a JAX tree path (under
    "params" or "batch_stats", leaf included): the layout
    `leod_tpu_torch/convert.py` `convert_torch_state_dict` reads, written
    backwards. `gated`: the backbone's MLPs are gated."""
    top, *rest = path
    *mods, leaf = rest
    tail = [_REF_LEAF.get(leaf, leaf)]
    if top == "backbone":
        out = ["backbone", "stages", str(int(mods[0][5:]) - 1)]
        sub = mods[1:]
        if leaf == "mask_token":
            return ".".join(out + ["mask_token"])
        if leaf in ("ls1", "ls2"):
            tail = ["gamma"]
            sub = sub + [leaf]
        if sub[0] == "down":
            out += ["downsample_cf2cl"] + sub[1:]
        elif sub[0] == "lstm":
            out += ["lstm", {"gates": "conv1x1", "dws": "conv3x3_dws"}[sub[1]]]
        else:
            i, kind = re.fullmatch(r"block(\d+)_(\w+)", sub[0]).groups()
            out += ["att_blocks", i, f"att_{kind}"]
            if sub[1] == "attn":
                out += ["self_attn"] + sub[2:]
            elif sub[1] == "mlp":
                inner = ["net", "0", "proj"] if gated else ["net", "0", "0"]
                out += ["mlp"] + {"proj_in": inner,
                                  "proj_out": ["net", "2"]}[sub[2]]
            else:
                out += sub[1:]
        return ".".join(out + tail)
    if top == "fpn":
        out = ["fpn"]
        for name in mods:
            m = re.fullmatch(r"m(\d+)", name)
            out += ["m", m.group(1)] if m else [name]
        return ".".join(out + tail)
    name, *sub = mods
    kind, k, j = re.fullmatch(
        r"(stem|cls_conv|reg_conv|cls_pred|reg_pred|obj_pred)(\d+)(?:_(\d))?",
        name).groups()
    out = ["yolox_head", f"{kind}s", k] + ([j] if j is not None else [])
    return ".".join(out + sub + tail)


def reference_state_dict(det):
    """The port detector's weights as a reference LEOD/RVT state dict:
    the port keeps the reference's torch layouts (OIHW convs, [out, in]
    linears), so each tensor goes over as it is, under its key."""
    from leod_tpu_torch.convert import jax_paths
    gated = det.cfg.backbone.mlp_gated
    sd = det.state_dict()
    return {reference_key(path, gated): sd[name].detach().float().cpu()
            for name, (_, path, _) in jax_paths(det).items()}


def _steps_of(cfg, launches):
    """The backbone steps `launches` imply, and whether every block and
    ConvLSTM kernel's count is that many steps' worth."""
    per = launches_per_step(cfg)
    steps = launches["lstm_update"] // per["lstm_update"]
    want = _implied(cfg, steps, launches["nms_mask"])
    return steps, launches == want


def phase_cli():
    """Phase 8: the CLIs on the card, through their `main` functions, at
    RVT-B Gen1 full width and depth (B 8, L 21): the self-training cycle
    driver at a short schedule, then `cli.val --tta` and `cli.train
    --torch-weight`. Returns its report and its launches."""
    from dataclasses import replace
    import numpy as np
    import torch
    from leod_tpu_torch.cli import predict, selftrain_cycle, train, val
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.convert import jax_paths
    from leod_tpu_torch.data.synthetic import render_dataset_frames
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.selftrain.runner import PseudoLabelRunner
    from leod_tpu_torch.train.trainer import Trainer

    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    root = os.path.join(REPO, "runs", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    work = os.path.join(root, "cycle")
    data = os.path.join(work, "data")
    cfg = experiment_preset("gen1", "base")
    L = cfg.dataset.sequence_length
    t_phase = time.perf_counter()

    # both train stages with a panel every CLI_VIZ_EVERY steps and
    # gradflow on, which no flag of the CLIs sets
    orig_build = train.build_config

    def build_config(args, path):
        cfg = orig_build(args, path)
        return replace(cfg, training=replace(
            cfg.training, viz_every_steps=CLI_VIZ_EVERY, gradflow=True))

    # the panels fit writes: each call's run and step, and the train
    # step's preds row that its postprocess takes
    panels, panel_rows = [], []
    orig_panel = Trainer._write_viz_panel

    def record_panel(self, step, viz, preds):
        panels.append((self.cfg.exp_name, step, tuple(preds.shape)))
        panel_rows.append((self.cfg, preds[viz["row"]][None].float()))
        return orig_panel(self, step, viz, preds)

    # the runners the predict stage builds: their arguments, and each
    # shard's preds a batch
    runners, shard_preds = [], {}

    def recording_runner(*args, **kw):
        runners.append((args, kw))
        return PseudoLabelRunner(*args, on_batch=_preds_hook(
            shard_preds.setdefault(kw["shard_index"], [])), **kw)

    train.build_config = build_config
    Trainer._write_viz_panel = record_panel
    predict.PseudoLabelRunner = recording_runner
    _zero(wrappers)
    try:
        out = selftrain_cycle.main([
            work, "--size", "base", "--steps-teacher", str(CLI_TEACHER_STEPS),
            "--steps-student", str(CLI_STUDENT_STEPS), "--batch", str(B),
            "--seq-len", str(L)])
    finally:
        train.build_config = orig_build
        Trainer._write_viz_panel = orig_panel
        predict.PseudoLabelRunner = PseudoLabelRunner
    torch.cuda.synchronize()
    cycle_s = time.perf_counter() - t_phase
    launches_cycle = _count(wrappers)

    for n in range(7):
        if not os.path.exists(os.path.join(work, f".done_{n}")):
            fail(f"cycle stage {n} did not finish")
    runs = os.path.join(work, "runs")
    for run in ("teacher", "student"):
        if not os.path.exists(os.path.join(runs, run, "ckpt_last.pt")):
            fail(f"the {run} wrote no checkpoint")
    for name in ("teacher_eval", "student_eval"):
        m = out[name]
        if not m or not all(np.isfinite(m[k]) for k in ("AP", "AP_50",
                                                          "AP_75")):
            fail(f"{name}: {m}")
    pse_train = os.path.join(work, "pseudo", "train")
    if len(os.listdir(pse_train)) != 6 or not out["pseudo_score"]:
        fail(f"pseudo dataset: {os.listdir(pse_train)}, score "
             f"{out['pseudo_score']}")
    with open(os.path.join(runs, "teacher", "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    want_flow = {"gradflow/" + ".".join(path) for coll, path, _ in
                 jax_paths(Detector(cfg.model, device="cuda")).values()
                 if coll == "params"}
    got_flow = {k for k in rec if k.startswith("gradflow/")}
    if got_flow != want_flow or not all(np.isfinite(rec[k])
                                        for k in got_flow):
        fail(f"gradflow keys: {len(got_flow)} logged, {len(want_flow)} "
             f"JAX names; missing {sorted(want_flow - got_flow)[:3]}, extra "
             f"{sorted(got_flow - want_flow)[:3]}")
    want_panels = ([("teacher", s) for s in range(
        CLI_VIZ_EVERY, CLI_TEACHER_STEPS + 1, CLI_VIZ_EVERY)]
        + [("student", s) for s in range(
            CLI_VIZ_EVERY, CLI_STUDENT_STEPS + 1, CLI_VIZ_EVERY)])
    if [p[:2] for p in panels] != want_panels:
        fail(f"viz panels at {panels}; want {want_panels}")
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    pngs = {run: sorted(os.listdir(os.path.join(runs, run, "viz")))
            if os.path.isdir(os.path.join(runs, run, "viz")) else []
            for run in ("teacher", "student")}
    if have_cv2 and [(r, int(f[4:12])) for r in ("teacher", "student")
                     for f in pngs[r]] != want_panels:
        fail(f"viz PNGs: {pngs}")
    steps, consistent = _steps_of(cfg, launches_cycle)
    if not consistent or steps == 0 or steps % L:
        fail(f"the cycle's launches {launches_cycle} are not a whole "
             f"number of L = {L} backbone steps")
    # the predict stage's kernels against their plain versions at its
    # shapes (B 6 slots under h-flip, NMS over 6 x L images): shard 0
    # again through the plain versions, its preds held as phase 7 holds
    # them, and the NMS keep mask exact on every batch of the kernel
    # run; each panel's NMS (one image) exact at the panel's confidence
    # and at 0 (all K candidates)
    if not runners:
        fail("the predict stage built no pseudo-label runner")
    args, kw = runners[0]
    plain = []
    PseudoLabelRunner(*args[:3], os.path.join(root, "pseudo_plain"),
                      plain=True, on_batch=_preds_hook(plain), **kw).run()
    kern = shard_preds.get(0, [])
    if kw["shard_index"] != 0 or not kern or \
            kern[0][0].shape[0] != 2 * 3 * L:
        fail(f"predict shard 0: {len(kern)} batches of "
             f"{[tuple(p.shape) for p, _ in kern[:1]]}, not 6 slots x {L}")
    predict_parity = _parity(kern, plain, "cli.predict shard 0")
    predict_nms = _nms_exact(kern, args[1], "cli.predict shard 0")
    panel_nms = []
    for pcfg, row in panel_rows:
        for conf in (pcfg.model.postprocess.confidence_threshold, 0.0):
            r = _nms_exact([(row, 0)], pcfg, "a panel's postprocess", conf)
            panel_nms.append({"conf": conf, "kept": r["kept"]})
    del kern, plain
    shard_preds.clear()
    panel_rows.clear()
    report = {"cycle_s": cycle_s, "stage_s": out["seconds"],
              "teacher_eval": out["teacher_eval"],
              "student_eval": out["student_eval"],
              "pseudo_score": out["pseudo_score"],
              "gradflow_keys": len(got_flow), "panels": panels,
              "panel_pngs": pngs, "cv2": have_cv2,
              "backbone_steps": steps, "launches_cycle": launches_cycle,
              "predict_batches": len(predict_parity),
              "predict_parity": predict_parity, "predict_nms": predict_nms,
              "panel_nms": panel_nms}

    # val --tta on the cycle's split, with the student
    frames = render_dataset_frames(data, num_train=6, num_val=4, num_test=0,
                                   num_reprs=64, label_every=2,
                                   first_label_repr=11)
    _zero(wrappers)
    t0 = time.perf_counter()
    m = val.main(["--size", "base", "--path", data, "--split", "val",
                  "--seq-len", str(L), "--tta", "--ckpt",
                  os.path.join(runs, "student", "ckpt_last")], frames=frames)
    torch.cuda.synchronize()
    launches_tta = _count(wrappers)
    steps, consistent = _steps_of(cfg, launches_tta)
    if not m or not all(np.isfinite(m[k]) for k in ("AP", "AP_50", "AP_75")):
        fail(f"val --tta: {m}")
    if not consistent or steps == 0:
        fail(f"val --tta launches {launches_tta}")
    report.update(tta_s=time.perf_counter() - t0, tta_eval=m,
                  launches_tta=launches_tta)

    # train --torch-weight from a reference-layout Lightning checkpoint of
    # a seeded model: one step later the weights are still that model's
    ref = Detector(cfg.model, dtype=torch.float32, device="cpu", seed=7,
                   trainable=True)
    ref_path = os.path.join(root, "reference.ckpt")
    torch.save({"state_dict": {"mdl." + k: v for k, v in
                               reference_state_dict(ref).items()}},
               ref_path)
    t0 = time.perf_counter()
    train.main(["--size", "base", "--path", data, "--ratio", "0.25",
                "--steps", "1", "--batch-size", str(B), "--seq-len", str(L),
                "--torch-weight", ref_path, "--save-dir",
                os.path.join(root, "runs"), "--exp-name", "torch_weight",
                "--val-every", "0"], frames=frames)
    got = torch.load(os.path.join(root, "runs", "torch_weight",
                                  "ckpt_last.pt"), weights_only=True)["model"]
    fresh = Detector(cfg.model, dtype=torch.float32, device="cpu", seed=0,
                     trainable=True).state_dict()
    moved = max(float((got[n].cpu() - p.detach()).abs().max())
                for n, p in ref.named_parameters())
    apart = max(float((fresh[n] - p.detach()).abs().max())
                for n, p in ref.named_parameters())
    if not moved <= CLI_TORCH_WEIGHT_TOL < apart:
        fail(f"train --torch-weight: the trained weights are {moved} from "
             f"the reference checkpoint's (a seed-0 model is {apart} away)")
    report.update(torch_weight_s=time.perf_counter() - t0,
                  torch_weight_max_delta=moved,
                  torch_weight_seed0_delta=apart)
    total = {k: launches_cycle[k] + launches_tta[k] for k in launches_cycle}
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    report.update(phase_s=time.perf_counter() - t_phase, launches=total)
    return report


# (tag, experiment_preset size, whether it runs the variant and the eval
# phases) of the paths driven, in order
PATHS = (("RVT-B", "base", True), ("RVT-S", "small", False))


def drive_path(tag: str, size: str, first: bool, probe_lib: str):
    """Phases 2-4 for one Gen1 model at full width and depth, and phases
    2b and 5 where `first`; returns its kernels' entries of the JSON
    line."""
    import torch
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector

    cfg = experiment_preset("gen1", size)
    name = f"{tag} gen1 (experiment_preset('gen1', '{size}'))"
    det = Detector(cfg.model, device="cuda", seed=0)
    perturb_layerscale(det, seed=0)
    rows, nms_row = phase_kernels(det)
    emit({"kernel_phase": {"config": name, **rows, "nms_mask": [nms_row]}})
    checked = dict(rows)
    if first:
        var = phase_variants(det, probe_lib)
        emit({"variants": {"config": name, **var}})
        checked.update((k, var[k]) for k in ("lstm_update_clusters",
                                             "lstm_update_c_fp32"))
    for kind, kind_rows in checked.items():
        if not all(r["ok"] for r in kind_rows):
            fail(f"{tag} {kind} disagrees with its plain version: "
                 f"{[(r['shape'], r['max_abs_err'], r['tol']) for r in kind_rows]}")
    launches, steps, stats, parity, timing = phase_slice(det, cfg)
    emit({"slice": {"config": name, "slots": B, "steps": steps,
                    "launches": launches, "parity": parity, **timing,
                    "engine_stats": stats,
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}})
    emit({"profile": {"config": name, **phase_profile(det, cfg, timing)}})
    ev = {"launches": {}}
    if first:
        ev = phase_eval(det, cfg)
        emit({"eval": {"config": name, **ev}})

    suffix = "" if tag == "RVT-B" else f"[{tag}]"
    src, pallas = "leod_tpu_torch/csrc/maxvit.cu", "leod_tpu/ops/maxvit_pallas.py"
    entries = [
        ("fused_block_pair", f"{pallas}:254", src, rows["fused_block_pair"],
         PEAK_BF16),
        ("fused_stage", f"{pallas}:206", src, rows["fused_stage"], PEAK_BF16),
        ("block_attention", f"{pallas}:62", src, rows["block_attention"],
         PEAK_BF16),
        ("block_mlp", f"{pallas}:92", src, rows["block_mlp"], PEAK_BF16),
        ("lstm_update", f"{pallas}:163", src, rows["lstm_update"], PEAK_BF16),
        ("nms_mask", "leod_tpu/ops/nms_pallas.py:65",
         "leod_tpu_torch/csrc/nms.cu", [nms_row], PEAK_FP32)]
    out = []
    for kname, replaces, source, shape_rows, peak in entries:
        e = _summary(kname + suffix, replaces, source, shape_rows,
                     launches[kname] + ev["launches"].get(kname, 0), peak)
        e["config"] = name
        e["launches_serve"] = launches[kname]
        e["launches_eval"] = ev["launches"].get(kname, 0)
        if kname == "nms_mask" and "nms_b48" in ev:
            e["eval_b48"] = ev["nms_b48"]
        out.append(e)
    del det
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script drives the port on an NVIDIA card")
    if not os.path.isdir(os.path.join(REPO, "leod_tpu_torch", "csrc")):
        fail("leod_tpu_torch/ is not beside this script; run it from the "
             "repository root")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    probe_lib = phase_build()
    kernels = []
    for tag, size, first in PATHS:
        kernels += drive_path(tag, size, first, probe_lib)
        torch.cuda.empty_cache()
    emit({"train_check": phase_train_parity()})
    train = phase_train()
    emit({"train": train})
    selftrain = phase_selftrain(train["checkpoint"])
    shutil.rmtree(os.path.dirname(os.path.dirname(train["checkpoint"])),
                  ignore_errors=True)
    emit({"selftrain": selftrain})
    cli = phase_cli()
    emit({"cli": cli})
    # the first path's kernels also ran in the train phase's validation,
    # in the self-training phase and in the CLI phase
    for e in kernels:
        if e["config"].startswith("RVT-B"):
            e["launches_train"] = train["launches"][e["name"]]
            e["launches_selftrain"] = selftrain["launches"][e["name"]]
            e["launches_cli"] = cli["launches"][e["name"]]
            e["launches"] += (e["launches_train"] + e["launches_selftrain"]
                              + e["launches_cli"])
    emit({"kernels": kernels})
    bad = [k["name"] for k in kernels if not k["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "leod_tpu"
              or m.startswith("leod_tpu.")]
    if leaked:
        fail(f"imported JAX or the JAX package: {leaked[:5]}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
