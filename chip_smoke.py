#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port `leod_tpu_torch` on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

1. Build: the op library (`ops/_build.py`): the kernels' CUDA sources
   under leod_tpu_torch/csrc/ compiled with nvcc for sm_90a and the ops'
   C++ (`csrc/torch_ops.cpp`, `TORCH_LIBRARY`) with g++ against torch's
   headers, one compiler per source, all started together, then linked
   into one library; the C++ host library
   (leod_tpu_torch/native/host_ops.cpp) with g++ beside them; each
   step's seconds; a build that fails fails the run.

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

9. Deploy phase, after phase 8, at RVT-B Gen1, B 8, bf16: the path that
   deploys the system. (a) DEPLOY_RECS = 4 raw `.dat` recordings of
   DEPLOY_SECONDS = 2 s of seeded events at 240 x 304, 0.5-1 M events/s,
   with `_bbox.npy` labels, written by the port's `write_dat`, are
   imported by `cli.import_raw` into a frame store on the card (the
   voxelizer's `index_add_`) and again with `--cpu`: every window's
   histogram must be equal; events/s and ms a window. (b) The C++ host
   library (built with g++ in phase 1, which fails if it does not load):
   the TTA merge's class-aware NMS on 80 seeded frames of 1200 pooled
   rows (phase 7c's size) and the COCO matcher on 80 seeded images,
   native against numpy, index for index and exactly, both timed; phase
   7c's `evaluate()` ms (now with the native library) beside them. (c)
   `cli.export --ckpt` of a seed-0 checkpoint (LayerScale from seed 0)
   at conf 0: the artifact loaded (`load_artifact_exported`,
   `program_module`) and run for DEPLOY_STEPS = 10 steps of (a)'s frames
   (8 slots: recording i % 4 from window 20 (i // 4); all reset at step
   0; at step 5 slots 2 and 6 reset and slots 3 and 7 idle) from
   `zero_states_like`, against the live `make_serve_step` of the same
   checkpoint: dets and states within rtol 1e-5, atol 1e-6 (the JAX
   package's export round trip), valid exactly, and each artifact step
   launching the live step's `block_attention`, `block_mlp`,
   `lstm_update` and `nms_mask` count; export s, load s, the `.pt2`'s MB.
   Then the same artifact in a process with torch and nothing else:
   `python -I artifact.py` copied alone into an empty temp directory
   (its working directory and TMPDIR; the artifact copied beside it), no
   `nvcc` directory on its PATH, no CUDA_HOME, so neither the package
   nor its `_build/` nor a compiler is in reach: the same steps and
   flags from zero states; its states, dets and valid must equal the
   in-process artifact's bit for bit and each step's launches, as the
   carried library counts them, the live step's; load s, step ms, the
   artifact's and the library's MB, the op library's build seconds.
   (d) `cli.serve.make_server` over the artifact on an ephemeral port of
   127.0.0.1: 16 client streams of (a)'s frames over the 8 slots from a
   thread each (6 streams x 3 requests, then all 16 x 2, so that slots
   are evicted, then the 6 x 2 again); every answer must equal, to the
   4-decimal rounding, a replay of its stream alone through the step in
   the slot and with the resets the engine gave it; the server's steps
   must launch each op's count a step; request latency p50/p99 (the
   engine's and the client's), steps.

10. Gen4 phase, after phase 9: RVT-B Gen4 (`experiment_preset("gen4",
   "base")`: input 384 x 640 prefolded to [96, 160, 320], stage maps
   96 x 160 down to 12 x 20 in a 6 x 10 partition, T = 60 tokens a
   window, 3 classes, 5040 anchors) at full width and depth, seeded,
   LayerScale from seed 0. (a) The kernel phase at its stage shapes for
   GEN4_BATCH = 12 slots (the preset's eval and train batch), each half
   of a block and the ConvLSTM update also at B = 8 and 1, the NMS at
   12 images of 3 classes, at the kernel tolerance (no wrapper may
   refuse a shape: it raises and the run fails); the slice phase's
   serving engine at 8 slots (the step at B = 8 and 1 against the plain
   step at the slice tolerance, step ms at B = 1 and 8) and an engine of
   1 slot, the launches as implied. (b) The eval phase on GEN4_SEQS =
   12 rendered val sequences of GEN4_REPRS = 20 reprs at 720 x 1280
   (`data/synthetic.py`, frames x2 downsampled, 3 classes, labels every
   4 from repr 3), B 12, L 5, M 2: its checks (a)-(d), with Gen4's
   evaluator (its ds2 box filter). (c) The train phases' `Trainer.fit`,
   B 12 (6 stream and 6 random-access slots), L 5, remat "full", for
   GEN4_TRAIN_STEPS = 3 steps on 12 rendered train sequences, validating
   once through the kernels, with phase 6's checks. (d) Every TBPTT
   remat policy ("full", "dots", "stage1", "none") for REMAT_STEPS = 3
   steps of a seeded trainable model (a fresh copy of the same weights
   each, a new optimizer) on the same first 3 batches of the train
   loader: fails unless each first step's loss is within REMAT_LOSS_RTOL
   = 1e-3 and each module's gradient norm within REMAT_NORM_RTOL = 1e-2
   of "full"'s, relative, and the peak memory ranks full < dots < none
   and full < stage1 < none; reports the median host ms of steps 2-3
   and the peak GiB. (e) `PseudoLabelRunner` with h-flip and t-flip
   (Gen4's window offset -2) over the 12 train sequences at the WSOD
   label ratio ST_RATIO, the teacher (c)'s model through
   `perturb_teacher` at a logit spread of GEN4_LOGIT_STD = 2 (3-class
   thresholds ST_OBJ, ST_CLS, conf ST_CONF): 24 slots, 120 NMS images
   a batch, through the kernels and
   the plain versions, with phase 7(a)'s checks of the preds, the NMS
   mask, the launches, `verify_pseudo_dataset` and the datasets'
   agreement.

11. Data-parallel phase, after phase 10, RVT-B Gen4 at full width and
   depth over DP_WORLD = 2 ranks of DP_LOCAL = 6 slots (the preset's
   B 12), `parallel/` over `torch.distributed`. (a) DP_NCCL_STEPS = 2
   steps of `Trainer.fit` (B 12, L 5, stream sampling) under a one-rank
   NCCL group, against the same run without a group: losses and every
   parameter and BN statistic bit-equal (cuDNN and the scatter-adds on
   their deterministic algorithms for both). The kernels at a rank's
   shapes: the kernel phase at B = 6 and the NMS at a rank's teacher's
   6 x 5 = 30 images. One process runs `cli.train` (the preset, stream
   sampling, DP_STEPS = 3 steps, in fp32: in bf16 a rank's B 6 and one
   process's B 12 round apart, and a SimOTA assignment flips between
   them at random weights) on phase 10's rendered split as a frame
   store, and the first step of (d)'s fit at B 12 in bf16 and in fp32,
   recording its head outputs and how far it moved each BN running
   statistic. Then
   two rank processes, joined over gloo and sharing the card, each
   render the same split and run (b) `cli.train --mesh 2` with the same
   flags, then a validation of the run's checkpoint
   sharded over the ranks through the kernels (each rank 6 of the 12 val
   sequences at B 12, the evaluators all-gathered), (c) online SSOD
   from that checkpoint through `perturb_teacher` (thresholds ST_OBJ,
   ST_CLS, conf ST_CONF, burn-in 1, then DP_SSOD_STEPS = 2 steps), a
   teacher a rank at B 6, and (d) a fit that the parent stops with a
   SIGTERM to rank 1 after its second step. Fails if a rank or the
   group times out or fails, and unless (b) the ranks' parameter
   checksums and losses are equal after every step, every step's loss
   and num_fg and the first step's gradient norms (global and per
   module) are within DP_FP32_RTOL = 1e-5 of one process's, relative,
   the later steps' norms within DP_FP32_LATER_NORM_RTOL = 1e-3, the
   weights after step 1 no further apart than two first Adam updates,
   and apart by a sign only where one process's gradient is at most
   DP_FLIP_GRAD_MAX = 1e-5 (a rounding's sign), the train steps
   launched no kernel, each labeled val frame's preds row from the
   ranks is within 2^-4 * max|plain| (boxes and scores apart) of a
   one-process eval of the same checkpoint, the ranks' metrics are
   equal and within EVAL_AP_TOL of one process's, and each rank's eval
   NMS mask is exact; (c) each rank took 3 steps with its teacher at 6
   rows, pseudo boxes merged after the burn-in and none before, the
   teacher launched what its batches imply, the NMS mask on its preds
   (30 images) is exact, and the ranks' checksums are equal; (d) both
   ranks left fit at the same step, and rank 0's ckpt_last.pt holds it,
   the first bf16 step's head outputs of the two ranks together (boxes
   and scores apart) lie no further from one process's fp32 step than
   DP_BF16_NOISE = 2 times one process's bf16 step does, and the moves
   of every BN running statistic are within 2^-4 * max|plain| of one
   process's bf16 step at B 12.
   Reports each rank's step ms, the gradient all-reduce's ms a step,
   peak GiB, validation s, the teachers' ms and the phase's seconds,
   beside the card's name and power limit.

12. Space phase, after phase 11, RVT-B Gen4 at full width and depth
   with the image height sharded over SP_WORLD = 2 ranks (the preset's
   B 12 as one data shard, `make_mesh(2, space=2)`, `parallel/space.py`).
   (a) The kernel phase at a space rank's maps (48 x 160 down to 6 x 20
   at B 12: its window layout, and the grid layout the row exchange
   gives it, maps of as many rows), and the NMS at an eval batch's 24
   images. Two rank processes, joined over gloo and sharing the card,
   each render phase 11's split and run (b) `cli.train --mesh 1x2` with
   phase 11's flags (3 fp32 steps) and the first step of phase 11's bf16
   fit, (c) one bf16 step of every remat policy from the seeded weights
   on the first batch of the train loader, and (d) a streaming eval of
   (b)'s checkpoint through the kernels. Fails unless (b) the ranks'
   checksums and losses are equal after every step, each carries its
   height slice of the state table, the steps launched no kernel,
   every step's loss and num_fg and step 1's gradient norms are within
   DP_FP32_RTOL of phase 11's one process at B 12 and the later norms
   within DP_FP32_LATER_NORM_RTOL, and the first bf16 step's head
   outputs (whole, equal on both ranks) lie no further from one
   process's fp32 step than DP_BF16_NOISE times one process's bf16 step;
   (c) every policy's first step is within REMAT_LOSS_RTOL and
   REMAT_NORM_RTOL of "full"'s, and a rank's "none" peak is below one
   process's "none" peak of phase 10(d); (d) each labeled val frame's
   preds row of each rank is within 2^-4 * max|plain| (boxes and scores
   apart) of a one-process eval of the checkpoint, the ranks' metrics
   are equal and within EVAL_AP_TOL of one process's, the NMS inputs are
   whole (B M images of every anchor), each rank's NMS mask is exact, no
   block half took the gather path, and every kernel launched. (e)
   `leod_tpu_torch.cli.vis --reverse` at RVT-B Gen1 on one rendered val
   sequence (`phase_vis`): both videos with every frame, the side-by-side
   one 2w + 4 wide, the boxes drawn above `--conf` exactly the eval
   step's. Reports each rank's step ms, the space collectives' calls,
   bytes and host ms by kind, the block halves by route, the peaks
   beside one process's, and the phase's seconds, beside the card's
   name and power limit: the ranks share one card, so the times show
   correctness and per-rank memory, not speed across cards.

13. Model phase, after phase 12, RVT-B Gen4 at full width and depth
   with the transformer blocks tensor-parallel over TP_WORLD = 2 ranks
   (the preset's B 12 as one data shard, `make_mesh(2, model=2)`,
   `parallel/tensor.py`: every stage's heads and MLP inner units halved).
   (a) The model axis's variants against their plain versions within
   2^-5 * max|plain|, at model rank 0's shard of every Gen4 stage's
   first pair at B 12 for each local head count 1, 2, 4, 8 below the
   stage's heads (model degrees 2-16), and at the Gen1 RVT-B and RVT-S
   widths at degree 2 (B 8; RVT-S's 48-wide stage 1 keeps 1 head of
   24): the head-shard `block_attention` (window and grid),
   `block_mlp_tp` (the MLP kernel's model-axis mode, on an fp32 sum of
   the out-projection) and `block_residual`, timed with CUDA events,
   each with its bound. Two rank processes, joined over gloo and sharing
   the card, each render phase 11's split and run (b) `cli.train --mesh
   1x1x2` with phase 11's flags (3 fp32 steps) and the first step of
   phase 11's bf16 fit, and (c) a streaming eval of (b)'s checkpoint
   through the variants; then (d) four rank processes run one fp32 step
   of `cli.train --mesh 1x2x2` (the space and model axes together).
   Fails unless (b) every block sharded, the ranks' whole tensors (all
   but the sharded ones) and losses are equal after every step, the
   steps launched no kernel, every step's loss and num_fg and step 1's
   gradient norms are within DP_FP32_RTOL of phase 11's one process at
   B 12 and the later norms within DP_FP32_LATER_NORM_RTOL, the first
   bf16 step's head outputs (whole, equal on both ranks) lie no further
   from one process's fp32 step than DP_BF16_NOISE times one process's
   bf16 step, and the checkpoint the ranks wrote (whole tensors) loads
   into one process; (c) each labeled val frame's preds row of each
   rank is within 2^-4 * max|plain| (boxes and scores apart) of a
   one-process eval of that checkpoint, the ranks' metrics are equal and
   within EVAL_AP_TOL of one process's, each rank's NMS mask is exact,
   and every kernel launched but the whole-block `block_mlp`; (d) the
   four ranks' losses and whole tensors are equal, each carries half
   the height of the state table, and the step is within phase 11's
   step-1 bars of one process's. Reports each rank's step ms, the model
   all-reduces' calls, bytes and host ms ("collective.model" spans), a rank's peak
   GiB beside one process's (activations stay whole under the model
   axis), and the phase's seconds, beside the card's name and power
   limit.

Prints the kernels' JSON line (each kernel wrapper of each path: its
RVT-B Gen1 entry under its own name, its RVT-S entry as
"<name>[RVT-S]", its RVT-B Gen4 entry as "<name>[Gen4]", whose times
and bound are its rows' at B = 12, its Gen4 entry at a data-parallel
rank's B = 6 as "<name>[Gen4 DP]", its Gen4 entry at a space rank's
maps as "<name>[Gen4 SP]", the model axis's variants at a model rank's
Gen4 shards as "<name>[Gen4 TP]", whose times and bound are its rows' at
model degree 2; an RVT-B entry's launches are the slice
phase's, the eval phase's, the train phase's validation's, the
self-training phase's, the CLI phase's, the deploy phase's artifact and
server steps' and phase 12's cli.vis's, a Gen4 entry's its serving
engines', eval's, validation's and pseudo-labels', a Gen4 DP entry's the
ranks' validations' and online SSOD teachers', a Gen4 SP entry's the
space ranks' evals', a Gen4 TP entry's the model ranks' evals'),
the card's name and power limit, and the result JSON as the last line.
Any failure exits non-zero; so does a machine without a CUDA device, or
a directory without the package.

    python3 chip_smoke.py --serve-timing ROOT

times only the live RVT-B serve step of the package under ROOT (see
`serve_timing`), for an A/B of two trees in one call, and

    python3 chip_smoke.py --mlp-timing ROOT

only `block_mlp` at the RVT-B Gen1 stage shapes at B = 16, 8 and 1,
the Gen4 ones at B = 12 and the RVT-S Gen1 ones at B = 8 and 1 (see
`mlp_timing`), likewise; the first path's
kernel phase gives the same at the Gen1 B = 16 and 8 shapes
("block_mlp_device").
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
import tempfile
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
# the deploy phase (9): DEPLOY_RECS raw recordings of DEPLOY_SECONDS at
# a Gen1 sensor's 240 x 304 and DEPLOY_RATE events/s (uniform in the
# range, a recording each), made from DEPLOY_SEED; the exported artifact
# and the live step over DEPLOY_STEPS steps, held to the JAX package's
# export round-trip tolerance (tests/test_serve.py:126-129); then
# DEPLOY_STREAMS HTTP client streams over the B slots
DEPLOY_SEED = 0
DEPLOY_RECS = 4
DEPLOY_SECONDS = 2.0
DEPLOY_RATE = (0.5e6, 1.0e6)
DEPLOY_STEPS = 10
DEPLOY_RTOL, DEPLOY_ATOL = 1e-5, 1e-6
DEPLOY_STREAMS = 16
# HTTP boxes are rounded to 4 decimals: a replayed box may sit one
# rounding step away
DEPLOY_HTTP_ATOL = 1e-4
# seeded TTA-merge inputs of phase 7c's size: 80 labelled frames, 4
# views of 300 dets each
MERGE_FRAMES, MERGE_ROWS = 80, 4 * 300
# `--serve-timing`: host-clock runs of the live serve step a batch size
SERVE_TIMING_REPS = 50
# `block_mlp`'s profiled device time a launch: launches a window, and the
# Gen1 batches (16: LEOD's test batch, the eval cell's)
MLP_PROFILE_CALLS = 20
MLP_GEN1_BATCHES = (16, B)
# the Gen4 phase (10), RVT-B Gen4 at full width and depth: the kernels at
# the eval and train batch GEN4_BATCH, each half of a block and the
# ConvLSTM update also at the serving batches; GEN4_SEQS train and as
# many val sequences of GEN4_REPRS reprs at 720 x 1280 (the frames x2
# downsampled), 3 classes, labeled every EVAL_LABEL_EVERY from repr
# EVAL_FIRST_LABEL (a frame or two in every window of 5); GEN4_TRAIN_STEPS
# steps of `Trainer.fit`; each remat policy REMAT_STEPS steps from the
# same weights on the same first batches, its first step's loss within
# REMAT_LOSS_RTOL and each module's gradient norm within REMAT_NORM_RTOL
# of "full"'s, relative
GEN4_BATCH = 12
GEN4_KERNEL_BATCHES = (GEN4_BATCH, B, 1)
GEN4_SEQS = 12
GEN4_REPRS = 20
GEN4_TRAIN_STEPS = 3
REMAT_STEPS = 3
REMAT_LOSS_RTOL = 1e-3
REMAT_NORM_RTOL = 1e-2
# the data-parallel phase (11), RVT-B Gen4 at full width and depth:
# DP_WORLD rank processes of DP_LOCAL slots each (the preset's B 12 over
# the ranks) over gloo on the one card, DP_STEPS steps of `cli.train
# --mesh` in fp32, every step's loss and num_fg and the first step's
# gradient norms within DP_FP32_RTOL of one process's at B 12 (the first
# step's loss was bit-equal and its norms within 3.0e-6 on an H100), the
# later steps' norms within DP_FP32_LATER_NORM_RTOL (8.8e-5 to 2.2e-4
# read on an H100: Adam's first update takes opposite signs where the
# gradient's sign is a rounding's, 35 weights with |g| up to 1.9e-6,
# under DP_FLIP_GRAD_MAX, and the backbone's norm, 7e4 at the seeded
# weights, moves with them); the first bf16 step's head outputs no
# further from the fp32 step's than DP_BF16_NOISE times one process's
# bf16 step; online
# SSOD for DP_SSOD_BURN_IN + DP_SSOD_STEPS steps; a fit of at most
# DP_STOP_MAX steps that rank 1's SIGTERM stops after its DP_STOP_AT-th;
# DP_NCCL_STEPS steps under a one-rank NCCL group. A collective waits at
# most DP_GROUP_TIMEOUT_S, and the ranks are killed after
# DP_RANK_TIMEOUT_S.
DP_WORLD = 2
DP_LOCAL = 6
DP_STEPS = 3
DP_FP32_RTOL = 1e-5
DP_FP32_LATER_NORM_RTOL = 1e-3
DP_BF16_NOISE = 2.0
DP_FLIP_GRAD_MAX = 1e-5
DP_SSOD_BURN_IN = 1
DP_SSOD_STEPS = 2
DP_STOP_AT = 2
DP_STOP_MAX = 40
DP_NCCL_STEPS = 2
DP_GROUP_TIMEOUT_S = 300
DP_RANK_TIMEOUT_S = 600
# the space phase (12), RVT-B Gen4 at full width and depth: SP_WORLD rank
# processes over gloo on the one card hold the preset's B 12 (one data
# shard) as the space axis of `make_mesh(SP_WORLD, space=SP_WORLD)`, half
# its height each; their fp32 steps are held to phase 11's bars against
# phase 11's one process, and the ranks are killed after
# SP_RANK_TIMEOUT_S. (e) runs cli.vis at its default thresholds (0.1
# and 0.01) on a model whose obj and class logits are set, over the
# sequence's first window, to mean VIS_LOGIT_MEAN and standard deviation
# VIS_LOGIT_STD each, so that both the green and the red boxes are
# drawn and fewer than max_dets (300) a frame: at mean -4.5 an H100 run
# drew 867 boxes above 0.1 and 7416 between in 42 frames, up to 298 a
# frame (independent normal logits over Gen1's 1680 anchors and 2
# classes predict 0.67x of those counts at -4.5, 0.31x at -5).
SP_WORLD = 2
SP_RANK_TIMEOUT_S = 600
# the model phase (13), RVT-B Gen4 at full width and depth: TP_WORLD rank
# processes over gloo on the one card hold the preset's B 12 (one data
# shard) as the model axis of `make_mesh(TP_WORLD, model=TP_WORLD)`:
# every Gen4 stage's heads (2, 4, 8, 16) and MLP inner units halved, 1,
# 2, 4 and 8 heads a rank. Their fp32 steps are held to phase 11's bars
# against phase 11's one process, their eval to phase 12's; then
# TP3D_WORLD ranks of `make_mesh(4, space=2, model=2)` take TP3D_STEPS
# fp32 step(s), held to the same bars. The kernel phase runs the
# variants at a model rank's shards of every Gen4 stage for each local
# head count TP_HEADS below the stage's heads (model degrees 2-16), and
# at the Gen1 RVT-B and RVT-S widths at degree 2. Ranks are killed after
# TP_RANK_TIMEOUT_S.
TP_WORLD = 2
TP3D_WORLD = 4
TP3D_STEPS = 1
TP_HEADS = (1, 2, 4, 8)
TP_RANK_TIMEOUT_S = 600
VIS_LOGIT_MEAN, VIS_LOGIT_STD = -5.0, 2.0
# the Gen4 teacher's logit spread: at phase 7's ST_LOGIT_STD its best
# obj * cls score over a window of 60 frames of 5040 anchors and 3
# classes was 0.0034 (on an H100), under ST_CONF, so that no box would
# reach the pseudo-label checks
GEN4_LOGIT_STD = 2.0

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


# the kernels that run only on a model mesh axis (phase 13, which checks
# their launches), never in a one-process step
MODEL_AXIS_KERNELS = ("block_residual_kernel",)


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
    profiled again (PROFILE_TRIES); where every window lost some, the
    mean is over the launches the fullest one recorded, if at least half
    (said on stderr)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = []
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
        if reps >= len(times) > len(best):
            best = times
    if 2 * len(best) < reps:
        fail(f"profiled {len(times)} launches of {kernel}, not {reps}, "
             f"{PROFILE_TRIES} times")
    print(f"chip_smoke: device_us({kernel}): the profiler recorded "
          f"{len(best)} of {reps} launches", file=sys.stderr, flush=True)
    return sum(best) / len(best)


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
    tokens and the block's heads (all, or a model rank's shard: o has
    oc = heads * dim_head channels): q|k|v, q k^T and p v; x read and o
    written once in bf16, the q|k|v weights and LN1's vectors."""
    c = blk.dim
    oc = blk.attn.qkv.weight.shape[0] // 3
    t = blk.partition_size[0] * blk.partition_size[1]
    flops = 2 * n_tok * c * 3 * oc + 4 * n_tok * t * oc
    mods = [blk.attn.qkv] + ([] if blk.skip_first_norm else [blk.norm1])
    wbytes = sum(p.numel() * p.element_size() for m in mods
                 for p in m.parameters())
    return flops, wbytes + n_tok * (c + oc) * 2


def mlp_tp_work(blk, n_tok: int):
    """(bf16 tensor-core FLOPs, bytes) of `block_mlp_tp` over n_tok
    tokens of a model rank's shard: both MLP layers over its inner
    units; x (bf16) and the summed projection a (fp32) read, x1 (bf16)
    and the partial p (fp32) written once, the shard's weights and the
    vectors."""
    c = blk.dim
    flops = 2 * n_tok * c * blk.mlp.proj_in.weight.shape[0]
    flops += 2 * n_tok * blk.mlp.proj_out.weight.shape[1] * c
    ps = [blk.attn.proj.bias, blk.ls1, blk.norm2.weight, blk.norm2.bias,
          blk.mlp.proj_in.weight, blk.mlp.proj_in.bias,
          blk.mlp.proj_out.weight]
    wbytes = sum(p.numel() * p.element_size() for p in ps if p is not None)
    return flops, wbytes + n_tok * c * (2 + 4 + 2 + 4)


def residual_work(blk, n_tok: int):
    """(fp32 operations, bytes) of `block_residual` over n_tok tokens:
    three a channel; x1 (bf16) and p (fp32) read, the output (bf16)
    written, the bias and LayerScale."""
    c = blk.dim
    vec = sum(p.numel() * p.element_size()
              for p in (blk.mlp.proj_out.bias, blk.ls2) if p is not None)
    return 3 * n_tok * c, vec + n_tok * c * (2 + 4 + 2)


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
    from leod_tpu_torch import native
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
    # the C++ host library builds with g++ beside the nvcc builds
    host = {}
    gxx = threading.Thread(target=lambda: host.update(lib=native.get_lib()))
    gxx.start()
    paths = _build.build_all()
    probe_log = nvcc.communicate(timeout=300)[0]
    gxx.join()
    if host["lib"] is None:
        fail("the C++ host library (leod_tpu_torch/native) did not build")
    if nvcc.returncode != 0:
        fail(f"nvcc failed for the sweep-chain probe:\n{probe_log}")
    dt = time.perf_counter() - t0
    for p in paths:
        with open(p + ".log") as f:
            report = [ln.strip() for ln in f if "spill" in ln
                      or ("ptxas info" in ln and ("Used" in ln
                                                  or "Compiling entry" in ln))]
        emit({"build": os.path.relpath(p, REPO), "ptxas": report,
              "mb": os.path.getsize(p) / 1e6})
    # the op library's steps (nvcc a source, g++ of torch_ops.cpp, the
    # link; empty where the library was on disk already)
    emit({"build_seconds": round(dt, 3),
          "op_library_steps_s": dict(_build.last_build), "card": card()})
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


def stage_inputs(det, seed: int, batch: int = B, space: int = 1):
    """(stage, NHWC shape, x, h, c) at each stage's `batch`-slot shape (a
    space rank's rows of it, h / `space`): seeded bf16 input and warm
    non-zero (h, c)."""
    import torch
    bb = det.cfg.backbone
    h_in, w_in = bb.in_res_hw
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for k, (dim, stride) in enumerate(zip(bb.stage_dims, bb.stage_strides)):
        shape = (batch, h_in // stride // space, w_in // stride, dim)
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        hs = (torch.randn(shape, device="cuda", generator=g) * 0.5
              ).to(torch.bfloat16)
        cs = (torch.randn(shape, device="cuda", generator=g) * 0.5
              ).to(torch.bfloat16)
        out.append((getattr(det.backbone, f"stage{k + 1}"), shape, x, hs, cs))
    return out


def kernel_row(kern, plain, flops, nbytes, peak=None, **extra):
    """One shape's entry: the kernel against its plain version (within
    KERNEL_TOL), both timed, the kernel's launch cost on the host, and
    its bound (bf16 tensor-core rate unless `peak`)."""
    err, tol, ok = compare_all(kern(), plain(), KERNEL_TOL)
    bms, by = bound(flops, nbytes, peak or PEAK_BF16)
    return dict(extra, max_abs_err=err, tol=tol, ok=ok, ms=cuda_ms(kern),
                plain_ms=cuda_ms(plain), host_us=enqueue_us(kern),
                flops=flops, bytes=nbytes, bound_ms=bms, bound_by=by)


def phase_kernels(det, batch: int = B, batches=KERNEL_BATCHES,
                  nms_images: int = 0, space: int = 1):
    """Every kernel against its plain version at the model's stage shapes
    for `batch` slots (a space rank's h / `space` rows of them: its
    window layout, and the grid layout after the exchange, a map of as
    many rows), each half of a block and the ConvLSTM update also at
    each of `batches`; the NMS at `nms_images` images (default
    `batch`)."""
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
    row = kernel_row

    for stage, shape, x, hs, cs in stage_inputs(det, seed=1, batch=batch,
                                                space=space):
        dim = shape[3]
        pairs = stage.pairs()
        wb, gb = pairs[0]

        n_tok = batch * shape[1] * shape[2]
        rows["fused_block_pair"].append(row(
            lambda: mc.fused_block_pair(x, wb, gb, ps, True, **kw),
            lambda: mc.fused_block_pair_plain(x, wb, gb, ps),
            *pair_work(pairs[0], x), shape=list(shape), batch=batch))

        o = torch.randn((n_tok, dim), device="cuda", generator=g
                        ).to(torch.bfloat16)
        # each half alone at each of `batches`, whose plans differ:
        # the attention half, window block (LN1 skipped, as in a stage's
        # first pair) and grid block, on the NHWC map; the per-token half
        # on x and an attention output o as rows. "plan" is what the
        # launch took: (windows a CTA, CTAs a cluster), CTAs a row tile.
        for bsz in batches:
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
                        attn_p, *attn_work(blk, xb.shape[0] * n_tok // batch),
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
        # `batches`, whose plans differ: "plan" is (rows a tile,
        # channels a tile, CTAs a cluster splitting K)
        gates = stage.lstm.gates
        for bsz in batches:
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
            *stage_work(pairs, gates, x, cs), shape=list(shape),
            batch=batch))

    # K3: `batch` images of K = 1000 score-sorted boxes, the model's
    # classes, and the staircases, whose chains run across every word of
    # the sweep
    kk = det.cfg.postprocess.pre_nms_topk
    n_cls = det.cfg.head.num_classes
    n_img = nms_images or batch
    gc = torch.Generator().manual_seed(2)
    ctr = torch.rand(n_img, kk, 2, generator=gc) * torch.tensor([w_in, h_in])
    wh = torch.rand(n_img, kk, 2, generator=gc) * 70 + 6
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).cuda()
    valid = (torch.rand(n_img, kk, generator=gc) > 0.05).cuda()
    ids = torch.randint(0, n_cls, (n_img, kk), generator=gc).float().cuda()
    thr = det.cfg.postprocess.nms_threshold
    inputs = {"random": (boxes, valid, ids),
              "staircase": staircases(n_img, kk)}

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
    ops = n_img * kk * (kk - 1) / 2 * 13
    nbytes = n_img * kk * (16 + 1 + 4 + 1)
    bms, by = bound(ops, nbytes, PEAK_FP32)
    # each kernel alone: nms_build_kernel does the IoU tests, reads the
    # boxes and class ids and writes the mask words on and above the
    # diagonal; nms_sweep_kernel reads those and valid and writes keep,
    # its bound (its design's latency floor is the variant phase's)
    words = (kk + 31) // 32
    mask_bytes = n_img * 4 * sum(min(32, kk - 32 * t) * (words - t)
                                 for t in range(words))
    build_ms, build_by = bound(ops, n_img * kk * (16 + 4) + mask_bytes,
                               PEAK_FP32)
    sweep_ms = (mask_bytes + 2 * n_img * kk) / PEAK_BYTES * 1e3
    nms_row = dict(shape=[n_img, kk, 4], max_abs_err=float(mismatches),
                   tol=0.0, batch=batch,
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


def _summary(name, replaces, source, shape_rows, launches, peak_ops,
             step_batch: int = B):
    """One kernel's entry: times, work and bound summed over the shapes
    one step of `step_batch` slots gives it (the rows at that batch,
    where a kernel was also run at others); the worst error relative to
    its tolerance over every row."""
    worst = max(shape_rows, key=lambda r: r["max_abs_err"] / max(r["tol"],
                                                                 1e-30))
    step_rows = [r for r in shape_rows if r["batch"] == step_batch]
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


def serve_requests(det, cfg, step, slots: int):
    """`ServingEngine` over `step` with `slots` slots answers requests
    from client threads: up to 3 streams of 4 frames, then one frame
    from each stream the slots still hold, then one from a new stream,
    which evicts the least recently used. Every kernel's launch count
    must rise by what the path implies per step. Returns (launches,
    steps, engine stats)."""
    import numpy as np
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.serve import ServingEngine, serve_input_shape

    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    per_step = launches_per_step(cfg)
    shape = serve_input_shape(cfg, slots)[1:]
    engine = ServingEngine(step, det.init_states(slots), shape,
                           device="cuda")
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

    first = min(3, slots)
    for w in wrappers:
        w.launches = 0
    run_clients([(f"s{i}", 4, i) for i in range(first)])  # 3 streams x 4
    run_clients([(f"s{i}", 1, i) for i in range(first, slots)])  # all held
    run_clients([(f"s{slots}", 1, slots)])               # evicts the LRU one
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
    if len(answers) != 4 * first + slots - first + 1 or \
            stats["streams"] != slots:
        fail(f"{len(answers)} answers, {stats['streams']} resident streams")
    for sid, a in answers:
        if a.ndim != 2 or a.shape[1] != 7 or not np.isfinite(a).all() \
                or a.shape[0] > cfg.model.postprocess.max_dets:
            fail(f"answer for {sid}: shape {a.shape}, finite "
                 f"{np.isfinite(a).all()}")
    return launches, steps, stats


def phase_slice(det, cfg):
    import numpy as np
    import torch
    from leod_tpu_torch.serve import make_serve_step, serve_input_shape

    shape = serve_input_shape(cfg, B)[1:]
    step = make_serve_step(det, conf_threshold=0.0)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    # warm up (cuDNN picks its algorithms) before counting
    step(det.init_states(B), torch.from_numpy(np.stack(
        frames(rng, B, shape))).to(dev), ones, ones)
    torch.cuda.synchronize()
    launches, steps, stats = serve_requests(det, cfg, step, B)

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
    but MODEL_AXIS_KERNELS must show up, unless `kernels_expected` is
    false (a train step, which runs the module forwards)."""
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
    missing = [k for k in kernels if k not in MODEL_AXIS_KERNELS and not any(
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


def phase_eval(det, cfg, seqs=None, reprs: int = EVAL_REPRS):
    """Streaming evaluation of a rendered val split (`seqs` of `reprs`
    reprs each, a window's worth of them labeled; by default the Gen1
    one rendered here) through `run_streaming_eval`: with the kernels
    (launches counted), with the plain versions, and with the kernels
    again (timed only); the NMS keep mask of a batch's B M images against
    the plain one on the kernel run's preds; one eval step profiled."""
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
    if seqs is None:
        seqs = render_array_sequences(
            dst, EVAL_SEQS, seed=0, num_reprs=reprs, hw=dst.resolution_hw,
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
    if n_batches != len(seqs) * reprs // (L * bv) or len(plain) != \
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
        "sequences": len(seqs), "reprs": reprs, "render_s": render_s,
        "batch": bv, "window": L, "frames_per_slot": m_slot,
        "batches": n_batches, "frames": sum(n for _, n, _ in kern),
        "kept_dets": sum(k for _, _, k in kern),
        "launches": launches, "parity": parity,
        f"nms_b{nb}": dict(nms, mismatches=mismatches, kept=kept),
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


def phase_train(cfg=None, splits=None, n_steps: int = TRAIN_STEPS,
                reprs: int = EVAL_REPRS, name: str = "rvt_b_gen1",
                label: str = "RVT-B gen1 (experiment_preset('gen1', 'base'))"):
    """(a) `Trainer.fit` for `n_steps` bf16 steps of `cfg` (by default RVT-B
    Gen1 at its full width and depth: B 8, L 21, M 6, remat "full") on a
    rendered train split (`splits`, by default phase 6's rendered here),
    validating once through `run_streaming_eval` and the kernels; (b)
    its step times, frames/s, peak memory, losses and one profiled step;
    (c) its checks."""
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

    if cfg is None:
        cfg = experiment_preset("gen1", "base")
    dst = cfg.dataset
    L, bt = dst.sequence_length, cfg.training.batch_size_train
    run_root = os.path.join(REPO, "runs", f"chip_smoke_train_{name}")
    shutil.rmtree(run_root, ignore_errors=True)
    cfg = replace(cfg, save_dir=run_root, exp_name=name,
                  training=replace(cfg.training,
                                   val_check_interval=n_steps))
    t0 = time.perf_counter()
    if splits is None:
        splits = render_array_dataset(
            dst, TRAIN_SEQS, TRAIN_SEQS, 0, seed=0, num_reprs=reprs,
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
        if rec.get("step") == n_steps and "loss" in rec:
            before_val.update({w.__name__: w.launches for w in wrappers})

    trainer.logger.add_sink(sink)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    state = trainer.fit(max_steps=n_steps, state=state, log_every=1,
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
    if state.step != n_steps or len(steps) != n_steps or \
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
    if path is None or restored.step != n_steps:
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
        "config": label,
        "batch": bt, "window": L,
        "frames_per_slot": default_frames_per_slot(L),
        "remat": cfg.training.remat, "compute": "bf16, fp32 parameters",
        "sampling": dst.train_sampling,
        "train_sequences": len(splits["train"]),
        "val_sequences": len(splits["val"]), "reprs": reprs,
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
        "restored_step": n_steps,
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


def perturb_teacher(trainer, seqs, cfg, logit_std: float = ST_LOGIT_STD):
    """The phase-6 model barely leaves its initialization in six warmup
    steps: LayerScale at 1e-5 and the YOLOX prior put every score at
    about 0.0101 (obj and class), so no box passes a threshold. As the
    serving phases do, the LayerScale is set from a seed (0); then the
    obj and class prediction kernels are scaled so that each kind's
    logits have a standard deviation of `logit_std` over the first
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
    scale = {"obj_pred": logit_std / float(_logits(p[..., 4]).std()),
             "cls_pred": logit_std / float(_logits(p[..., 5:]).std())}
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
            "tta_evaluate_ms": report_c["evaluate_ms"], "launches": total}


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


# ---------------------------------------------------------------------------
# Deploy phase
# ---------------------------------------------------------------------------

DEPLOY_OPS = ("block_attention", "block_mlp", "lstm_update", "nms_mask")


def write_recordings(raw_dir: str, seed: int):
    """DEPLOY_RECS .dat recordings of seeded events at 240 x 304 with the
    Gen1 release's `_bbox.npy` labels (a box of class 0 or 1 every
    100 ms); returns the events a recording."""
    import numpy as np
    from leod_tpu_torch.data.psee import EVENT_DTYPE, write_dat
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    span = int(DEPLOY_SECONDS * 1e6)
    counts = []
    for i in range(DEPLOY_RECS):
        n = int(rng.uniform(*DEPLOY_RATE) * DEPLOY_SECONDS)
        ev = np.empty(n, dtype=EVENT_DTYPE)
        ev["t"] = np.sort(rng.integers(0, span, n)).astype(np.uint32)
        ev["x"] = rng.integers(0, 304, n)
        ev["y"] = rng.integers(0, 240, n)
        ev["p"] = rng.integers(0, 2, n)
        write_dat(os.path.join(raw_dir, f"rec_{i:03d}.dat"), ev, height=240,
                  width=304)
        k = span // 100_000 - 1
        boxes = np.zeros(k, dtype=[("t", "<i8"), ("x", "<f4"), ("y", "<f4"),
                                   ("w", "<f4"), ("h", "<f4"),
                                   ("class_id", "<u4"),
                                   ("class_confidence", "<f4")])
        boxes["t"] = 100_000 * np.arange(1, k + 1)
        boxes["x"], boxes["y"] = (rng.uniform(0, 200, k) for _ in range(2))
        boxes["w"], boxes["h"] = (rng.uniform(10, 90, k) for _ in range(2))
        boxes["class_id"] = rng.integers(0, 2, k)
        boxes["class_confidence"] = 1.0
        np.save(os.path.join(raw_dir, f"rec_{i:03d}_bbox.npy"), boxes)
        counts.append(n)
    return counts


def serve_frame(chw, cfg):
    """A [2*bins, H, W] histogram as the serve step's input: NHWC, padded
    at the bottom and right to the model's input and folded for the
    stem (`harvest_frames`' layout)."""
    import numpy as np
    from leod_tpu_torch.config import stem_fold_hw
    from leod_tpu_torch.models.layers import fold_ev_hw
    h, w = cfg.model.backbone.in_res_hw
    hwc = np.zeros((h, w, chw.shape[0]), np.uint8)
    hwc[:chw.shape[1], :chw.shape[2]] = chw.transpose(1, 2, 0)
    assert stem_fold_hw(cfg.model) == (4, 4)
    return fold_ev_hw(hwc)


def _merge_inputs(rng):
    """MERGE_FRAMES frames of MERGE_ROWS pooled (x0, y0, x1, y1, obj,
    cls_conf, cls_id) rows: 4 views' jittered copies of 300 boxes, so
    that most rows overlap another."""
    import numpy as np
    out = []
    for _ in range(MERGE_FRAMES):
        xy = rng.uniform(0, 280, (300, 2))
        wh = rng.uniform(4, 80, (300, 2))
        base = np.concatenate([xy, xy + wh], 1)
        rows = np.concatenate([base + rng.normal(0, 3, base.shape)
                               for _ in range(MERGE_ROWS // 300)])
        out.append(np.concatenate(
            [rows, rng.uniform(0, 1, (MERGE_ROWS, 2)),
             rng.integers(0, 2, (MERGE_ROWS, 1))], 1).astype(np.float32))
    return out


def _coco_cases(rng, n: int):
    import numpy as np
    cases = []
    for _ in range(n):
        g, d = int(rng.integers(1, 20)), int(rng.integers(1, 100))
        gt = np.abs(rng.normal(30, 40, (g, 4))) + 1
        gt[:, :2] = rng.uniform(0, 250, (g, 2))
        dt = np.abs(gt[rng.integers(0, g, d)] + rng.normal(0, 6, (d, 4)))
        dt[:, 2:] += 1
        cases.append((gt, rng.uniform(size=g) < 0.2, dt,
                      rng.uniform(0, 1, d)))
    return cases


def phase_host_ops():
    """(b): the C++ host library, held index for index (NMS) and exactly
    (the COCO matcher) against the numpy versions, both timed."""
    import numpy as np
    from leod_tpu_torch import native
    from leod_tpu_torch.eval.coco import _evaluate_image_all_areas
    from leod_tpu_torch.ops.nms import batched_nms_numpy

    if native.get_lib() is None:
        fail("the C++ host library did not build or load")
    rng = np.random.default_rng(DEPLOY_SEED)
    frames_ = _merge_inputs(rng)
    cases = _coco_cases(rng, MERGE_FRAMES)

    def run():
        t0 = time.perf_counter()
        kept = [batched_nms_numpy(r[:, :4], r[:, 4] * r[:, 5], r[:, 6], 0.45)
                for r in frames_]
        t1 = time.perf_counter()
        matched = [_evaluate_image_all_areas(*c, 100) for c in cases]
        t2 = time.perf_counter()
        return kept, matched, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    kept_n, matched_n, nms_ms, coco_ms = run()
    lib = native._lib
    native._lib = None                      # the numpy versions alone
    try:
        kept_p, matched_p, nms_ms_p, coco_ms_p = run()
    finally:
        native._lib = lib
    for a, b in zip(kept_n, kept_p):
        if not np.array_equal(a, b):
            fail("the native NMS disagrees with the numpy NMS")
    for a, b in zip(matched_n, matched_p):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            fail("the native COCO matcher disagrees with the numpy one")
    return {"library": os.path.relpath(native.lib_path(), REPO),
            "merge_frames": MERGE_FRAMES, "merge_rows": MERGE_ROWS,
            "kept_mean": float(np.mean([len(k) for k in kept_n])),
            "nms_ms": nms_ms, "nms_numpy_ms": nms_ms_p,
            "coco_images": len(cases), "coco_ms": coco_ms,
            "coco_numpy_ms": coco_ms_p}


def phase_deploy(tta_evaluate_ms):
    """Phase 9: the deployed path at RVT-B Gen1, B 8, bf16: (a) raw
    recordings imported on the card, exactly as on the CPU; (b) the host
    ops; (c) `cli.export` of a checkpoint, the artifact loaded and held
    to the live step, its steps counted; (d) the HTTP server over the
    artifact, every answer held to a replay of its stream through the
    step. Returns its report and its launches (the artifact's steps and
    the server's)."""
    import base64
    import urllib.request
    import numpy as np
    import torch
    from leod_tpu_torch.cli import export as cli_export
    from leod_tpu_torch.cli import import_raw as cli_import
    from leod_tpu_torch.cli import serve as cli_serve
    from leod_tpu_torch.cli._common import load_detector
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.serve import (ServingEngine, load_artifact_exported,
                                      make_serve_step, program_module,
                                      zero_states_like)

    t_phase = time.perf_counter()
    root = os.path.join(REPO, "runs", "chip_smoke_deploy")
    shutil.rmtree(root, ignore_errors=True)
    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    cfg = experiment_preset("gen1", "base")
    dev = torch.device("cuda")
    report = {"config": "RVT-B gen1 (experiment_preset('gen1', 'base')), "
                        f"B {B}, bf16"}

    # (a) ingest on the card, and on the CPU for the reference
    raw = os.path.join(root, "raw")
    events = write_recordings(raw, DEPLOY_SEED)
    argv = ["--raw-dir", raw, "--split", "train", "--height", "240",
            "--width", "304"]
    store, store_cpu = {}, {}
    t0 = time.perf_counter()
    cli_import.main(argv + ["--out", os.path.join(root, "ds")], frames=store)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli_import.main(argv + ["--out", os.path.join(root, "ds_cpu"), "--cpu"],
                    frames=store_cpu)
    cpu_s = time.perf_counter() - t0
    if sorted(store) != sorted(store_cpu) or len(store) != DEPLOY_RECS:
        fail(f"ingest: {sorted(store)} on the card, {sorted(store_cpu)} on "
             f"the CPU")
    windows = 0
    for key, hist in store.items():
        windows += len(hist)
        if not np.array_equal(hist, store_cpu[key]):
            bad = int((hist != store_cpu[key]).sum())
            fail(f"ingest {key}: {bad} histogram counts differ from the "
                 f"CPU's")
        if hist.shape[1:] != (20, 240, 304) or not hist.any():
            fail(f"ingest {key}: frames {hist.shape}, all zero "
                 f"{not hist.any()}")
    report["ingest"] = {
        "recordings": DEPLOY_RECS, "events": int(sum(events)),
        "windows": windows, "card_s": card_s, "cpu_s": cpu_s,
        "events_per_s": sum(events) / card_s,
        "ms_per_window": card_s * 1e3 / windows,
        "cpu_events_per_s": sum(events) / cpu_s}
    emit({"deploy_ingest": report["ingest"]})

    # (b) the host ops
    report["host_ops"] = {**phase_host_ops(),
                          "tta_evaluate_ms_phase7": tta_evaluate_ms}
    emit({"deploy_host_ops": report["host_ops"]})

    # (c) export a checkpoint, load the artifact, hold it to the live step
    det = Detector(cfg.model, device=dev, seed=0)
    perturb_layerscale(det, seed=0)
    ckpt = os.path.join(root, "ckpt_deploy.pt")
    torch.save({"model": det.state_dict()}, ckpt)
    del det
    art = os.path.join(root, f"rvt_b_gen1_b{B}.pt2")
    t0 = time.perf_counter()
    cli_export.main(["--ckpt", ckpt, "--size", "base", "--batch-size",
                     str(B), "--conf", "0.0", "--out", art])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exported, meta = load_artifact_exported(art)
    step_fn = program_module(exported, dev)
    load_s = time.perf_counter() - t0
    live_det = load_detector(cfg.model, torch.bfloat16, dev, ckpt=ckpt)
    live = make_serve_step(live_det, conf_threshold=0.0, device=dev)
    keys = sorted(store)
    seqs = {k: [serve_frame(f, cfg) for f in store[k]] for k in keys}

    def batch_at(t):
        # slot i: recording i % 4 from window (i // 4) * 20 + t
        return torch.from_numpy(np.stack([
            seqs[keys[i % len(keys)]][(i // len(keys)) * 20 + t]
            for i in range(B)])).to(dev)

    flags = []
    for t in range(DEPLOY_STEPS):
        reset = [t == 0 or (t == 5 and i % 4 == 2) for i in range(B)]
        active = [not (t == 5 and i % 4 == 3) for i in range(B)]
        flags.append((torch.tensor(reset, device=dev),
                      torch.tensor(active, device=dev)))
    st = live_det.init_states(B)
    want = []
    for t, (reset, active) in enumerate(flags):
        st, d, v = live(st, batch_at(t), reset, active)
        want.append((st, d, v))
    torch.cuda.synchronize()
    per_step = {k: v for k, v in launches_per_step(cfg).items()
                if k in DEPLOY_OPS}
    _zero(wrappers)
    st = zero_states_like(exported, device=dev)
    worst = 0.0
    got = []
    for t, (reset, active) in enumerate(flags):
        before = _count(wrappers)
        st, d, v = step_fn(st, batch_at(t), reset, active)
        torch.cuda.synchronize()
        got.append((st, d, v))
        delta = {k: _count(wrappers)[k] - before[k] for k in per_step}
        if delta != per_step:
            fail(f"artifact step {t} launched {delta}; the live step "
                 f"launches {per_step}")
        w_st, w_d, w_v = want[t]
        if not torch.equal(v, w_v):
            fail(f"artifact step {t}: valid differs from the live step's")
        pairs = [(d, w_d)] + [(a, b) for sa, sb in zip(st, w_st)
                              for a, b in zip(sa, sb)]
        for a, b in pairs:
            a, b = a.float(), b.float()
            err = (a - b).abs() - DEPLOY_RTOL * b.abs()
            worst = max(worst, float(err.max()))
        if worst > DEPLOY_ATOL or not bool(d.isfinite().all()):
            fail(f"artifact step {t}: |artifact - live| - rtol |live| = "
                 f"{worst} > {DEPLOY_ATOL}")
    if not bool(want[-1][2].any()):
        fail("the live step kept no detection to compare")
    artifact_launches = _count(wrappers)
    report["export"] = {
        "export_s": export_s, "load_s": load_s,
        "artifact_mb": os.path.getsize(art) / 1e6,
        "platforms": meta["platforms"], "steps": DEPLOY_STEPS,
        "worst_excess_over_rtol": worst,
        "dets_valid_last_step": int(want[-1][2].sum()),
        "launches_a_step": per_step}
    emit({"deploy_export": report["export"]})
    del want, live, live_det

    # (c2) the same artifact with torch alone: no package, no toolkit
    inputs = {"ev": [batch_at(t).cpu() for t in range(DEPLOY_STEPS)],
              "reset": [r.cpu() for r, _ in flags],
              "active": [a.cpu() for _, a in flags]}
    report["standalone"] = deploy_standalone(art, inputs, got, per_step)
    emit({"deploy_standalone": report["standalone"]})
    del got, inputs

    # (d) the HTTP server over the artifact: 16 client streams, 8 slots
    record = []
    engine_box = []

    def recording_step(states, ev, reset, active):
        # the worker thread alone assigns slots, and it is here
        slots = {s: sid for sid, s in engine_box[0]._slots.items()}
        record.append((slots, reset.cpu().numpy(), active.cpu().numpy()))
        return step_fn(states, ev, reset, active)

    engine = ServingEngine(recording_step,
                           zero_states_like(exported, device=dev),
                           meta["frame_shape"], device=dev)
    engine_box.append(engine)
    server = cli_serve.make_server(engine, meta, "127.0.0.1", 0)
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    port = server.server_address[1]
    streams = {f"s{i:02d}": seqs[keys[i % len(keys)]][(i // len(keys)) * 8:]
               for i in range(DEPLOY_STREAMS)}
    sent = {sid: 0 for sid in streams}
    answers, client_ms, errors = [], [], []

    def client(sid, n):
        try:
            for _ in range(n):
                k = sent[sid]
                sent[sid] += 1
                body = json.dumps({"stream": sid, "frame_b64": base64.b64encode(
                    streams[sid][k].tobytes()).decode()}).encode()
                t0 = time.perf_counter()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/detect", data=body)
                with urllib.request.urlopen(req, timeout=300) as r:
                    out = json.loads(r.read())
                client_ms.append((time.perf_counter() - t0) * 1e3)
                answers.append((sid, k, np.asarray(out["boxes"],
                                                   np.float64).reshape(-1, 7)))
        except Exception as e:  # reported below, fails the run
            errors.append(f"{sid}: {e!r}")

    def run_clients(specs):
        ts = [threading.Thread(target=client, args=s) for s in specs]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=600)
        if any(th.is_alive() for th in ts):
            fail("a client thread did not finish")

    ids = sorted(streams)
    try:
        run_clients([(sid, 3) for sid in ids[:6]])      # 6 resident streams
        run_clients([(sid, 2) for sid in ids])          # 16: evictions
        run_clients([(sid, 2) for sid in ids[:6]])      # back, some reset
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/health",
                                    timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        engine.close()
    launches = _count(wrappers)
    if errors:
        fail(f"requests failed: {errors}")
    if health["steps"] != len(record) or health["slots"] != B:
        fail(f"health {health}, {len(record)} steps recorded")
    served = {k: launches[k] - artifact_launches[k] for k in per_step}
    if served != {k: v * len(record) for k, v in per_step.items()}:
        fail(f"the server's {len(record)} steps launched {served}")

    # replay each stream alone through the step, in the slot and with the
    # resets the engine gave it, and hold every answer to it
    history = {sid: [] for sid in streams}
    for slots, reset, active in record:
        for slot in np.flatnonzero(active):
            history[slots[int(slot)]].append((int(slot), bool(reset[slot])))
    got = {(sid, k): a for sid, k, a in answers}
    resets = sum(r for h in history.values() for _, r in h)
    if len(got) != sum(sent.values()) or not 0 < resets < len(got):
        fail(f"{len(got)} answers to {sum(sent.values())} requests, "
             f"{resets} of them after a reset")
    worst_http = 0.0
    for sid, hist in history.items():
        st = zero_states_like(exported, device=dev)
        for k, (slot, was_reset) in enumerate(hist):
            ev = np.zeros((B,) + tuple(meta["frame_shape"]), np.uint8)
            ev[slot] = streams[sid][k]
            one = torch.zeros(B, dtype=torch.bool, device=dev)
            one[slot] = True
            st, d, v = step_fn(st, torch.from_numpy(ev).to(dev),
                               one & was_reset, one)
            want_k = np.round(d[slot][v[slot]].cpu().numpy().astype(
                np.float64), 4)
            have = got[(sid, k)]
            if have.shape != want_k.shape:
                fail(f"stream {sid} request {k}: {len(have)} boxes, the "
                     f"replay {len(want_k)}")
            if len(have):
                worst_http = max(worst_http,
                                 float(np.abs(have - want_k).max()))
    if worst_http > DEPLOY_HTTP_ATOL:
        fail(f"HTTP answers differ from the replay by {worst_http}")
    stats = {k: health[k] for k in ("steps", "streams", "slots",
                                    "latency_ms_p50", "latency_ms_p95",
                                    "latency_ms_p99", "latency_n")}
    report["serve"] = {
        "streams": DEPLOY_STREAMS, "requests": len(got),
        "after_reset": resets, "worst_abs_diff": worst_http,
        "engine": stats,
        "client_ms_p50": float(np.percentile(client_ms, 50)),
        "client_ms_p99": float(np.percentile(client_ms, 99)),
        "boxes_mean": float(np.mean([len(a) for a in got.values()]))}
    emit({"deploy_serve": report["serve"]})
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    report["launches"] = launches
    return report


# ---------------------------------------------------------------------------
# Gen4 phase
# ---------------------------------------------------------------------------

def phase_remat(cfg, splits):
    """(d) Each TBPTT remat policy for REMAT_STEPS steps of `cfg`'s
    trainable model from the same seeded weights (a fresh copy: the
    parameters, the BN statistics and a new optimizer) on the same first
    batches of the train loader: the first step's loss and module
    gradient norms against "full"'s, the median host ms of steps 2..N
    (each ending in a synchronize) and the peak memory of the steps."""
    from dataclasses import replace
    import numpy as np
    import torch
    from leod_tpu_torch.config import stem_fold_hw
    from leod_tpu_torch.data.loader import harvest_frames
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.train.optim import make_optimizer
    from leod_tpu_torch.train.step import (REMAT_POLICIES, TrainState,
                                           make_train_step)
    from leod_tpu_torch.train.trainer import Trainer, default_frames_per_slot

    dst, mc = cfg.dataset, cfg.model
    L, bt = dst.sequence_length, cfg.training.batch_size_train
    m = default_frames_per_slot(L, mc.use_label_every)
    root = os.path.join(REPO, "runs", "chip_smoke_remat")
    trainer = Trainer(replace(cfg, save_dir=root, exp_name="remat"))
    loader, _ = trainer.make_train_loader(0, splits["train"])
    batches = []
    for batch in loader:
        hb = harvest_frames(batch, m, mc.head.max_gt, mc.backbone.in_res_hw,
                            use_label_every=mc.use_label_every,
                            ignore_label=mc.head.ignore_label,
                            ignore_image=mc.ignore_image,
                            fold_hw=stem_fold_hw(mc))
        batches.append({k: torch.from_numpy(np.ascontiguousarray(hb[k]))
                        .cuda() for k in ("ev", "is_first", "frame_t",
                                          "frame_mask", "labels")})
        if len(batches) == REMAT_STEPS:
            break
    trainer.close()
    shutil.rmtree(root, ignore_errors=True)
    det = Detector(mc, device="cuda", seed=0, trainable=True)
    perturb_layerscale(det, seed=0)
    weights = {k: v.clone() for k, v in det.state_dict().items()}
    keys = ("loss", "grad_norm/backbone", "grad_norm/fpn", "grad_norm/head")
    out = {}
    for remat in REMAT_POLICIES:
        det.load_state_dict(weights)
        det.zero_grad(set_to_none=True)
        opt, _ = make_optimizer(cfg.training, det.parameters())
        step = make_train_step(det, opt, remat=remat)
        state = TrainState(states=det.init_states(bt), step=0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms, first = [], None
        for hb in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, hb)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = {k: float(metrics[k]) for k in keys}
        out[remat] = {"first_step": first, "step_ms": ms,
                      "step_ms_median_2_to_n": statistics.median(ms[1:]),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "peak_over_start_gib":
                      (torch.cuda.max_memory_allocated() - base) / 2**30}
        del opt, step, state, metrics
    del det, weights, batches
    torch.cuda.empty_cache()
    full = out["full"]["first_step"]
    for remat, r in out.items():
        rel = {k: abs(r["first_step"][k] - full[k]) / max(abs(full[k]), 1e-30)
               for k in keys}
        r["rel_diff_to_full"] = rel
        if not all(np.isfinite(v) for v in r["first_step"].values()) or \
                rel["loss"] > REMAT_LOSS_RTOL or any(
                    rel[k] > REMAT_NORM_RTOL for k in keys[1:]):
            fail(f"remat {remat!r}'s first step {r['first_step']} against "
                 f"\"full\"'s {full}")
    peak = {k: r["peak_gib"] for k, r in out.items()}
    if not (peak["full"] < peak["dots"] < peak["none"]
            and peak["full"] < peak["stage1"] < peak["none"]):
        fail(f"the remat policies' peak memory does not rank full < dots < "
             f"none and full < stage1 < none: {peak}")
    return {"batch": bt, "window": L, "frames_per_slot": m,
            "steps": REMAT_STEPS, "policies": out,
            "tolerances": {"loss": REMAT_LOSS_RTOL,
                           "grad_norm": REMAT_NORM_RTOL}}


def render_gen4(cfg, num_val: int = GEN4_SEQS):
    """The Gen4 phase's rendered split: GEN4_SEQS train and `num_val` val
    sequences from seed 0, the train ones at `cfg`'s label ratio."""
    from leod_tpu_torch.data.synthetic import render_array_dataset
    dst = cfg.dataset
    return render_array_dataset(
        dst, GEN4_SEQS, num_val, 0, seed=0, num_reprs=GEN4_REPRS,
        hw=dst.resolution_hw, ds2=dst.downsample_by_factor_2,
        num_classes=cfg.model.head.num_classes,
        first_label_repr=EVAL_FIRST_LABEL, label_every=EVAL_LABEL_EVERY)


def phase_gen4_pseudo(cfg, checkpoint: str):
    """(e) `PseudoLabelRunner` with h-flip and t-flip (Gen4's window
    offset) over the train sequences at the WSOD label ratio ST_RATIO
    (so that frames without GT exist), the teacher the train phase's
    model through `perturb_teacher`: through the kernels (launches
    counted, timed) and through the plain versions, held as phase 7(a)
    holds them. Returns its report and the kernel run's launches."""
    from dataclasses import replace
    import torch
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.selftrain.pseudo_labeler import PseudoLabelConfig
    from leod_tpu_torch.selftrain.runner import PseudoLabelRunner
    from leod_tpu_torch.selftrain.verify import verify_pseudo_dataset
    from leod_tpu_torch.train.trainer import Trainer

    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    root = os.path.join(REPO, "runs", "chip_smoke_gen4_pseudo")
    shutil.rmtree(root, ignore_errors=True)
    pp = replace(cfg.model.postprocess, confidence_threshold=ST_CONF)
    cfg = replace(cfg, dataset=replace(cfg.dataset, ratio=ST_RATIO),
                  model=replace(cfg.model, postprocess=pp),
                  save_dir=root, training=replace(cfg.training,
                                                  val_check_interval=0))
    dst = cfg.dataset
    L, be = dst.sequence_length, cfg.training.batch_size_eval
    n_cls = cfg.model.head.num_classes
    seqs = render_gen4(cfg, num_val=0)["train"]
    teacher_tr = Trainer(replace(cfg, exp_name="teacher"))
    teacher_tr.load_weights(checkpoint, teacher_tr.init_state(be))
    score0, score1, scale = perturb_teacher(teacher_tr, seqs, cfg,
                                            GEN4_LOGIT_STD)
    teacher = teacher_tr.eval_detector()
    pl = PseudoLabelConfig(obj_thresh=(ST_OBJ,) * n_cls,
                           cls_thresh=(ST_CLS,) * n_cls,
                           min_track_len=ST_MIN_TRACK, tta_hflip=True,
                           tta_tflip=True)
    pse = {k: os.path.join(root, f"pseudo_{k}") for k in ("kernel", "plain")}
    kern, plain, tim = [], [], {}
    _zero(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = PseudoLabelRunner(teacher, cfg, pl, pse["kernel"],
                                sequences=seqs, on_batch=_preds_hook(kern),
                                timings=tim).run()
    wall = time.perf_counter() - t0
    launches = _count(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    PseudoLabelRunner(teacher, cfg, pl, pse["plain"], sequences=seqs,
                      plain=True, on_batch=_preds_hook(plain)).run()
    n_batches = len(kern)
    want = _implied(cfg, L * n_batches, n_batches)
    if n_batches != 2 * len(seqs) * GEN4_REPRS // (L * be) or \
            launches != want:
        fail(f"Gen4 pseudo-labelling: {n_batches} batches, launches "
             f"{launches}; the runs imply {want}")
    if kern[0][0].shape != (2 * be * L,) + tuple(kern[0][0].shape[1:]) \
            or kern[0][0].shape[-1] != 5 + n_cls:
        fail(f"Gen4 pseudo-label preds {tuple(kern[0][0].shape)}: not "
             f"{2 * be} slots x {L} frames of 5 + {n_cls} columns")
    parity = _parity(kern, plain, "Gen4 pseudo-labels")
    nms = _nms_exact(kern, cfg, "Gen4 pseudo-labels")
    counts = {k: _dataset_counts(v, dst) for k, v in pse.items()}
    if counts["kernel"]["pseudo"] < 1:
        fail(f"the Gen4 pseudo dataset holds no pseudo box: {counts}")
    checked = verify_pseudo_dataset(pse["kernel"], dst, sample_frac=1.0,
                                    sequences=seqs)
    agree = _compare_datasets(pse["kernel"], pse["plain"], dst)
    if min(agree["frac_kernel"], agree["frac_plain"]) < ST_MATCH_FRAC:
        fail(f"the Gen4 kernel and plain runs' pseudo datasets disagree: "
             f"{agree}")
    teacher_tr.close()
    shutil.rmtree(root, ignore_errors=True)
    return {
        "teacher_max_score_unperturbed": score0, "teacher_max_score": score1,
        "pred_kernel_scale": scale, "tflip_offset": dst.tflip_offset,
        "batches": n_batches, "slots": 2 * be, "window": L,
        "nms_images_a_batch": 2 * be * L, "launches": launches,
        "parity": parity, "nms": nms, "boxes": counts,
        "verified_sequences": checked, "agreement": agree,
        "metrics": {k: v for k, v in metrics.items()
                    if k.startswith(("ssod/teacher_AP", "ssod/teacher_AR"))},
        "wall_s": wall, "frames_per_s": n_batches * 2 * be * L / wall,
        "host_ms_per_batch": {k: _med(tim[k][1:]) for k in (
            "harvest_ms", "step_ms", "postprocess_ms", "consume_ms")},
        "pass_s": tim["pass_s"], "save_s": tim["save_s"],
        "peak_mem_gib": peak}


def drive_gen4():
    """Phase 10: RVT-B Gen4 (`experiment_preset("gen4", "base")`) at full
    width and depth, seeded, LayerScale from seed 0: (a) the kernel phase
    at its stage shapes and the serving engine at 8 and 1 slots, (b)
    streaming eval, (c) `Trainer.fit`, (d) the remat policies, (e)
    pseudo-labels. Returns its report and its kernels' entries of the
    JSON line ("<name>[Gen4]")."""
    import torch
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.serve import make_serve_step

    t_phase = time.perf_counter()
    cfg = experiment_preset("gen4", "base")
    name = "RVT-B gen4 (experiment_preset('gen4', 'base'))"
    if cfg.training.batch_size_eval != GEN4_BATCH or \
            cfg.training.batch_size_train != GEN4_BATCH:
        fail(f"the Gen4 preset's batches are not {GEN4_BATCH}")
    report = {"config": name, "in_res_hw": cfg.model.backbone.in_res_hw,
              "partition": cfg.model.backbone.partition_size,
              "classes": cfg.model.head.num_classes}
    det = Detector(cfg.model, device="cuda", seed=0)
    perturb_layerscale(det, seed=0)

    # (a) the kernels at the Gen4 stage shapes, then the serving engine
    t0 = time.perf_counter()
    rows, nms_row = phase_kernels(det, GEN4_BATCH, GEN4_KERNEL_BATCHES)
    emit({"kernel_phase": {"config": name, **rows, "nms_mask": [nms_row]}})
    for kind, kind_rows in rows.items():
        if not all(r["ok"] for r in kind_rows):
            fail(f"Gen4 {kind} disagrees with its plain version: "
                 f"{[(r['shape'], r['max_abs_err'], r['tol']) for r in kind_rows]}")
    if not nms_row["ok"]:
        fail(f"the Gen4 NMS keep mask differs in {nms_row['max_abs_err']} "
             f"boxes")
    report["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, steps, stats, parity, timing = phase_slice(det, cfg)
    one = serve_requests(det, cfg, make_serve_step(det, conf_threshold=0.0),
                         1)
    serve = {"slots": B, "steps": steps, "launches": launches,
             "parity": parity, **timing, "engine_stats": stats,
             "one_slot": {"steps": one[1], "launches": one[0],
                          "engine_stats": one[2]},
             "seconds": time.perf_counter() - t0}
    emit({"gen4_serve": serve})

    # (b) streaming eval on the rendered val split
    t0 = time.perf_counter()
    splits = render_gen4(cfg)
    report["render_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = phase_eval(det, cfg, seqs=splits["val"], reprs=GEN4_REPRS)
    ev["seconds"] = time.perf_counter() - t0
    emit({"gen4_eval": ev})
    del det
    torch.cuda.empty_cache()

    # (c) training, (d) the remat policies, (e) pseudo-labels
    t0 = time.perf_counter()
    train = phase_train(cfg, splits, n_steps=GEN4_TRAIN_STEPS,
                        reprs=GEN4_REPRS, name="rvt_b_gen4", label=name)
    train["seconds"] = time.perf_counter() - t0
    emit({"gen4_train": {k: v for k, v in train.items()
                         if k != "checkpoint"}})
    t0 = time.perf_counter()
    remat = phase_remat(cfg, splits)
    remat["seconds"] = time.perf_counter() - t0
    emit({"gen4_remat": remat})
    t0 = time.perf_counter()
    pseudo = phase_gen4_pseudo(cfg, train["checkpoint"])
    pseudo["seconds"] = time.perf_counter() - t0
    emit({"gen4_pseudo": pseudo})
    shutil.rmtree(os.path.dirname(os.path.dirname(train["checkpoint"])),
                  ignore_errors=True)

    out = kernel_entries(rows, nms_row, "[Gen4]", step_batch=GEN4_BATCH)
    for e in out:
        kname = e["name"][:-len("[Gen4]")]
        e["config"] = name
        e["launches_serve"] = launches[kname] + one[0][kname]
        e["launches_eval"] = ev["launches"].get(kname, 0)
        e["launches_train"] = train["launches"].get(kname, 0)
        e["launches_selftrain"] = pseudo["launches"].get(kname, 0)
        e["launches"] = (e["launches_serve"] + e["launches_eval"]
                         + e["launches_train"] + e["launches_selftrain"])
    # one process's remat peaks: phase 12's yardstick
    report["remat_peak_gib"] = {k: r["peak_gib"]
                                for k, r in remat["policies"].items()}
    report["phase_s"] = time.perf_counter() - t_phase
    return report, out


def deploy_standalone(art: str, inputs, got, per_step) -> dict:
    """Run the artifact `art` through `artifact.py` alone in a fresh
    `python -I` process (see phase 9c) on `inputs`; hold its every step
    to `got` (the in-process artifact's (states, dets, valid)) bit for
    bit and its launches to `per_step`."""
    import torch
    from leod_tpu_torch.ops import _build
    lone = tempfile.mkdtemp(prefix="leod_artifact_")
    try:
        shutil.copy(os.path.join(REPO, "leod_tpu_torch", "artifact.py"),
                    lone)
        shutil.copy(art, os.path.join(lone, "model.pt2"))
        torch.save(inputs, os.path.join(lone, "in.pt"))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PYTHON")
               and k not in ("CUDA_HOME", "CUDA_PATH")}
        env["PATH"] = os.pathsep.join(
            p for p in env.get("PATH", "").split(os.pathsep)
            if p and not os.path.exists(os.path.join(p, "nvcc")))
        env["TMPDIR"] = lone
        if shutil.which("nvcc", path=env["PATH"]):
            fail("deploy standalone: nvcc is still on the PATH")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-I", "artifact.py", "model.pt2", "--inputs",
             "in.pt", "--out", "out.pt", "--device", "cuda"],
            cwd=lone, env=env, capture_output=True, text=True, timeout=600)
        wall_s = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f"deploy standalone: artifact.py exited {res.returncode}:\n"
                 f"{res.stderr[-4000:]}")
        out = torch.load(os.path.join(lone, "out.pt"))
        lib = out["op_library"]
        if not lib["path"].startswith(lone) or out["modules"]:
            fail(f"deploy standalone: ops from {lib['path']}, modules "
                 f"{out['modules']}")
        if lib["build"] != _build.build_key():
            fail(f"deploy standalone: build {lib['build']}, the package's "
                 f"is {_build.build_key()}")
        for t, (st, d, v) in enumerate(got):
            pairs = [(out["dets"][t], d), (out["valid"][t], v)] + [
                (a, b) for sa, sb in zip(out["states"][t], st)
                for a, b in zip(sa, sb)]
            for a, b in pairs:
                if a.dtype != b.dtype or not torch.equal(a, b.cpu()):
                    fail(f"deploy standalone step {t}: an output differs "
                         f"from the in-process artifact's")
            launched = {k: out["launches"][t][k] for k in per_step}
            if launched != per_step or any(
                    n for k, n in out["launches"][t].items()
                    if k not in per_step):
                fail(f"deploy standalone step {t} launched "
                     f"{out['launches'][t]}; the live step launches "
                     f"{per_step}")
        with open(art + ".json") as f:
            lib_mb = json.load(f)["op_library"]["bytes"] / 1e6
        return {"steps": len(got), "load_s": out["load_s"],
                "load_ops_s": out["load_ops_s"],
                "load_program_s": out["load_program_s"],
                "module_s": out["module_s"],
                "step_ms": out["step_ms"],
                "step_ms_median_after_first": statistics.median(
                    out["step_ms"][1:]),
                "process_wall_s": wall_s,
                "artifact_mb": os.path.getsize(art) / 1e6,
                "library_mb": lib_mb, "variant": lib["variant"],
                "build": lib["build"],
                "op_library_build_s": dict(_build.last_build),
                "bit_equal": True, "launches_a_step": per_step,
                "card": card()}
    finally:
        shutil.rmtree(lone, ignore_errors=True)


# ---------------------------------------------------------------------------
# Data-parallel phase (11)
# ---------------------------------------------------------------------------

def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _checksum(module) -> str:
    """sha256 of a module's parameters and buffers, byte for byte."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().reshape(-1).cpu().contiguous()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _bn_running(module) -> dict:
    """Every BN running mean and variance of `module`, in fp32 copies."""
    return {k: v.detach().float().clone()
            for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _params(module) -> dict:
    """The trainable parameters of `module`, fp32 copies on the host."""
    return {k: v.detach().float().cpu().clone()
            for k, v in module.named_parameters() if v.requires_grad}


class StepSpy:
    """While entered, every train step that `train.trainer` makes records
    its metrics, its host ms (ending in a synchronize; the checksum
    after it is not timed) and the checksum of the model's parameters
    and BN statistics after it, then calls each of `hooks` with the
    number of steps taken; every `Trainer.fit` collects `timings`
    (among them the gradient all-reduce's "allreduce_ms"); `checksum`
    (default `_checksum`) digests the model after each step. With
    `first_step`, `first` holds, on the host, the first step's head
    outputs ("preds"), each BN running statistic's move in that step
    ("bn"), the parameters before and after it ("w0", "w1") and their
    gradients, clipped ("g1")."""
    KEYS = ("loss", "grad_norm", "grad_norm/backbone", "grad_norm/fpn",
            "grad_norm/head", "num_fg")

    def __init__(self, first_step: bool = False, checksum=None):
        self.steps, self.timings, self.hooks = [], {}, []
        self.first_step, self.first = first_step, None
        self.checksum = checksum or _checksum

    def __enter__(self):
        import torch
        from leod_tpu_torch.train import trainer as T
        self._T, self._orig = T, (T.make_train_step, T.Trainer.fit)
        make, fit = self._orig
        spy = self

        def make_step(det, *a, **k):
            if spy.first_step:
                k["with_preds"] = True
            step = make(det, *a, **k)

            def run(state, batch):
                record = spy.first_step and not spy.steps
                if record:
                    before, w0 = _bn_running(det), _params(det)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if record:
                    spy.first = {"preds": m["preds"].float().cpu(), "bn": {
                        k: (v - before[k]).cpu()
                        for k, v in _bn_running(det).items()},
                        "w0": w0, "w1": _params(det), "g1": {
                            k: v.grad.detach().float().cpu().clone()
                            for k, v in det.named_parameters()
                            if v.requires_grad}}
                spy.steps.append({"step_ms": ms,
                                  "checksum": spy.checksum(det),
                                  **{k: float(m[k]) for k in spy.KEYS}})
                for hook in spy.hooks:
                    hook(len(spy.steps))
                return state, m
            return run

        def fit_timed(trainer, *a, **k):
            k.setdefault("timings", spy.timings)
            return fit(trainer, *a, **k)

        T.make_train_step, T.Trainer.fit = make_step, fit_timed
        return self

    def __exit__(self, *exc):
        self._T.make_train_step, self._T.Trainer.fit = self._orig


def dp_frames(root: str, cfg):
    """Phase 10's rendered Gen4 split (GEN4_SEQS train and val sequences,
    seed 0) as a frame store, its label files under `root`."""
    from leod_tpu_torch.data.synthetic import render_dataset_frames
    dst = cfg.dataset
    return render_dataset_frames(
        root, GEN4_SEQS, GEN4_SEQS, 0, seed=0, num_reprs=GEN4_REPRS,
        hw=dst.resolution_hw, ds2=dst.downsample_by_factor_2,
        num_classes=cfg.model.head.num_classes,
        first_label_repr=EVAL_FIRST_LABEL, label_every=EVAL_LABEL_EVERY)


def dp_argv(root: str, save_dir: str, exp: str, mesh: bool):
    """`cli.train` at the Gen4 preset (B 12, L 5, remat "full"), stream
    sampling, DP_STEPS steps, no validation inside fit, in fp32: in bf16
    a rank's B 6 and one process's B 12 round the convolutions apart
    (cuDNN picks its algorithm by shape), and at random weights SimOTA's
    costs are near-ties, so an anchor's assignment flips between the two
    and moves the loss by percents."""
    argv = ["--dataset", "gen4", "--size", "base", "--path", root,
            "--steps", str(DP_STEPS), "--sampling", "stream", "--fp32",
            "--save-dir", save_dir, "--exp-name", exp, "--val-every", "0"]
    return argv + (["--mesh", str(DP_WORLD)] if mesh else [])


def dp_bf16_cfg(cfg, save_dir: str, exp: str):
    """(d)'s fit: the preset in bf16 (B 12, L 5, remat "full"), stream
    sampling, no validation, the stop exchanged after every step."""
    from dataclasses import replace
    return replace(cfg, save_dir=save_dir, exp_name=exp,
                   dataset=replace(cfg.dataset, train_sampling="stream"),
                   training=replace(cfg.training, val_check_interval=0,
                                    multihost_sync_every=1,
                                    max_steps=DP_STOP_MAX))


def _eval_hook(store):
    """run_streaming_eval's on_batch that keeps each labeled frame's
    preds row (on the host) under the hash of its event frame and GT
    boxes, and each batch's preds for the NMS check."""
    import hashlib
    import numpy as np

    def on_batch(bi, hb, preds, dets, valid):
        mslot = hb["frame_t"].shape[1]
        for b, row in enumerate(hb["boxes"]):
            for m, lab in enumerate(row):
                if lab is not None:
                    t = int(hb["frame_t"][b, m])
                    h = hashlib.sha1(np.ascontiguousarray(hb["ev"][t, b]))
                    h.update(lab.arr.tobytes())
                    store["frames"][h.hexdigest()] = \
                        preds[b * mslot + m].float().cpu()
        store["batches"].append((preds.detach().clone(), int(valid.sum())))
    return on_batch


def dp_rank(rank: int, port: int, out: str) -> None:
    """One rank of phase 11(b)-(d) (`--dp-rank`): joins the gloo group
    of DP_WORLD ranks on the one card, then (b) `cli.train --mesh` for
    DP_STEPS steps and a validation sharded over the ranks, (c) online
    SSOD, (d) a fit that rank 1's SIGTERM stops. Writes its report to
    <out>/rank<r>.json and its eval frames to <out>/eval<r>.pt."""
    import signal
    from dataclasses import replace
    import torch
    from leod_tpu_torch.cli import train as cli_train
    from leod_tpu_torch.cli._common import load_detector, open_split, ratio_of
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.parallel.mesh import make_mesh
    from leod_tpu_torch.selftrain import online
    from leod_tpu_torch.train.trainer import Trainer, run_streaming_eval

    # a SIGTERM outside fit (whose handler turns it into a stop) is
    # recorded, not fatal: (d) then fails on its step count
    late = []
    signal.signal(signal.SIGTERM, lambda *a: late.append(time.time()))
    t0 = time.perf_counter()
    join_ranks(rank, port, DP_WORLD)
    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    root = os.path.join(out, f"data{rank}")
    cfg = experiment_preset("gen4", "base")
    cfg = replace(cfg, dataset=replace(cfg.dataset, path=root))
    dst = cfg.dataset
    L = dst.sequence_length
    frames = dp_frames(root, cfg)
    report = {"rank": rank, "device": torch.cuda.current_device(),
              "start_s": time.perf_counter() - t0}

    # (b) training through the CLI, then one sharded validation
    save = os.path.join(out, "runs")
    spy = StepSpy(first_step=True)
    _zero(wrappers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with spy:
        final = cli_train.main(dp_argv(root, save, "dp", True),
                               frames=frames)
    report["train"] = {
        "cli_s": time.perf_counter() - t0, "step": final.step,
        "steps": spy.steps, "allreduce_ms": spy.timings.get("allreduce_ms"),
        "wait_ms": spy.timings.get("wait_ms"),
        "local_slots": int(final.states[0][0].shape[0]),
        "launches": _count(wrappers),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rank == 0:
        torch.save(spy.first["w1"], os.path.join(out, "w1.pt"))
    del spy
    ckpt = os.path.join(save, "dp", "ckpt_last.pt")
    det = load_detector(cfg.model, torch.bfloat16, "cuda", ckpt=ckpt)
    store = {"frames": {}, "batches": []}
    _zero(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run_streaming_eval(
        det, cfg, "val", device="cuda", on_batch=_eval_hook(store),
        sequences=open_split(dst, "val", frames,
                             seq_ratio=ratio_of(dst, "val")))
    torch.cuda.synchronize()
    report["eval"] = {"val_s": time.perf_counter() - t0, "metrics": metrics,
                      "frames": len(store["frames"]),
                      "launches": _count(wrappers)}
    report["eval"]["nms"] = _nms_exact(store["batches"], cfg,
                                       f"rank {rank}'s eval")
    torch.save(store["frames"], os.path.join(out, f"eval{rank}.pt"))
    del det, store
    torch.cuda.empty_cache()

    # (c) online SSOD: a teacher a rank over its own rows, at B_local
    pp = replace(cfg.model.postprocess, confidence_threshold=ST_CONF)
    oc = replace(cfg.training.ssod_online, enabled=True,
                 burn_in_steps=DP_SSOD_BURN_IN, obj_thresh=ST_OBJ,
                 cls_thresh=ST_CLS)
    scfg = replace(cfg, model=replace(cfg.model, postprocess=pp),
                   save_dir=save, exp_name="dp_ssod",
                   training=replace(cfg.training, ssod_online=oc,
                                    val_check_interval=0,
                                    max_steps=DP_SSOD_BURN_IN + DP_SSOD_STEPS))
    train_seqs = open_split(dst, "train", frames)
    mesh = make_mesh(DP_WORLD)
    trainer = Trainer(scfg, mesh=mesh)
    state = trainer.load_weights(ckpt, trainer.init_state(GEN4_BATCH))
    perturb_teacher(trainer, open_split(dst, "train", frames), scfg,
                    GEN4_LOGIT_STD)
    trainer.replicate()
    teacher_preds = []
    make_eval_step = online.make_eval_step

    def recording_eval_step(det, **kw):
        step = make_eval_step(det, **kw)

        def run(states, hb):
            states, preds = step(states, hb)
            if len(teacher_preds) < 2:
                teacher_preds.append((preds.detach().clone(), 0))
            return states, preds
        return run

    spy = StepSpy()
    online.make_eval_step = recording_eval_step
    _zero(wrappers)
    t0 = time.perf_counter()
    try:
        with spy:
            state = trainer.fit(state=state, log_every=1,
                                sequences=train_seqs)
    finally:
        online.make_eval_step = make_eval_step
    torch.cuda.synchronize()
    batcher = trainer.ssod_batcher
    launches = _count(wrappers)
    n_batches = len(batcher.teacher_ms)
    report["ssod"] = {
        "fit_s": time.perf_counter() - t0, "step": state.step,
        "steps": spy.steps, "teacher_rows": int(batcher.states[0][0].shape[0]),
        "teacher_batches": n_batches, "merged": batcher.merged,
        "teacher_ms": batcher.teacher_ms,
        "teacher_update_ms": spy.timings.get("teacher_update_ms"),
        "launches": launches,
        "launches_implied": _implied(scfg, L * n_batches, n_batches)}
    report["ssod"]["nms"] = _nms_exact(teacher_preds, scfg,
                                       f"rank {rank}'s teacher")
    trainer.close()
    del trainer, batcher, teacher_preds
    torch.cuda.empty_cache()

    # (d) the stop: the parent sends rank 1 a SIGTERM once
    # <out>/steps1 says its DP_STOP_AT-th step is done; the first step's
    # head outputs and BN moves go to <out>/first<r>.pt
    trainer = Trainer(dp_bf16_cfg(cfg, save, "dp_stop"), mesh=mesh)
    state = trainer.init_state(GEN4_BATCH)
    spy = StepSpy(first_step=True)

    def progress(n):
        with open(os.path.join(out, f"steps{rank}.tmp"), "w") as f:
            f.write(str(n))
        os.replace(os.path.join(out, f"steps{rank}.tmp"),
                   os.path.join(out, f"steps{rank}"))
    spy.hooks.append(progress)
    with spy:
        state = trainer.fit(state=state, log_every=1, sequences=train_seqs)
    trainer.close()
    torch.save(spy.first, os.path.join(out, f"first{rank}.pt"))
    report["stop"] = {"step": state.step, "late_sigterm": bool(late),
                      "checksum": spy.steps[-1]["checksum"]
                      if spy.steps else None,
                      "step_ms": [s["step_ms"] for s in spy.steps],
                      "allreduce_ms": spy.timings.get("allreduce_ms")}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def launch_ranks(out: str, flag: str, prefix: str, n: int):
    """Starts `n` rank processes of this script (`flag` r port out), their
    output in <out>/<prefix><r>.log."""
    port = _free_port()
    env = dict(os.environ)
    procs, logs = [], []
    for r in range(n):
        logs.append(open(os.path.join(out, f"{prefix}{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(r),
             str(port), out], cwd=REPO, env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    return procs, logs


def wait_ranks(procs, logs, out: str, what: str, prefix: str,
               timeout_s: float, tick=None) -> list:
    """Waits for the ranks (calling `tick` between polls); a rank that
    fails or outlives `timeout_s` fails `what`, and every rank is
    killed. Returns each rank's <out>/<prefix><r>.json."""
    deadline = time.time() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline:
                fail(f"{what}'s ranks outlived {timeout_s} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if tick is not None:
                tick()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(out, f"{prefix}{r}.log")) as f:
                tails.append(f"rank {r} (rc {procs[r].returncode}): "
                             f"{f.read()[-4000:]}")
        fail(f"{what}'s ranks failed:\n" + "\n".join(tails))
    reports = []
    for r in range(len(procs)):
        with open(os.path.join(out, f"{prefix}{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def dp_launch(out: str):
    """Starts the DP_WORLD rank processes of phase 11 (`--dp-rank`)."""
    return launch_ranks(out, "--dp-rank", "rank", DP_WORLD)


def dp_wait(procs, logs, out: str) -> list:
    """Waits for the ranks, sending rank 1 its SIGTERM once it reports
    DP_STOP_AT steps of (d); a rank that fails or outlives
    DP_RANK_TIMEOUT_S fails the phase, and every rank is killed."""
    import signal
    sent = []
    marker = os.path.join(out, "steps1")

    def tick():
        if not sent and os.path.exists(marker):
            with open(marker) as f:
                if int(f.read() or 0) >= DP_STOP_AT:
                    procs[1].send_signal(signal.SIGTERM)
                    sent.append(time.time())
    reports = wait_ranks(procs, logs, out, "phase 11", "rank",
                         DP_RANK_TIMEOUT_S, tick)
    if not sent:
        fail("rank 1 never reported the stop run's steps")
    return reports


def phase_dp_nccl(cfg, splits):
    """(a) DP_NCCL_STEPS steps of `Trainer.fit` (B 12, L 5, stream) under a
    one-rank NCCL group, against the same run without a group: the
    losses and every parameter and BN statistic bit-equal. cuDNN and
    the scatter-adds run their deterministic algorithms for both runs."""
    import datetime
    from dataclasses import replace
    import torch
    import torch.distributed as dist
    from leod_tpu_torch.parallel.mesh import make_mesh
    from leod_tpu_torch.train.trainer import Trainer

    root = os.path.join(REPO, "runs", "chip_smoke_dp_nccl")
    shutil.rmtree(root, ignore_errors=True)
    cfg = replace(cfg, save_dir=root,
                  dataset=replace(cfg.dataset, train_sampling="stream"),
                  training=replace(cfg.training, val_check_interval=0))
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)

    def run(mesh, exp):
        records = []
        trainer = Trainer(replace(cfg, exp_name=exp), mesh=mesh)
        trainer.logger.add_sink(records.append)
        t0 = time.perf_counter()
        trainer.fit(max_steps=DP_NCCL_STEPS, log_every=1,
                    sequences=splits["train"])
        torch.cuda.synchronize()
        trainer.close()
        sd = {k: v.detach().clone() for k, v in trainer.det.state_dict().items()}
        return [r["loss"] for r in records if "loss" in r], sd, \
            time.perf_counter() - t0

    try:
        losses0, sd0, s0 = run(None, "alone")
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
        try:
            losses1, sd1, s1 = run(make_mesh(1), "nccl")
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags[:2]
        torch.use_deterministic_algorithms(flags[2])
    differ = [k for k in sd0 if not torch.equal(sd0[k], sd1[k])]
    if losses0 != losses1 or differ or len(losses0) != DP_NCCL_STEPS:
        fail(f"one-rank NCCL training is not the run without a group: "
             f"losses {losses1} against {losses0}, {len(differ)} tensors "
             f"differ ({differ[:3]})")
    shutil.rmtree(root, ignore_errors=True)
    return {"steps": DP_NCCL_STEPS, "losses": losses1, "bit_equal": True,
            "tensors": len(sd0), "fit_s": {"alone": s0, "nccl": s1}}


def step_parity(rank_steps, one_steps, what: str) -> list:
    """Rank 0's fp32 steps' relative differences to one process's first
    steps, held to phase 11's bars: every loss and num_fg and step 1's
    norms within DP_FP32_RTOL, the later norms within
    DP_FP32_LATER_NORM_RTOL; every rank's metrics finite."""
    import numpy as np
    steps = rank_steps[0]
    rel = [{k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            for k in StepSpy.KEYS} for got, want in zip(steps, one_steps)]
    limits = [{k: DP_FP32_RTOL if i == 0 or k in ("loss", "num_fg")
               else DP_FP32_LATER_NORM_RTOL for k in StepSpy.KEYS}
              for i in range(len(steps))]
    if len(one_steps) < len(steps) or not all(
            np.isfinite(s[k]) for r in rank_steps for s in r
            for k in StepSpy.KEYS) or any(
                r[k] > lim[k] for r, lim in zip(rel, limits) for k in r):
        fail(f"{what} {steps} against one process's {one_steps}: "
             f"relative differences {rel}")
    return rel


def whole_map_bf16_parity(firsts, refs, what: str) -> dict:
    """The first bf16 step's head outputs of ranks that each compute the
    whole map (space or model ranks): equal on every rank, of one
    process's shape, and no further from one process's fp32 step than
    DP_BF16_NOISE times one process's bf16 step (boxes and scores
    apart)."""
    import torch
    one16 = refs["first_one"][torch.bfloat16]["preds"]
    one32 = refs["first_one"][torch.float32]["preds"]
    if any(f.shape != one16.shape for f in firsts) or \
            not all(torch.equal(f, firsts[0]) for f in firsts):
        fail(f"{what}: the first bf16 head outputs "
             f"{[tuple(f.shape) for f in firsts]} are not one whole map "
             f"each, equal, of one process's {tuple(one16.shape)}")
    parity, ok = {}, True
    for cols, sl in (("boxes", slice(0, 4)), ("scores", slice(4, None))):
        def dist(a, b):
            return float((a[..., sl] - b[..., sl]).abs().max())
        e = {"ranks_fp32": dist(firsts[0], one32),
             "one_fp32": dist(one16, one32),
             "ranks_one": dist(firsts[0], one16),
             "max_plain": float(one16[..., sl].abs().max())}
        ok = ok and e["ranks_fp32"] <= DP_BF16_NOISE * e["one_fp32"]
        parity[cols] = e
    if not ok:
        fail(f"{what}: the first bf16 step against one process at B "
             f"{GEN4_BATCH}: {parity}")
    return parity


def dp_one_process(cfg, work: str, frames):
    """The one-process references of phases 11 and 12 on the rendered
    split (`frames`, its label files under <work>/data): `cli.train`'s
    DP_STEPS fp32 steps at B 12 (`dp_argv`), and the first step of
    `dp_bf16_cfg`'s fit at B 12 in bf16 and in fp32 (the yardstick of
    bf16's rounding). Returns (the CLI run's steps, seconds and peak
    GiB; its first step's parameters before and after it and clipped
    gradients; {dtype: the first step's `StepSpy.first`})."""
    import torch
    from leod_tpu_torch.cli import train as cli_train
    from leod_tpu_torch.cli._common import open_split
    from leod_tpu_torch.train.trainer import Trainer
    spy = StepSpy(first_step=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with spy:
        cli_train.main(dp_argv(os.path.join(work, "data"),
                               os.path.join(work, "one"), "one", False),
                       frames=frames)
    one = {"cli_s": time.perf_counter() - t0, "steps": spy.steps,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    one_w = {k: spy.first[k] for k in ("w0", "w1", "g1")}
    del spy
    torch.cuda.empty_cache()
    first_one = {}
    for dtype in (torch.bfloat16, torch.float32):
        one_spy = StepSpy(first_step=True)
        trainer = Trainer(dp_bf16_cfg(cfg, os.path.join(work, "one"),
                                      f"one_{dtype}"), dtype=dtype)
        with one_spy:
            trainer.fit(max_steps=1, state=trainer.init_state(GEN4_BATCH),
                        log_every=1,
                        sequences=open_split(cfg.dataset, "train", frames))
        trainer.close()
        first_one[dtype] = one_spy.first
        del trainer, one_spy
        torch.cuda.empty_cache()
    return one, one_w, first_one


def _parity_frames(ranks, one, what):
    """Each labeled frame's preds row of the ranks' sharded eval against
    the one-process eval's, boxes and scores each within SLICE_TOL of
    their largest plain value."""
    if set(ranks) != set(one) or not one:
        fail(f"{what}: the ranks evaluated {len(ranks)} frames, one "
             f"process {len(one)}, not the same ones")
    import torch
    got = torch.stack([ranks[k] for k in one])
    want = torch.stack([one[k] for k in one])
    out = {"frames": len(one)}
    for cols, g, w in (("boxes", got[..., :4], want[..., :4]),
                       ("scores", got[..., 4:], want[..., 4:])):
        err, tol, ok = compare(g, w, SLICE_TOL)
        if not ok:
            fail(f"{what}, {cols}: |ranks - one process| {err} > {tol}")
        out[cols] = [err, tol]
    return out


def drive_dp():
    """Phase 11: RVT-B Gen4 data-parallel. (a) one-rank NCCL training
    against no group; the kernels at a rank's shapes; (b) two gloo ranks
    sharing the card through `cli.train --mesh 2` against one process at
    B 12, and a sharded validation; (c) online SSOD a teacher a rank;
    (d) the stop. Returns its report, its kernels' entries of the JSON
    line ("<name>[Gen4 DP]") and phase 12's references (one process's
    fp32 steps and first steps' head outputs)."""
    import torch
    from leod_tpu_torch.cli._common import load_detector, open_split, ratio_of
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.train.trainer import run_streaming_eval

    from dataclasses import replace
    import numpy as np
    t_phase = time.perf_counter()
    cfg = experiment_preset("gen4", "base")
    L = cfg.dataset.sequence_length
    name = "RVT-B gen4 (experiment_preset('gen4', 'base')), data-parallel"
    if DP_WORLD * DP_LOCAL != cfg.training.batch_size_train:
        fail(f"{DP_WORLD} ranks of {DP_LOCAL} slots are not the preset's "
             f"batch {cfg.training.batch_size_train}")
    report = {"config": name, "card": card(), "ranks": DP_WORLD,
              "global_batch": GEN4_BATCH, "local_batch": DP_LOCAL,
              "window": L}

    # (a) one-rank NCCL
    t0 = time.perf_counter()
    splits = render_gen4(cfg)
    report["nccl"] = phase_dp_nccl(cfg, splits)
    report["nccl"]["seconds"] = time.perf_counter() - t0
    emit({"dp_nccl": report["nccl"]})
    del splits

    # the kernels at a rank's shapes: its teacher's B_local slots, and
    # the NMS at the teacher's B_local x L images
    t0 = time.perf_counter()
    det = Detector(cfg.model, device="cuda", seed=0)
    perturb_layerscale(det, seed=0)
    rows, nms_row = phase_kernels(det, DP_LOCAL, (DP_LOCAL,),
                                  nms_images=DP_LOCAL * L)
    emit({"kernel_phase": {"config": name, **rows, "nms_mask": [nms_row]}})
    for kind, kind_rows in rows.items():
        if not all(r["ok"] for r in kind_rows):
            fail(f"Gen4 B {DP_LOCAL} {kind} disagrees with its plain "
                 f"version: {[(r['shape'], r['max_abs_err'], r['tol']) for r in kind_rows]}")
    if not nms_row["ok"]:
        fail(f"the NMS keep mask at {DP_LOCAL * L} images differs in "
             f"{nms_row['max_abs_err']} boxes")
    report["kernels_s"] = time.perf_counter() - t0
    del det
    torch.cuda.empty_cache()

    # the one-process reference of (b): the same CLI run at B 12
    work = os.path.join(REPO, "runs", "chip_smoke_dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = replace(cfg, dataset=replace(cfg.dataset,
                                       path=os.path.join(work, "data")))
    t0 = time.perf_counter()
    frames = dp_frames(os.path.join(work, "data"), cfg)
    render_s = time.perf_counter() - t0
    one, one_w, first_one = dp_one_process(cfg, work, frames)
    one["render_s"] = render_s
    emit({"dp_one_process": one})

    # (b)-(d) in DP_WORLD rank processes
    t0 = time.perf_counter()
    procs, logs = dp_launch(work)
    ranks = dp_wait(procs, logs, work)
    ranks_s = time.perf_counter() - t0
    tr = [r["train"] for r in ranks]
    for r in tr:
        if r["step"] != DP_STEPS or len(r["steps"]) != DP_STEPS or \
                r["local_slots"] != DP_LOCAL:
            fail(f"a rank took {r['step']} steps over {r['local_slots']} "
                 f"slots")
        if any(r["launches"].values()):
            fail(f"the DP train steps launched the kernels: {r['launches']}")
    for i in range(DP_STEPS):
        if len({r["steps"][i]["checksum"] for r in tr}) != 1 or \
                len({r["steps"][i]["loss"] for r in tr}) != 1:
            fail(f"the ranks' parameters or losses differ after step "
                 f"{i + 1}")
    rel = step_parity([r["steps"] for r in tr], one["steps"],
                      "two ranks' fp32 steps")
    # the weights after step 1: Adam's first update is +-lr wherever
    # |g| >> eps, whatever g's size, so they differ by a sign only where
    # the gradient's sign is a rounding's (|g| <= DP_FLIP_GRAD_MAX), and
    # by less than lr where |g| is near eps
    w1 = torch.load(os.path.join(work, "w1.pt"))
    if sorted(w1) != sorted(one_w["w1"]):
        fail("the ranks' parameters are not one process's")
    max_move = max(float((one_w["w1"][k] - one_w["w0"][k]).abs().max())
                   for k in w1)
    diff = {k: (w1[k] - one_w["w1"][k]).abs() for k in w1}
    g_flip = torch.cat([one_w["g1"][k][diff[k] > max_move].abs()
                        for k in w1])
    g_all = torch.cat([one_w["g1"][k].abs().flatten() for k in w1])
    step1_w = {"differ": sum(int((d > 0).sum()) for d in diff.values()),
               "flipped": int(g_flip.numel()),
               "of": sum(v.numel() for v in w1.values()),
               "max_abs": max(float(d.max()) for d in diff.values()),
               "max_move": max_move,
               # |g| of one process's step 1 where the ranks' update took
               # the other sign, against |g| over all weights
               "flipped_grad_max": float(g_flip.max()) if g_flip.numel()
               else 0.0,
               "grad_abs_median": float(g_all.median()),
               "grad_abs_quantiles": {
                   q: float(torch.quantile(g_all[::16], q))
                   for q in (0.01, 0.03, 0.1)}}
    max_abs = step1_w["max_abs"]
    del diff, g_flip, g_all, w1, one_w
    emit({"dp_fp32_parity": {"step_rel_diff": rel, "step1_weights": step1_w}})
    if max_abs > 2.0 * max_move * (1 + 1e-3) or \
            step1_w["flipped_grad_max"] > DP_FLIP_GRAD_MAX:
        fail(f"the weights after step 1 of two ranks and one process are "
             f"further apart than two first updates, or a first update "
             f"took the other sign where |g| > {DP_FLIP_GRAD_MAX}: {step1_w}")

    # the sharded validation against one process on the same weights
    det = load_detector(cfg.model, torch.bfloat16, "cuda",
                        ckpt=os.path.join(work, "runs", "dp", "ckpt_last.pt"))
    store = {"frames": {}, "batches": []}
    one_metrics = run_streaming_eval(
        det, cfg, "val", device="cuda", on_batch=_eval_hook(store),
        sequences=open_split(cfg.dataset, "val", frames,
                             seq_ratio=ratio_of(cfg.dataset, "val")))
    del det
    rank_frames = {}
    for r in range(DP_WORLD):
        rank_frames.update(torch.load(os.path.join(work, f"eval{r}.pt")))
    eval_parity = _parity_frames(rank_frames, store["frames"],
                                 "the sharded eval")
    m0, m1 = (r["eval"]["metrics"] for r in ranks)
    if m0 != m1:
        fail(f"the ranks' all-gathered metrics differ: {m0} {m1}")
    if any(abs(m0[k] - one_metrics[k]) > EVAL_AP_TOL
           for k in ("AP", "AP_50", "AP_75")):
        fail(f"the sharded eval's metrics {m0} against one process's "
             f"{one_metrics}")
    quiet = [k for r in ranks for k, n in r["eval"]["launches"].items()
             if n == 0]
    if quiet:
        fail(f"a rank's validation launched no {quiet}")

    # (c) online SSOD
    ss = [r["ssod"] for r in ranks]
    for r in ss:
        if r["step"] != DP_SSOD_BURN_IN + DP_SSOD_STEPS or \
                r["teacher_rows"] != DP_LOCAL or \
                r["launches"] != r["launches_implied"] or \
                r["teacher_batches"] < r["step"]:
            fail(f"a rank's online SSOD: {r['step']} steps, teacher rows "
                 f"{r['teacher_rows']}, {r['teacher_batches']} teacher "
                 f"batches, launches {r['launches']} against "
                 f"{r['launches_implied']}")
        if any(r["merged"][:DP_SSOD_BURN_IN]) or \
                not all(r["merged"][DP_SSOD_BURN_IN:r["step"]]):
            fail(f"pseudo boxes merged a step: {r['merged']}")
    if [s["checksum"] for s in ss[0]["steps"]] != \
            [s["checksum"] for s in ss[1]["steps"]] or not all(
                np.isfinite(s["loss"]) for r in ss for s in r["steps"]):
        fail("the SSOD ranks' parameters differ, or a loss is not finite")

    # (d) the stop
    st = [r["stop"] for r in ranks]
    stop_ckpt = os.path.join(work, "runs", "dp_stop", "ckpt_last.pt")
    saved = torch.load(stop_ckpt, map_location="cpu",
                       weights_only=True)["step"] \
        if os.path.exists(stop_ckpt) else None
    if len({s["step"] for s in st}) != 1 or saved != st[0]["step"] or \
            not DP_STOP_AT <= saved < DP_STOP_MAX or \
            any(s["late_sigterm"] for s in st) or \
            st[0]["checksum"] != st[1]["checksum"]:
        fail(f"the stop: ranks at steps {[s['step'] for s in st]}, "
             f"ckpt_last at {saved}")
    # the first bf16 step: its head outputs of the two ranks together
    # lie no further from the fp32 step's than DP_BF16_NOISE times one
    # process's bf16 step does (boxes and scores apart), and each BN
    # running statistic moved as in one process's, within SLICE_TOL
    firsts = [torch.load(os.path.join(work, f"first{r}.pt"))
              for r in range(DP_WORLD)]
    preds = torch.cat([f["preds"] for f in firsts])
    one16, one32 = first_one[torch.bfloat16], first_one[torch.float32]
    if preds.shape != one16["preds"].shape:
        fail(f"the ranks' first bf16 step gave {tuple(preds.shape)} head "
             f"outputs, one process {tuple(one16['preds'].shape)}")
    bf16_parity, ok = {}, True
    for cols, sl in (("boxes", slice(0, 4)), ("scores", slice(4, None))):
        def dist(a, b):
            return float((a[..., sl] - b[..., sl]).abs().max())
        e = {"ranks_fp32": dist(preds, one32["preds"]),
             "one_fp32": dist(one16["preds"], one32["preds"]),
             "ranks_one": dist(preds, one16["preds"]),
             "max_plain": float(one16["preds"][..., sl].abs().max())}
        ok = ok and e["ranks_fp32"] <= DP_BF16_NOISE * e["one_fp32"]
        bf16_parity[cols] = e
    keys = sorted(one16["bn"])
    for r, f in enumerate(firsts):
        if sorted(f["bn"]) != keys:
            fail(f"rank {r}'s BN statistics are not one process's")
        err, tol, bn_ok = compare_all(tuple(f["bn"][k] for k in keys),
                                      tuple(one16["bn"][k] for k in keys),
                                      SLICE_TOL)
        bf16_parity[f"bn_rank{r}"] = [err, tol]
        ok = ok and bn_ok
    emit({"dp_bf16_first_step": bf16_parity})
    if not ok:
        fail(f"the first bf16 step of two ranks against one process at "
             f"B {GEN4_BATCH}: {bf16_parity}")
    # phases 12's and 13's references: one process's fp32 steps, first
    # steps and peak
    refs = {"one_steps": one["steps"], "one_peak_gib": one["peak_gib"],
            "first_one": {k: {"preds": v["preds"]}
                          for k, v in first_one.items()}}
    del firsts, preds, first_one, one16, one32

    report.update({
        "one_process": {k: one[k] for k in ("cli_s", "render_s", "peak_gib")},
        "one_process_step_ms": [s["step_ms"] for s in one["steps"]],
        "fp32_step_rel_diff": rel, "fp32_step1_weights": step1_w,
        "bf16_first_step": bf16_parity, "bn_tensors": len(keys),
        "step_ms_per_rank": [[s["step_ms"] for s in r["steps"]] for r in tr],
        "allreduce_ms_per_rank": [r["allreduce_ms"] for r in tr],
        "peak_gib_per_rank": [r["peak_gib"] for r in tr],
        "losses": [s["loss"] for s in tr[0]["steps"]],
        "val_s_per_rank": [r["eval"]["val_s"] for r in ranks],
        "eval_metrics": m0, "one_process_eval_metrics": one_metrics,
        "eval_parity": eval_parity,
        "eval_nms": [r["eval"]["nms"] for r in ranks],
        "ssod": [{k: r[k] for k in ("fit_s", "teacher_rows", "merged",
                                     "teacher_ms", "teacher_update_ms",
                                     "launches", "nms")}
                 | {"step_ms": [s["step_ms"] for s in r["steps"]],
                    "losses": [s["loss"] for s in r["steps"]]}
                 for r in ss],
        "stop": {"step": st[0]["step"], "ckpt_last_step": saved,
                 "bf16_step_ms_per_rank": [s["step_ms"] for s in st],
                 "bf16_allreduce_ms_per_rank": [s["allreduce_ms"]
                                                for s in st]},
        "rank_start_s": [r["start_s"] for r in ranks],
        "ranks_s": ranks_s})
    shutil.rmtree(work, ignore_errors=True)

    out = kernel_entries(rows, nms_row, "[Gen4 DP]", step_batch=DP_LOCAL)
    for e in out:
        kname = e["name"][:-len("[Gen4 DP]")]
        e["config"] = name
        e["launches_eval"] = sum(r["eval"]["launches"].get(kname, 0)
                                 for r in ranks)
        e["launches_ssod"] = sum(r["launches"].get(kname, 0) for r in ss)
        e["launches"] = e["launches_eval"] + e["launches_ssod"]
    report["phase_s"] = time.perf_counter() - t_phase
    return report, out, refs


# ---------------------------------------------------------------------------
# Space phase (12)
# ---------------------------------------------------------------------------

def collective_stats(kinds) -> dict:
    """{kind: {"calls", "bytes", "ms"}} of the port's "collective.<kind>"
    spans and "collective.<kind>.bytes" counters since the last
    `timing.reset()` (host ms inside the all-reduces, on a card with
    their wait for the queued work)."""
    from leod_tpu_torch import timing
    rec = timing.recorded()
    out = {}
    for k in kinds:
        spans = [s for s in rec["spans"] if s.name == "collective." + k]
        out[k] = {"calls": len(spans),
                  "bytes": rec["counters"].get(f"collective.{k}.bytes", 0),
                  "ms": sum(s.ms for s in spans)}
    return out


def sp_rank(rank: int, port: int, out: str) -> None:
    """One rank of phase 12(b)-(d) (`--sp-rank`): joins the gloo group of
    SP_WORLD ranks on the one card as the space axis of a (1, SP_WORLD)
    mesh, then (b) `cli.train --mesh 1xSP_WORLD` for DP_STEPS fp32 steps
    and the first step of a bf16 fit, (c) one step of every remat
    policy, (d) a streaming eval of (b)'s checkpoint. Writes its report
    to <out>/sp<r>.json, its eval frames to <out>/sp_eval<r>.pt and its
    first bf16 head outputs to <out>/sp_first<r>.pt."""
    from dataclasses import replace
    import numpy as np
    import torch
    from leod_tpu_torch.cli import train as cli_train
    from leod_tpu_torch.cli._common import load_detector, open_split, ratio_of
    from leod_tpu_torch import timing
    from leod_tpu_torch.config import experiment_preset, stem_fold_hw
    from leod_tpu_torch.data.loader import harvest_frames
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.parallel import space
    from leod_tpu_torch.parallel.mesh import make_mesh, shard_states
    from leod_tpu_torch.train.optim import make_optimizer
    from leod_tpu_torch.train.step import (REMAT_POLICIES, TrainState,
                                           make_train_step)
    from leod_tpu_torch.train.trainer import (Trainer, default_frames_per_slot,
                                              run_streaming_eval)

    t0 = time.perf_counter()
    join_ranks(rank, port, SP_WORLD)
    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    root = os.path.join(out, f"data{rank}")
    cfg = experiment_preset("gen4", "base")
    cfg = replace(cfg, dataset=replace(cfg.dataset, path=root))
    dst, mc = cfg.dataset, cfg.model
    frames = dp_frames(root, cfg)
    report = {"rank": rank, "device": torch.cuda.current_device(),
              "start_s": time.perf_counter() - t0}

    def collectives():
        """The block halves by route and the space collectives by kind
        since the last reset."""
        return {"routes": dict(space.COUNTS),
                "collectives": collective_stats(space.KINDS)}

    def reset_counts():
        space.reset_counts()
        timing.reset()

    # the collectives' spans and counters are recorded all through
    timing.begin()

    # (b) training through the CLI, then the first step of a bf16 fit
    save = os.path.join(out, "runs")
    spy = StepSpy()
    _zero(wrappers)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with spy:
        final = cli_train.main(dp_argv(root, save, "sp", False)
                               + ["--mesh", f"1x{SP_WORLD}"], frames=frames)
    report["train"] = {
        "cli_s": time.perf_counter() - t0, "step": final.step,
        "steps": spy.steps, "state_shape": list(final.states[0][0].shape),
        "launches": _count(wrappers),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        **collectives()}
    del spy, final
    torch.cuda.empty_cache()
    mesh = make_mesh(SP_WORLD, space=SP_WORLD)
    trainer = Trainer(dp_bf16_cfg(cfg, save, "sp_bf16"), mesh=mesh)
    spy = StepSpy(first_step=True)
    with spy:
        trainer.fit(max_steps=1, state=trainer.init_state(GEN4_BATCH),
                    log_every=1, sequences=open_split(dst, "train", frames))
    trainer.close()
    torch.save(spy.first["preds"], os.path.join(out, f"sp_first{rank}.pt"))
    report["bf16"] = {"step_ms": spy.steps[0]["step_ms"],
                      "checksum": spy.steps[0]["checksum"]}
    del trainer, spy
    torch.cuda.empty_cache()

    # (c) one bf16 step of every remat policy on the first batch of the
    # train loader, from the same seeded weights, as phase 10(d)
    L, bt = dst.sequence_length, cfg.training.batch_size_train
    m = default_frames_per_slot(L, mc.use_label_every)
    trainer = Trainer(replace(cfg, save_dir=save, exp_name="sp_remat"),
                      mesh=mesh)
    loader, _ = trainer.make_train_loader(0, open_split(dst, "train", frames))
    hb = harvest_frames(next(iter(loader)), m, mc.head.max_gt,
                        mc.backbone.in_res_hw,
                        use_label_every=mc.use_label_every,
                        ignore_label=mc.head.ignore_label,
                        ignore_image=mc.ignore_image, fold_hw=stem_fold_hw(mc))
    trainer.close()
    hb = {k: torch.from_numpy(np.ascontiguousarray(hb[k])).cuda()
          for k in ("ev", "is_first", "frame_t", "frame_mask", "labels")}
    det = Detector(mc, device="cuda", seed=0, trainable=True)
    perturb_layerscale(det, seed=0)
    weights = {k: v.clone() for k, v in det.state_dict().items()}
    keys = ("loss", "grad_norm/backbone", "grad_norm/fpn", "grad_norm/head")
    remat = {}
    for pol in REMAT_POLICIES:
        det.load_state_dict(weights)
        det.zero_grad(set_to_none=True)
        opt, _ = make_optimizer(cfg.training, det.parameters())
        step = make_train_step(det, opt, remat=pol, mesh=mesh)
        state = TrainState(states=shard_states(mesh, det.init_states(bt)),
                           step=0)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, metrics = step(state, hb)
        torch.cuda.synchronize()
        remat[pol] = {"first_step": {k: float(metrics[k]) for k in keys},
                      "step_ms": (time.perf_counter() - t0) * 1e3,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "peak_over_start_gib":
                      (torch.cuda.max_memory_allocated() - base) / 2**30,
                      **collectives()}
        del opt, step, state, metrics
    report["remat"] = remat
    del det, weights, hb
    torch.cuda.empty_cache()

    # (d) a streaming eval of (b)'s checkpoint, sharded in height
    det = load_detector(mc, torch.bfloat16, "cuda",
                        ckpt=os.path.join(save, "sp", "ckpt_last.pt"))
    store = {"frames": {}, "batches": []}
    _zero(wrappers)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run_streaming_eval(
        det, cfg, "val", device="cuda", on_batch=_eval_hook(store),
        sequences=open_split(dst, "val", frames,
                             seq_ratio=ratio_of(dst, "val")), mesh=mesh)
    torch.cuda.synchronize()
    report["eval"] = {
        "val_s": time.perf_counter() - t0, "metrics": metrics,
        "frames": len(store["frames"]), "launches": _count(wrappers),
        "preds_shapes": sorted({tuple(p.shape) for p, _ in store["batches"]}),
        **collectives()}
    report["eval"]["nms"] = _nms_exact(store["batches"], cfg,
                                       f"space rank {rank}'s eval")
    torch.save(store["frames"], os.path.join(out, f"sp_eval{rank}.pt"))
    with open(os.path.join(out, f"sp{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def phase_vis():
    """(e) `leod_tpu_torch.cli.vis` as a user runs it, at RVT-B Gen1 full
    width and depth (bf16, the kernels), `--reverse`, on one rendered val
    sequence of EVAL_REPRS reprs (phase 8's frame store, through
    `main(argv, frames=)`, at the CLI's default thresholds) from a
    checkpoint of the seeded model with LayerScale from seed 0 and its
    obj and class logits set to VIS_LOGIT_MEAN and VIS_LOGIT_STD over
    the first window (the prediction kernels scaled, their biases
    shifted). Fails unless both videos are written with every frame,
    the side-by-side one 2w + PAD wide, and the detections the CLI drew
    (green above `--conf`, red between `--show-conf` and `--conf`) are
    exactly those of the eval step and NMS on the same windows, with
    boxes of both colours in the run and fewer than max_dets a frame;
    reports the launches."""
    import numpy as np
    import torch
    from leod_tpu_torch.cli import vis as cli_vis
    from leod_tpu_torch.cli._common import load_detector, open_split
    from leod_tpu_torch.config import experiment_preset, stem_fold_hw
    from leod_tpu_torch.data.loader import collate, harvest_frames
    from leod_tpu_torch.data.sequence import WindowedSequence
    from leod_tpu_torch.data.synthetic import render_dataset_frames
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.ops.nms import postprocess
    from leod_tpu_torch.train.step import make_eval_step

    t_phase = time.perf_counter()
    wrappers = maxvit_cuda.WRAPPERS + nms_cuda.WRAPPERS
    work = os.path.join(REPO, "runs", "chip_smoke_vis")
    shutil.rmtree(work, ignore_errors=True)
    root, out = os.path.join(work, "data"), os.path.join(work, "out")
    frames = render_dataset_frames(root, 0, 1, 0, seed=0,
                                   num_reprs=EVAL_REPRS,
                                   first_label_repr=EVAL_FIRST_LABEL,
                                   label_every=EVAL_LABEL_EVERY)
    ckpt = os.path.join(work, "ckpt_vis.pt")
    L = experiment_preset("gen1", "base").dataset.sequence_length
    argv = ["--dataset", "gen1", "--size", "base", "--path", root,
            "--split", "val", "--ckpt", ckpt, "--out", out, "--num-seqs", "1",
            "--seq-len", str(L), "--reverse"]
    args = cli_vis.build_parser().parse_args(argv)
    cfg = cli_vis.build_config(args, root)
    mc, conf, show_conf = cfg.model, args.conf, args.show_conf
    pp = mc.postprocess
    seq = open_split(cfg.dataset, "val", frames)[0]
    win = WindowedSequence(seq, L, start_from_zero=True)

    def window(i):
        batch = collate([win[i]])
        hb = harvest_frames(batch, L, mc.head.max_gt, mc.backbone.in_res_hw,
                            fold_hw=stem_fold_hw(mc))
        hb["frame_t"] = np.arange(L, dtype=np.int32)[None]
        hb["frame_mask"] = np.ones((1, L), bool)
        return batch, hb

    det = Detector(mc, device="cuda", seed=0)
    perturb_layerscale(det, seed=0)
    # the prediction convs' outputs with their biases 0 (at the prior's
    # -4.6 a bf16 logit has a step of 0.03, coarser than their spread)
    preds = {n: m for n, m in det.head.named_children()
             if n.startswith(("obj_pred", "cls_pred"))}
    outs = {"obj_pred": [], "cls_pred": []}
    hooks = [m.register_forward_hook(
        lambda mod, args, y, kind=n[:8]: outs[kind].append(y.float().ravel()))
        for n, m in preds.items()]
    with torch.no_grad():
        for m in preds.values():
            m.bias.zero_()
        make_eval_step(det)(det.init_states(1), window(0)[1])
        for h in hooks:
            h.remove()
        for kind, ys in outs.items():
            y = torch.cat(ys)
            if not float(y.std()) > 0:
                fail(f"cli.vis: the {kind} outputs do not spread")
            a = VIS_LOGIT_STD / float(y.std())
            for n, m in preds.items():
                if n.startswith(kind):
                    m.weight.mul_(a)
                    m.bias.fill_(VIS_LOGIT_MEAN - a * float(y.mean()))
    torch.save({"model": det.state_dict()}, ckpt)
    del det, outs
    _zero(wrappers)
    t0 = time.perf_counter()
    written = cli_vis.main(argv, frames=frames)
    torch.cuda.synchronize()
    vis_s = time.perf_counter() - t0
    launches = _count(wrappers)
    normal = os.path.join(out, "seq_000.mp4")
    both = os.path.join(out, "seq_000_both.mp4")
    if sorted(written) != sorted([normal, both]):
        fail(f"cli.vis wrote {sorted(written)}")
    import cv2
    videos = {}
    for path in (normal, both):
        cap = cv2.VideoCapture(path)
        videos[os.path.basename(path)] = v = {
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))}
        cap.release()
        if v["frames"] != EVAL_REPRS or written[path]["frames"] != EVAL_REPRS:
            fail(f"{path}: {v['frames']} frames in the file, "
                 f"{written[path]['frames']} drawn, not {EVAL_REPRS}")
    wn, wb = (videos[os.path.basename(p)]["width"] for p in (normal, both))
    if wb != 2 * wn + cli_vis.PAD:
        fail(f"the side-by-side video is {wb} wide, not 2 x {wn} + "
             f"{cli_vis.PAD}")

    # the eval step and NMS on the same windows, from the same checkpoint
    det = load_detector(mc, torch.bfloat16, "cuda", ckpt=ckpt)
    step = make_eval_step(det)
    states = det.init_states(1)
    want = []
    for i in range(len(win)):
        batch, hb = window(i)
        states, preds = step(states, hb)
        dets, valid = postprocess(preds, num_classes=mc.head.num_classes,
                                  conf_threshold=show_conf,
                                  nms_threshold=pp.nms_threshold,
                                  pre_topk=pp.pre_nms_topk,
                                  max_dets=pp.max_dets)
        dets, valid = dets.float().cpu().numpy(), valid.cpu().numpy()
        want += [dets[t][valid[t]] for t in range(L)
                 if not batch["is_padded"][0, t]]
    seq.close()
    del det, step, states

    got = written[normal]["dets"]
    same = len(got) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(got, want))
    n_strong = sum(int((d[:, 4] * d[:, 5] >= conf).sum()) for d in got)
    n_all = sum(len(d) for d in got)
    most = max(len(d) for d in got)
    if (not same or n_strong == 0 or n_strong == n_all
            or most >= pp.max_dets):
        fail(f"cli.vis drew {n_strong} boxes above {conf} and "
             f"{n_all - n_strong} between {show_conf} and {conf}, at most "
             f"{most} a frame (max_dets {pp.max_dets}), "
             f"{'' if same else 'not '}the eval step's")
    quiet = [k for k, n in launches.items() if n == 0]
    if quiet:
        fail(f"cli.vis launched no {quiet}")
    shutil.rmtree(work, ignore_errors=True)
    return {"config": "RVT-B gen1 (experiment_preset('gen1', 'base')), cli.vis",
            "videos": videos, "boxes_drawn": {"above_conf": n_strong,
                                              "below_conf": n_all - n_strong,
                                              "most_a_frame": most},
            "conf": conf, "show_conf": show_conf, "cli_s": vis_s,
            "launches": launches, "phase_s": time.perf_counter() - t_phase}


def drive_space(refs=None, remat_peaks=None):
    """Phase 12: RVT-B Gen4 height-sharded over SP_WORLD ranks. (a) the
    kernels at a space rank's shapes; (b) `cli.train --mesh 1x2` in fp32
    against one process, and a bf16 first step; (c) every remat policy,
    a rank's peak memory against one process's; (d) a sharded eval
    against one process's; (e) `cli.vis`. `refs` (phase 11's
    `dp_one_process` steps and first steps) and `remat_peaks` (phase
    10(d)'s peak GiB by policy) are computed here where not given (the
    phase run alone). Returns its report, its kernels' entries of the
    JSON line ("<name>[Gen4 SP]") and (e)'s report."""
    from dataclasses import replace
    import numpy as np
    import torch
    from leod_tpu_torch.cli._common import load_detector, open_split, ratio_of
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.models.head import make_anchors
    from leod_tpu_torch.train.trainer import (default_frames_per_slot,
                                              run_streaming_eval)

    t_phase = time.perf_counter()
    cfg = experiment_preset("gen4", "base")
    bb = cfg.model.backbone
    L = cfg.dataset.sequence_length
    m_eval = default_frames_per_slot(L)
    name = ("RVT-B gen4 (experiment_preset('gen4', 'base')), height-sharded "
            f"over {SP_WORLD} ranks")
    report = {"config": name, "card": card(), "mesh": [1, SP_WORLD],
              "batch": GEN4_BATCH, "window": L,
              "note": "the ranks share one card over gloo: times show "
                      "correctness and per-rank memory, not speed across "
                      "cards"}

    # (a) the kernels at a rank's stage shapes (its window layout and
    # the exchanged grid layout, maps of h / SP_WORLD rows), and the NMS
    # at an eval batch's images
    t0 = time.perf_counter()
    det = Detector(cfg.model, device="cuda", seed=0)
    perturb_layerscale(det, seed=0)
    rows, nms_row = phase_kernels(det, GEN4_BATCH, (GEN4_BATCH,),
                                  nms_images=GEN4_BATCH * m_eval,
                                  space=SP_WORLD)
    emit({"kernel_phase": {"config": name, **rows, "nms_mask": [nms_row]}})
    for kind, kind_rows in rows.items():
        if not all(r["ok"] for r in kind_rows):
            fail(f"Gen4 space-rank {kind} disagrees with its plain version: "
                 f"{[(r['shape'], r['max_abs_err'], r['tol']) for r in kind_rows]}")
    if not nms_row["ok"]:
        fail(f"the NMS keep mask at {GEN4_BATCH * m_eval} images differs in "
             f"{nms_row['max_abs_err']} boxes")
    report["kernels_s"] = time.perf_counter() - t0
    del det
    torch.cuda.empty_cache()

    work = os.path.join(REPO, "runs", "chip_smoke_sp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = replace(cfg, dataset=replace(cfg.dataset,
                                       path=os.path.join(work, "data")))
    frames = dp_frames(os.path.join(work, "data"), cfg)
    if refs is None:
        one, _, first_one = dp_one_process(cfg, work, frames)
        refs = {"one_steps": one["steps"],
                "first_one": {k: {"preds": v["preds"]}
                              for k, v in first_one.items()}}
        del one, first_one
    if remat_peaks is None:
        remat_peaks = {k: r["peak_gib"] for k, r in
                       phase_remat(cfg, render_gen4(cfg))["policies"].items()}
    torch.cuda.empty_cache()

    # (b)-(d) in SP_WORLD rank processes
    t0 = time.perf_counter()
    procs, logs = launch_ranks(work, "--sp-rank", "sp", SP_WORLD)
    ranks = wait_ranks(procs, logs, work, "phase 12", "sp", SP_RANK_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0

    # (b) the fp32 steps against one process at B 12, the bf16 first step
    tr = [r["train"] for r in ranks]
    local = [GEN4_BATCH, bb.in_res_hw[0] // 4 // SP_WORLD,
             bb.in_res_hw[1] // 4, bb.stage_dims[0]]
    for r in tr:
        if r["step"] != DP_STEPS or len(r["steps"]) != DP_STEPS or \
                r["state_shape"] != local or any(r["launches"].values()):
            fail(f"a space rank took {r['step']} steps, carried states "
                 f"{r['state_shape']} (not {local}), launched "
                 f"{r['launches']}")
    for i in range(DP_STEPS):
        if len({r["steps"][i]["checksum"] for r in tr}) != 1 or \
                len({r["steps"][i]["loss"] for r in tr}) != 1:
            fail(f"the space ranks' parameters or losses differ after step "
                 f"{i + 1}")
    one_steps = refs["one_steps"]
    rel = step_parity([r["steps"] for r in tr], one_steps,
                      "two space ranks' fp32 steps")
    emit({"sp_fp32_parity": {"step_rel_diff": rel}})
    firsts = [torch.load(os.path.join(work, f"sp_first{r}.pt"))
              for r in range(SP_WORLD)]
    bf16_parity = whole_map_bf16_parity(firsts, refs, "the space ranks")
    emit({"sp_bf16_first_step": bf16_parity})
    del firsts

    # (c) every remat policy's first step against "full"'s, and a rank's
    # peak memory against one process's (phase 10(d))
    keys = ("loss", "grad_norm/backbone", "grad_norm/fpn", "grad_norm/head")
    remat_rel = []
    for r in ranks:
        full = r["remat"]["full"]["first_step"]
        rels = {}
        for pol, v in r["remat"].items():
            rels[pol] = {k: abs(v["first_step"][k] - full[k])
                         / max(abs(full[k]), 1e-30) for k in keys}
            if not all(np.isfinite(x) for x in v["first_step"].values()) or \
                    rels[pol]["loss"] > REMAT_LOSS_RTOL or any(
                        rels[pol][k] > REMAT_NORM_RTOL for k in keys[1:]):
                fail(f"space rank {r['rank']}: remat {pol!r}'s first step "
                     f"{v['first_step']} against \"full\"'s {full}")
        remat_rel.append(rels)
    rank_peaks = [{pol: v["peak_gib"] for pol, v in r["remat"].items()}
                  for r in ranks]
    if not max(p["none"] for p in rank_peaks) < remat_peaks["none"]:
        fail(f"a space rank's \"none\" peak {rank_peaks} is not below one "
             f"process's {remat_peaks['none']} GiB")
    emit({"sp_remat": {"rank_peak_gib": rank_peaks,
                       "one_process_peak_gib": remat_peaks,
                       "rel_diff_to_full": remat_rel}})

    # (d) the sharded eval against one process's on the same checkpoint
    det = load_detector(cfg.model, torch.bfloat16, "cuda",
                        ckpt=os.path.join(work, "runs", "sp", "ckpt_last.pt"))
    store = {"frames": {}, "batches": []}
    one_metrics = run_streaming_eval(
        det, cfg, "val", device="cuda", on_batch=_eval_hook(store),
        sequences=open_split(cfg.dataset, "val", frames,
                             seq_ratio=ratio_of(cfg.dataset, "val")))
    del det
    eval_parity = [_parity_frames(torch.load(os.path.join(work,
                                                          f"sp_eval{r}.pt")),
                                  store["frames"],
                                  f"space rank {r}'s eval")
                   for r in range(SP_WORLD)]
    m0 = ranks[0]["eval"]["metrics"]
    if any(r["eval"]["metrics"] != m0 for r in ranks):
        fail(f"the space ranks' metrics differ: "
             f"{[r['eval']['metrics'] for r in ranks]}")
    if any(abs(m0[k] - one_metrics[k]) > EVAL_AP_TOL
           for k in ("AP", "AP_50", "AP_75")):
        fail(f"the sharded eval's metrics {m0} against one process's "
             f"{one_metrics}")
    anchors = make_anchors(bb.in_res_hw, cfg.model.head.strides)
    whole = [GEN4_BATCH * m_eval, int(anchors.strides.numel()),
             5 + cfg.model.head.num_classes]
    for r in ranks:
        ev = r["eval"]
        if any(list(s) != whole for s in ev["preds_shapes"]):
            fail(f"space rank {r['rank']}'s NMS inputs {ev['preds_shapes']} "
                 f"are not whole ({whole})")
        routes = ev["routes"]
        if routes["window_gather"] or routes["grid_gather"] or \
                not routes["grid_exchange"]:
            fail(f"space rank {r['rank']}'s eval took the block halves' "
                 f"routes {routes}: Gen4 at space {SP_WORLD} aligns every "
                 f"stage")
        quiet = [k for k, n in ev["launches"].items() if n == 0]
        if quiet:
            fail(f"space rank {r['rank']}'s eval launched no {quiet}")

    # (e) the vis CLI
    vis = phase_vis()
    emit({"vis": vis})

    report.update({
        "one_process_step_ms": [s["step_ms"] for s in one_steps],
        "fp32_step_rel_diff": rel, "bf16_first_step": bf16_parity,
        "step_ms_per_rank": [[s["step_ms"] for s in r["steps"]] for r in tr],
        "train_peak_gib_per_rank": [r["peak_gib"] for r in tr],
        "train_collectives_per_rank": [r["collectives"] for r in tr],
        "train_routes": tr[0]["routes"],
        "bf16_step_ms_per_rank": [r["bf16"]["step_ms"] for r in ranks],
        "losses": [s["loss"] for s in tr[0]["steps"]],
        "remat": {"rank_peak_gib": rank_peaks,
                  "one_process_peak_gib": remat_peaks,
                  "rank_step_ms": [{pol: v["step_ms"]
                                    for pol, v in r["remat"].items()}
                                   for r in ranks],
                  "rel_diff_to_full": remat_rel},
        "eval_metrics": m0, "one_process_eval_metrics": one_metrics,
        "eval_parity": eval_parity,
        "eval_nms": [r["eval"]["nms"] for r in ranks],
        "eval_s_per_rank": [r["eval"]["val_s"] for r in ranks],
        "eval_routes": ranks[0]["eval"]["routes"],
        "eval_gather_path_calls": ranks[0]["eval"]["routes"]["window_gather"]
        + ranks[0]["eval"]["routes"]["grid_gather"],
        "eval_collectives_per_rank": [r["eval"]["collectives"]
                                      for r in ranks],
        "rank_start_s": [r["start_s"] for r in ranks], "ranks_s": ranks_s})
    shutil.rmtree(work, ignore_errors=True)

    out = kernel_entries(rows, nms_row, "[Gen4 SP]", step_batch=GEN4_BATCH)
    for e in out:
        kname = e["name"][:-len("[Gen4 SP]")]
        e["config"] = name
        e["launches_eval"] = sum(r["eval"]["launches"].get(kname, 0)
                                 for r in ranks)
        e["launches"] = e["launches_eval"]
    report["phase_s"] = time.perf_counter() - t_phase
    return report, out, vis


def tp_shard(blk, k: int):
    """A copy of block `blk` cut to model rank 0's shard of k
    (`parallel.tensor.shard_params`)."""
    import copy
    from types import SimpleNamespace
    import torch
    from leod_tpu_torch.parallel import tensor
    b = copy.deepcopy(blk)
    tensor.shard_params(torch.nn.ModuleList([b]),
                        SimpleNamespace(model=k, model_index=0))
    if b.attn.model_shards != k:
        fail(f"a block of {blk.dim} channels does not shard {k} ways")
    return b


def phase_tp_kernels(det, batch: int, heads_local=None):
    """The model axis's variants against their plain versions at `det`'s
    stage shapes for `batch` slots: for each stage and each local head
    count of `heads_local` below its heads (default: half of them, model
    degree 2), model rank 0's shard of the stage's first pair through
    `block_attention` (the head-shard kernel; window block with LN1
    skipped and grid block), `block_mlp_tp` (on the map's rows and a
    seeded fp32 sum of the out-projection) and `block_residual` (on the
    plain x1 and partial p)."""
    import torch
    from leod_tpu_torch.models import layers as lay
    from leod_tpu_torch.ops import maxvit_cuda as mc

    bb = det.cfg.backbone
    ps, eps = bb.partition_size, bb.norm_eps
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = {"block_attention": [], "block_mlp_tp": [], "block_residual": []}
    for stage, shape, x, _, _ in stage_inputs(det, seed=1, batch=batch):
        dim = shape[3]
        heads = dim // bb.dim_head
        wb, gb = stage.pairs()[0]
        n_tok = batch * shape[1] * shape[2]
        for hl in heads_local or (heads // 2,):
            if hl >= heads or heads % hl:
                continue
            ws, gs = tp_shard(wb, heads // hl), tp_shard(gb, heads // hl)
            extra = dict(shape=list(shape), batch=batch, heads=hl,
                         degree=heads // hl)
            for blk, grid_kind in ((ws, False), (gs, True)):
                part, rev = ((lay.grid_partition, lay.grid_reverse)
                             if grid_kind
                             else (lay.window_partition, lay.window_reverse))

                def attn_p(blk=blk, part=part, rev=rev):
                    return rev(mc.block_attention_plain(part(x, *ps), blk),
                               *ps, shape[1], shape[2])

                r = kernel_row(lambda blk=blk, grid_kind=grid_kind:
                               mc.block_attention(x, blk, grid_kind, eps),
                               attn_p, *attn_work(blk, n_tok),
                               kind="grid" if grid_kind else "window",
                               **extra)
                r["plan"] = list(mc.block_attention.plan)
                rows["block_attention"].append(r)
            xr = x.reshape(-1, dim)
            a = torch.randn(xr.shape, device="cuda", generator=g)
            r = kernel_row(lambda: mc.block_mlp_tp(xr, a, ws, bb.mlp_act,
                                                   bb.mlp_gated, eps),
                           lambda: mc.block_mlp_tp_plain(xr, a, ws),
                           *mlp_tp_work(ws, n_tok), **extra)
            r["plan"] = mc.block_mlp_tp.plan
            rows["block_mlp_tp"].append(r)
            x1, pp = mc.block_mlp_tp_plain(xr, a, ws)
            rows["block_residual"].append(kernel_row(
                lambda: mc.block_residual(x1, pp, ws),
                lambda: mc.block_residual_plain(x1, pp, ws),
                *residual_work(ws, n_tok), peak=PEAK_FP32, **extra))
    return rows


def _checksum_whole(det) -> str:
    """`_checksum` of the tensors a model rank holds whole (every one but
    the sharded blocks' `_TP_RULES` tensors)."""
    import hashlib
    import torch
    from leod_tpu_torch.parallel import tensor
    shards = tensor.sharded_tensors(det)
    h = hashlib.sha256()
    for k, v in det.state_dict().items():
        if k in shards:
            continue
        h.update(k.encode())
        h.update(v.detach().reshape(-1).cpu().contiguous()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def join_ranks(rank: int, port: int, world: int) -> None:
    """This process as rank `rank` of a gloo group of `world` rank
    processes sharing the card (TF32 off for the fp32 comparisons)."""
    import torch
    from leod_tpu_torch.parallel.distributed import maybe_initialize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    maybe_initialize(backend="gloo", timeout_s=DP_GROUP_TIMEOUT_S)


def tp_rank(rank: int, port: int, out: str) -> None:
    """One rank of phase 13(b)-(c) (`--tp-rank`): joins the gloo group
    of TP_WORLD ranks on the one card as the model axis of a (1, 1,
    TP_WORLD) mesh, then (b) `cli.train --mesh 1x1xTP_WORLD` for DP_STEPS
    fp32 steps and the first step of a bf16 fit, (c) a streaming eval of
    (b)'s checkpoint through the variants. Writes its report to
    <out>/tp<r>.json, its eval frames to <out>/tp_eval<r>.pt and its
    first bf16 head outputs to <out>/tp_first<r>.pt."""
    from dataclasses import replace
    import torch
    from leod_tpu_torch.cli import train as cli_train
    from leod_tpu_torch.cli._common import load_detector, open_split, ratio_of
    from leod_tpu_torch import timing
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.parallel.mesh import make_mesh
    from leod_tpu_torch.train.trainer import Trainer, run_streaming_eval

    t0 = time.perf_counter()
    join_ranks(rank, port, TP_WORLD)
    wrappers = maxvit_cuda.WRAPPERS + maxvit_cuda.TP_WRAPPERS + \
        nms_cuda.WRAPPERS
    root = os.path.join(out, f"data{rank}")
    cfg = experiment_preset("gen4", "base")
    cfg = replace(cfg, dataset=replace(cfg.dataset, path=root))
    dst, mc = cfg.dataset, cfg.model
    frames = dp_frames(root, cfg)
    report = {"rank": rank, "device": torch.cuda.current_device(),
              "start_s": time.perf_counter() - t0}
    # the collectives' spans and counters are recorded all through
    timing.begin()

    # (b) training through the CLI, then the first step of a bf16 fit
    save = os.path.join(out, "runs")
    spy = StepSpy(checksum=_checksum_whole)
    _zero(wrappers)
    timing.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with spy:
        final = cli_train.main(dp_argv(root, save, "tp", False)
                               + ["--mesh", f"1x1x{TP_WORLD}"],
                               frames=frames)
    report["train"] = {
        "cli_s": time.perf_counter() - t0, "step": final.step,
        "steps": spy.steps, "launches": _count(wrappers),
        "allreduce_ms": spy.timings.get("allreduce_ms", []),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "model_collectives": collective_stats(["model"])["model"]}
    del spy, final
    torch.cuda.empty_cache()
    mesh = make_mesh(TP_WORLD, model=TP_WORLD)
    trainer = Trainer(dp_bf16_cfg(cfg, save, "tp_bf16"), mesh=mesh)
    spy = StepSpy(first_step=True, checksum=_checksum_whole)
    with spy:
        trainer.fit(max_steps=1, state=trainer.init_state(GEN4_BATCH),
                    log_every=1, sequences=open_split(dst, "train", frames))
    report["shards"] = trainer.shards
    trainer.close()
    torch.save(spy.first["preds"], os.path.join(out, f"tp_first{rank}.pt"))
    report["bf16"] = {"step_ms": spy.steps[0]["step_ms"],
                      "checksum": spy.steps[0]["checksum"]}
    del trainer, spy
    torch.cuda.empty_cache()

    # (c) a streaming eval of (b)'s checkpoint through the variants
    det = load_detector(mc, torch.bfloat16, "cuda",
                        ckpt=os.path.join(save, "tp", "ckpt_last.pt"))
    store = {"frames": {}, "batches": []}
    _zero(wrappers)
    timing.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run_streaming_eval(
        det, cfg, "val", device="cuda", on_batch=_eval_hook(store),
        sequences=open_split(dst, "val", frames,
                             seq_ratio=ratio_of(dst, "val")), mesh=mesh)
    torch.cuda.synchronize()
    report["eval"] = {
        "val_s": time.perf_counter() - t0, "metrics": metrics,
        "frames": len(store["frames"]), "launches": _count(wrappers),
        "model_collectives": collective_stats(["model"])["model"]}
    report["eval"]["nms"] = _nms_exact(store["batches"], cfg,
                                       f"model rank {rank}'s eval")
    torch.save(store["frames"], os.path.join(out, f"tp_eval{rank}.pt"))
    with open(os.path.join(out, f"tp{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def tp3_rank(rank: int, port: int, out: str) -> None:
    """One rank of phase 13(d) (`--tp3-rank`): TP3D_STEPS fp32 steps of
    `cli.train --mesh 1x2x2` (the space and model axes together) with
    phase 11's flags, in a gloo group of TP3D_WORLD ranks on the one
    card. Writes its report to <out>/tp3<r>.json."""
    from dataclasses import replace
    import torch
    from leod_tpu_torch.cli import train as cli_train
    from leod_tpu_torch import timing
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.parallel import space

    t0 = time.perf_counter()
    join_ranks(rank, port, TP3D_WORLD)
    root = os.path.join(out, f"data{rank}")
    cfg = experiment_preset("gen4", "base")
    cfg = replace(cfg, dataset=replace(cfg.dataset, path=root))
    frames = dp_frames(root, cfg)
    report = {"rank": rank, "start_s": time.perf_counter() - t0}
    argv = dp_argv(root, os.path.join(out, "runs3"), "tp3", False)
    argv[argv.index("--steps") + 1] = str(TP3D_STEPS)
    spy = StepSpy(checksum=_checksum_whole)
    space.reset_counts()
    timing.reset()
    torch.cuda.reset_peak_memory_stats()
    with spy, timing.recording():
        final = cli_train.main(argv + ["--mesh", "1x2x2"], frames=frames)
    report["train"] = {
        "step": final.step, "steps": spy.steps,
        "state_shape": list(final.states[0][0].shape),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "model_collectives": collective_stats(["model"])["model"],
        "space_collectives": collective_stats(space.KINDS)}
    with open(os.path.join(out, f"tp3{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def drive_model(refs=None, one_peak_gib=None):
    """Phase 13: RVT-B Gen4 tensor-parallel. (a) the variants at a model
    rank's shards; (b) `cli.train --mesh 1x1x2` in fp32 against one
    process, and a bf16 first step; (c) a streaming eval of (b)'s
    checkpoint through the variants against one process's; (d) one fp32
    step of `--mesh 1x2x2`. `refs` (phase 11's one-process steps and
    first steps) and `one_peak_gib` (its CLI run's peak) are computed
    here where not given (the phase run alone). Returns its report and
    its kernels' entries of the JSON line ("<name>[Gen4 TP]")."""
    from dataclasses import replace
    import torch
    from leod_tpu_torch.cli._common import load_detector, open_split, ratio_of
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.train.trainer import run_streaming_eval

    t_phase = time.perf_counter()
    cfg = experiment_preset("gen4", "base")
    bb = cfg.model.backbone
    name = ("RVT-B gen4 (experiment_preset('gen4', 'base')), "
            f"tensor-parallel over {TP_WORLD} ranks")
    report = {"config": name, "card": card(), "mesh": [1, 1, TP_WORLD],
              "batch": GEN4_BATCH, "window": cfg.dataset.sequence_length,
              "note": "the ranks share one card over gloo: times show "
                      "correctness and per-rank memory, not speed across "
                      "cards"}

    # (a) the variants at every Gen4 stage's shards, and at the Gen1
    # RVT-B and RVT-S widths at model degree 2
    t0 = time.perf_counter()
    det = Detector(cfg.model, device="cuda", seed=0)
    perturb_layerscale(det, seed=0)
    rows = phase_tp_kernels(det, GEN4_BATCH, TP_HEADS)
    del det
    gen1 = {}
    for tag, size in (("RVT-B", "base"), ("RVT-S", "small")):
        gcfg = experiment_preset("gen1", size)
        det = Detector(gcfg.model, device="cuda", seed=0)
        perturb_layerscale(det, seed=0)
        gen1[tag] = phase_tp_kernels(det, B)
        del det
    emit({"kernel_phase": {"config": name, **rows,
                           "gen1_degree2": gen1}})
    for kind, kind_rows in list(rows.items()) + [
            (f"{t} {k}", v) for t, r in gen1.items() for k, v in r.items()]:
        if not all(r["ok"] for r in kind_rows):
            fail(f"model-axis {kind} disagrees with its plain version: "
                 f"{[(r['shape'], r['heads'], r['max_abs_err'], r['tol']) for r in kind_rows]}")
    report["kernels_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    work = os.path.join(REPO, "runs", "chip_smoke_tp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = replace(cfg, dataset=replace(cfg.dataset,
                                       path=os.path.join(work, "data")))
    frames = dp_frames(os.path.join(work, "data"), cfg)
    if refs is None:
        one, _, first_one = dp_one_process(cfg, work, frames)
        refs = {"one_steps": one["steps"],
                "first_one": {k: {"preds": v["preds"]}
                              for k, v in first_one.items()}}
        one_peak_gib = one["peak_gib"]
        del one, first_one
    torch.cuda.empty_cache()

    # (b)-(c) in TP_WORLD rank processes
    t0 = time.perf_counter()
    procs, logs = launch_ranks(work, "--tp-rank", "tp", TP_WORLD)
    ranks = wait_ranks(procs, logs, work, "phase 13", "tp",
                       TP_RANK_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0

    # (b) the fp32 steps against one process at B 12, the bf16 first step
    tr = [r["train"] for r in ranks]
    for r in ranks:
        if r["shards"]["replicated"] or len(r["shards"]["sharded"]) != \
                2 * sum(bb.num_blocks):
            fail(f"model rank {r['rank']} sharded {r['shards']}: every "
                 f"Gen4 stage's heads divide by {TP_WORLD}")
    for r in tr:
        if r["step"] != DP_STEPS or len(r["steps"]) != DP_STEPS or \
                any(r["launches"].values()):
            fail(f"a model rank took {r['step']} steps, launched "
                 f"{r['launches']}")
    for i in range(DP_STEPS):
        if len({r["steps"][i]["checksum"] for r in tr}) != 1 or \
                len({r["steps"][i]["loss"] for r in tr}) != 1:
            fail(f"the model ranks' whole tensors or losses differ after "
                 f"step {i + 1}")
    if len({r["bf16"]["checksum"] for r in ranks}) != 1:
        fail("the model ranks' whole tensors differ after the bf16 step")
    one_steps = refs["one_steps"]
    if len(one_steps) != DP_STEPS:
        fail(f"one process took {len(one_steps)} steps")
    rel = step_parity([r["steps"] for r in tr], one_steps,
                      "two model ranks' fp32 steps")
    emit({"tp_fp32_parity": {"step_rel_diff": rel}})
    firsts = [torch.load(os.path.join(work, f"tp_first{r}.pt"))
              for r in range(TP_WORLD)]
    bf16_parity = whole_map_bf16_parity(firsts, refs, "the model ranks")
    emit({"tp_bf16_first_step": bf16_parity})
    del firsts

    # (b) the checkpoint the ranks wrote holds whole tensors: it loads
    # into one process; (c) the eval against one process's on it
    ckpt = os.path.join(work, "runs", "tp", "ckpt_last.pt")
    det = load_detector(cfg.model, torch.bfloat16, "cuda", ckpt=ckpt)
    store = {"frames": {}, "batches": []}
    one_metrics = run_streaming_eval(
        det, cfg, "val", device="cuda", on_batch=_eval_hook(store),
        sequences=open_split(cfg.dataset, "val", frames,
                             seq_ratio=ratio_of(cfg.dataset, "val")))
    del det
    eval_parity = [_parity_frames(torch.load(os.path.join(work,
                                                          f"tp_eval{r}.pt")),
                                  store["frames"],
                                  f"model rank {r}'s eval")
                   for r in range(TP_WORLD)]
    m0 = ranks[0]["eval"]["metrics"]
    if any(r["eval"]["metrics"] != m0 for r in ranks):
        fail(f"the model ranks' metrics differ: "
             f"{[r['eval']['metrics'] for r in ranks]}")
    if any(abs(m0[k] - one_metrics[k]) > EVAL_AP_TOL
           for k in ("AP", "AP_50", "AP_75")):
        fail(f"the tensor-parallel eval's metrics {m0} against one "
             f"process's {one_metrics}")
    for r in ranks:
        quiet = [k for k, n in r["eval"]["launches"].items()
                 if n == 0 and k != "block_mlp"]
        if quiet or r["eval"]["launches"]["block_mlp"]:
            fail(f"model rank {r['rank']}'s eval launched "
                 f"{r['eval']['launches']}: every Gen4 block is sharded, "
                 f"so each variant and no whole block_mlp")
    emit({"tp_eval": {"parity": eval_parity, "metrics": m0,
                      "one_process_metrics": one_metrics}})

    # (d) the space and model axes together: one fp32 step on 1x2x2
    t0 = time.perf_counter()
    procs, logs = launch_ranks(work, "--tp3-rank", "tp3", TP3D_WORLD)
    ranks3 = wait_ranks(procs, logs, work, "phase 13(d)", "tp3",
                        TP_RANK_TIMEOUT_S)
    ranks3_s = time.perf_counter() - t0
    local = [GEN4_BATCH, bb.in_res_hw[0] // 4 // 2, bb.in_res_hw[1] // 4,
             bb.stage_dims[0]]
    t3 = [r["train"] for r in ranks3]
    for r in t3:
        if r["step"] != TP3D_STEPS or r["state_shape"] != local:
            fail(f"a (1, 2, 2) rank took {r['step']} steps with states "
                 f"{r['state_shape']} (not {local})")
    for i in range(TP3D_STEPS):
        if len({r["steps"][i]["loss"] for r in t3}) != 1 or \
                len({r["steps"][i]["checksum"] for r in t3}) != 1:
            fail(f"the (1, 2, 2) ranks' losses or whole tensors differ "
                 f"after step {i + 1}")
    rel3 = step_parity([r["steps"] for r in t3], one_steps,
                       "the (1, 2, 2) ranks' fp32 step")
    emit({"tp3_fp32_parity": {"step_rel_diff": rel3}})

    report.update({
        "one_process_step_ms": [s["step_ms"] for s in one_steps],
        "one_process_peak_gib": one_peak_gib,
        "fp32_step_rel_diff": rel, "bf16_first_step": bf16_parity,
        "step_ms_per_rank": [[s["step_ms"] for s in r["steps"]] for r in tr],
        "allreduce_ms_per_rank": [r["allreduce_ms"] for r in tr],
        "train_peak_gib_per_rank": [r["peak_gib"] for r in tr],
        "train_model_collectives_per_rank": [r["model_collectives"]
                                             for r in tr],
        "bf16_step_ms_per_rank": [r["bf16"]["step_ms"] for r in ranks],
        "losses": [s["loss"] for s in tr[0]["steps"]],
        "eval_metrics": m0, "one_process_eval_metrics": one_metrics,
        "eval_parity": eval_parity,
        "eval_nms": [r["eval"]["nms"] for r in ranks],
        "eval_s_per_rank": [r["eval"]["val_s"] for r in ranks],
        "eval_model_collectives_per_rank": [r["eval"]["model_collectives"]
                                            for r in ranks],
        "mesh_1x2x2": {
            "step_rel_diff": rel3,
            "step_ms_per_rank": [[s["step_ms"] for s in r["steps"]]
                                 for r in t3],
            "peak_gib_per_rank": [r["peak_gib"] for r in t3],
            "model_collectives_per_rank": [r["model_collectives"]
                                           for r in t3],
            "space_collectives_per_rank": [r["space_collectives"]
                                           for r in t3],
            "ranks_s": ranks3_s},
        "rank_start_s": [r["start_s"] for r in ranks], "ranks_s": ranks_s})
    shutil.rmtree(work, ignore_errors=True)

    src, pallas = ("leod_tpu_torch/csrc/maxvit.cu",
                   "leod_tpu/ops/maxvit_pallas.py")
    out = []
    for kname, replaces, peak in (
            ("block_attention", f"{pallas}:62", PEAK_BF16),
            ("block_mlp_tp", f"{pallas}:92", PEAK_BF16),
            ("block_residual", f"{pallas}:115", PEAK_FP32)):
        e = _summary(kname + "[Gen4 TP]", replaces, source=src,
                     shape_rows=rows[kname], launches=0, peak_ops=peak,
                     step_batch=GEN4_BATCH)
        # a step of model degree 2 (each stage's heads halved) is the
        # entry's time and bound; the rows of the other degrees stay in
        # per_shape
        deg2 = [r for r in rows[kname] if r["degree"] == 2]
        tot = {k: sum(r[k] for r in deg2)
               for k in ("ms", "plain_ms", "flops", "bytes")}
        bms, by = bound(tot["flops"], tot["bytes"], peak)
        e.update(ms=tot["ms"], kernel_ms=tot["ms"], plain_ms=tot["plain_ms"],
                 flops=tot["flops"], bytes=tot["bytes"], bound_ms=bms,
                 bound_by=by, config=name,
                 gen1_degree2={t: [{k: r[k] for k in ("shape", "heads", "ms",
                                                      "plain_ms", "bound_ms",
                                                      "max_abs_err", "tol")}
                                   for r in g[kname]]
                               for t, g in gen1.items()})
        e["launches_eval"] = sum(r["eval"]["launches"].get(kname, 0)
                                 for r in ranks)
        e["launches"] = e["launches_eval"]
        if not all(r["ok"] for g in gen1.values() for r in g[kname]):
            e["ok"] = False
        out.append(e)
    report["phase_s"] = time.perf_counter() - t_phase
    return report, out


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
        rows_dev = mlp_device_rows(det, MLP_GEN1_BATCHES)
        emit({"block_mlp_device": {"config": name, "rows": rows_dev}})
        checked["block_mlp_device"] = rows_dev
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
    out = kernel_entries(rows, nms_row, suffix)
    for e in out:
        kname = e["name"][:len(e["name"]) - len(suffix)]
        e["config"] = name
        e["launches_serve"] = launches[kname]
        e["launches_eval"] = ev["launches"].get(kname, 0)
        e["launches"] = e["launches_serve"] + e["launches_eval"]
        if kname == "nms_mask" and "nms_b48" in ev:
            e["eval_b48"] = ev["nms_b48"]
    del det
    return out


def kernel_entries(rows, nms_row, suffix: str, step_batch: int = B):
    """Each kernel wrapper's entry of the JSON line from the kernel
    phase's rows (its launches filled in by the caller), named
    `<name><suffix>`; times and work summed over the rows at
    `step_batch`."""
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
    return [_summary(kname + suffix, replaces, source, shape_rows, 0, peak,
                     step_batch)
            for kname, replaces, source, shape_rows, peak in entries]


def op_call_timing(det, mc, nc) -> dict:
    """Each op's host time a call, at RVT-B's stage-4 shapes at B = 8
    (the NMS at K = 1000 an image): "op_call_us" through
    `torch.ops.leod_tpu_torch.<op>`, and "direct_us" for the CUDA
    implementation it reaches, called past the op: the Python launch
    function where the package defines the op in Python (`_<op>_cuda`),
    else the op's CUDA kernel by a redispatch to the CUDA key. The two
    "direct" times measure different layers (the Python one, the
    dispatcher): only "op_call_us" compares two trees."""
    import torch
    blk = det.backbone.stage4.block0_grid
    gates = det.backbone.stage4.lstm.gates
    g = torch.Generator(device="cuda").manual_seed(0)
    x, o, h = (torch.randn(B, 8, 10, 512, device="cuda",
                           generator=g).bfloat16() for _ in range(3))
    a, c = (torch.randn(B, 8, 10, 512, device="cuda", generator=g)
            for _ in range(2))
    xy = torch.rand(B, 1000, 2, device="cuda", generator=g) * 300
    boxes = torch.cat([xy, xy + 40], -1)
    valid = torch.ones(B, 1000, dtype=torch.bool, device="cuda")
    ids = torch.zeros(B, 1000, device="cuda")
    args = {
        "block_attention": (x, *mc._norm1(blk), blk.attn.qkv.weight,
                            blk.attn.qkv.bias, 32, 8, 10, True, 1e-5, 0),
        "block_mlp": (x, o, *mc._mlp_weights(blk), "gelu", False, 1e-5, 0),
        "block_mlp_tp": (x, a, *mc._mlp_tp_weights(blk), "gelu", False,
                         1e-5, 0),
        "block_residual": (x, a, blk.mlp.proj_out.bias, blk.ls2),
        "lstm_update": (x, h, c, gates.weight, gates.bias, 0),
        "nms_mask": (boxes, 0.45, valid, ids)}
    python_impl = {"block_attention": "_attention_cuda",
                   "block_mlp": "_mlp_cuda", "block_mlp_tp": "_mlp_tp_cuda",
                   "block_residual": "_residual_cuda",
                   "lstm_update": "_lstm_cuda", "nms_mask": "_nms_cuda"}
    cuda_key = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    out = {"op_call_us": {}, "direct_us": {}}
    for name, op_args in args.items():
        op = getattr(torch.ops.leod_tpu_torch, name, None)
        if op is None:
            continue
        op = op.default
        impl = getattr(nc if name == "nms_mask" else mc, python_impl[name],
                       None)
        direct = ((lambda impl=impl, op_args=op_args: impl(*op_args))
                  if impl is not None else
                  (lambda op=op, op_args=op_args: op.redispatch(cuda_key,
                                                                *op_args)))
        out["op_call_us"][name] = enqueue_us(
            lambda op=op, op_args=op_args: op(*op_args), reps=200)
        out["direct_us"][name] = enqueue_us(direct, reps=200)
        out["direct_is_python"] = impl is not None
    torch.cuda.synchronize()
    out["card"] = card()
    return out


def timing_detector(root: str, data: str, size: str = "base"):
    """(preset, detector) of `data` at `size` (seed 0, LayerScale from
    seed 0) from the package under ROOT, its op library built and TF32
    off: the model of the timing modes, which compare two trees in one
    call."""
    root = os.path.abspath(root)
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch
    import leod_tpu_torch
    if not os.path.abspath(leod_tpu_torch.__file__).startswith(root):
        fail(f"imported {leod_tpu_torch.__file__}, not the package under "
             f"{root}")
    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    cfg = experiment_preset(data, size)
    det = Detector(cfg.model, device="cuda", seed=0)
    perturb_layerscale(det, seed=0)
    return cfg, det


def serve_timing(root: str) -> None:
    """`--serve-timing ROOT`: the live serve step of RVT-B Gen1 (seed 0,
    LayerScale from seed 0, conf 0) of the package under ROOT, by host
    clock at B = 1 and B = 8 (median of SERVE_TIMING_REPS, each ending in
    a synchronize) and its enqueue time (the host's share alone); where
    the package has the custom ops, each op call's host time against the
    launch it wraps, called directly (`op_call_timing`). One JSON line;
    compare two trees in one call, in the order A, B, B, A."""
    import numpy as np
    import torch
    cfg, det = timing_detector(root, "gen1")
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    from leod_tpu_torch.serve import make_serve_step, serve_input_shape

    step = make_serve_step(det, conf_threshold=0.0)
    rng = np.random.default_rng(0)
    out = {"root": os.path.relpath(root, REPO)}
    for bsz in (1, B):
        st = det.init_states(bsz)
        ev = torch.from_numpy(np.stack(frames(
            rng, bsz, serve_input_shape(cfg, bsz)[1:]))).cuda()
        on = torch.ones(bsz, dtype=torch.bool, device="cuda")
        out[f"step_ms_b{bsz}"] = host_ms(lambda: step(st, ev, on, on),
                                         reps=SERVE_TIMING_REPS)
        out[f"enqueue_ms_b{bsz}"] = enqueue_us(
            lambda: step(st, ev, on, on), reps=SERVE_TIMING_REPS) / 1e3
    # the steps registered the ops of a package that has them
    out["ops"] = hasattr(torch.ops.leod_tpu_torch, "block_attention")
    if out["ops"]:
        out.update(op_call_timing(det, maxvit_cuda, nms_cuda))
    emit({"serve_timing": out})


def mlp_device_rows(det, batches, calls: int = MLP_PROFILE_CALLS):
    """`block_mlp` at the model's stage rows for each of `batches` slots,
    on seeded x and o, by its own plan: the profiled device us a launch
    of `block_mlp_kernel<C>` (the mean of `calls` launches in one
    window), its bound (`mlp_work`, as `portbench/work.py` counts it, at
    the bf16 tensor-core rate or the card's bytes, the larger) and its
    share of that roofline, the launch's plan, the error against the
    plain version (KERNEL_TOL) and whether a second launch gave the same
    bits."""
    import torch
    from leod_tpu_torch.ops import maxvit_cuda as mc

    bb = det.cfg.backbone
    h_in, w_in = bb.in_res_hw
    g = torch.Generator(device="cuda").manual_seed(4)
    out = []
    for k, (dim, stride) in enumerate(zip(bb.stage_dims, bb.stage_strides)):
        wb = getattr(det.backbone, f"stage{k + 1}").pairs()[0][0]
        for bsz in batches:
            n_tok = bsz * (h_in // stride) * (w_in // stride)
            x, o = (torch.randn((n_tok, dim), device="cuda", generator=g
                                ).to(torch.bfloat16) for _ in range(2))

            def call(x=x, o=o):
                return mc.block_mlp(x, o, wb, bb.mlp_act, bb.mlp_gated,
                                    bb.norm_eps)

            first = call()
            err, tol, ok = compare_all(first, mc.block_mlp_plain(x, o, wb),
                                       KERNEL_TOL)
            same = bool(torch.equal(first, call()))
            dev_events, tries = profile_calls(
                call, calls, f"block_mlp at C = {dim}, B = {bsz}")
            us = [e.time_range.elapsed_us() for e in dev_events
                  if re.search(r"\bblock_mlp_kernel\b", e.name)]
            bms, by = bound(*mlp_work(wb, n_tok), PEAK_BF16)
            dev_us = sum(us) / len(us)
            plan = mc.block_mlp.plan
            out.append({"dim": dim, "batch": bsz, "shape": [n_tok, dim],
                        "device_us": dev_us, "bound_us": bms * 1e3,
                        "bound_by": by, "roofline": bms * 1e3 / dev_us,
                        "launches": len(us), "profile_tries": tries,
                        "plan": list(plan) if isinstance(plan, (list, tuple))
                        else plan,
                        "max_abs_err": err, "tol": tol, "ok": ok and same,
                        "rerun_equal": same})
    return out


def mlp_timing(root: str) -> None:
    """`--mlp-timing ROOT`: `mlp_device_rows` of the package under ROOT,
    RVT-B Gen1 (seed 0, LayerScale from seed 0) at B = 16, 8 and 1,
    RVT-B Gen4 at B = 12 and RVT-S Gen1 at B = 8 and 1. One JSON line;
    compare two trees in one call, in the order A, B, B, A."""
    out = {"root": os.path.relpath(root, REPO)}
    for key, data, size, batches in (
            ("gen1", "gen1", "base", MLP_GEN1_BATCHES + (1,)),
            ("gen4", "gen4", "base", (GEN4_BATCH,)),
            ("gen1_small", "gen1", "small", (B, 1))):
        _, det = timing_detector(root, data, size)
        out[key] = mlp_device_rows(det, batches)
        del det
    emit({"mlp_timing": out})
    if not all(r["ok"] for key, rows in out.items() if key != "root"
               for r in rows):
        fail("block_mlp disagrees with its plain version or with itself")


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
    if sys.argv[1:2] == ["--serve-timing"] and len(sys.argv) == 3:
        serve_timing(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--mlp-timing"] and len(sys.argv) == 3:
        mlp_timing(sys.argv[2])
        return 0
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--dp-rank"] and len(sys.argv) == 5:
        dp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--sp-rank"] and len(sys.argv) == 5:
        sp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--tp-rank"] and len(sys.argv) == 5:
        tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--tp3-rank"] and len(sys.argv) == 5:
        tp3_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
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
    deploy = phase_deploy(selftrain["tta_evaluate_ms"])
    emit({"deploy": deploy})
    torch.cuda.empty_cache()
    gen4, gen4_kernels = drive_gen4()
    emit({"gen4": gen4})
    torch.cuda.empty_cache()
    dp, dp_kernels, dp_refs = drive_dp()
    emit({"dp": dp})
    torch.cuda.empty_cache()
    sp, sp_kernels, vis = drive_space(dp_refs, gen4["remat_peak_gib"])
    emit({"space": sp})
    torch.cuda.empty_cache()
    tp, tp_kernels = drive_model(dp_refs, dp_refs["one_peak_gib"])
    emit({"model": tp})
    # the first path's kernels also ran in the train phase's validation,
    # in the self-training phase, in the CLI phase, in the deploy phase
    # (the artifact's and the server's steps) and in phase 12's cli.vis
    for e in kernels:
        if e["config"].startswith("RVT-B"):
            e["launches_train"] = train["launches"][e["name"]]
            e["launches_selftrain"] = selftrain["launches"][e["name"]]
            e["launches_cli"] = cli["launches"][e["name"]]
            e["launches_deploy"] = deploy["launches"][e["name"]]
            e["launches_vis"] = vis["launches"][e["name"]]
            e["launches"] += (e["launches_train"] + e["launches_selftrain"]
                              + e["launches_cli"] + e["launches_deploy"]
                              + e["launches_vis"])
    kernels += gen4_kernels + dp_kernels + sp_kernels + tp_kernels
    emit({"kernels": kernels})
    bad = [k["name"] for k in kernels if not k["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "leod_tpu"
              or m.startswith("leod_tpu.")]
    if leaked:
        fail(f"imported JAX or the JAX package: {leaked[:5]}")

    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
