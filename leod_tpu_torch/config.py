"""Typed configuration system (the PyTorch port's own copy).

A verbatim copy of `leod_tpu/config.py`: the port imports nothing of
the JAX package, so it carries the same dataclasses, `derive()` and
presets. Keep the two files in step.

Replaces the reference's Hydra YAML tree + programmatic modifier
(reference: config/*.yaml, config/modifier.py:10-131) with plain frozen
dataclasses and a `derive()` step that computes padded input resolution,
attention partition sizes and class counts.

Presets mirror the reference experiment matrix:
  datasets : gen1 (240x304, 2 classes), gen4 (1Mpx 720x1280 /2, 3 classes)
  sizes    : tiny (embed 32), small (48), base (64)
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


def _ceil_to(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BackboneConfig:
    """RVT recurrent MaxViT backbone (reference: models/detection/recurrent_backbone/maxvit_rnn.py)."""
    input_channels: int = 20            # 2 polarities x 10 temporal bins
    embed_dim: int = 64                 # 32/48/64 = tiny/small/base
    dim_multiplier: Tuple[int, ...] = (1, 2, 4, 8)
    num_blocks: Tuple[int, ...] = (1, 1, 1, 1)
    patch_size: int = 4                 # stem stride; later stages stride 2
    enable_masking: bool = False        # learnable [MASK] token in stage 1
    # attention
    dim_head: int = 32
    attention_bias: bool = True
    mlp_ratio: int = 4
    mlp_gated: bool = False
    mlp_act: str = "gelu"
    mlp_bias: bool = True
    ls_init_value: float = 1e-5
    norm_eps: float = 1e-5
    # downsample layer
    overlap_downsample: bool = True
    norm_affine: bool = True
    # lstm
    lstm_dws_conv: bool = False
    lstm_dws_conv_only_hidden: bool = True
    lstm_dws_conv_kernel_size: int = 3
    # derived by `derive()`
    partition_split_32: int = 1
    partition_size: Tuple[int, int] = (8, 10)
    in_res_hw: Tuple[int, int] = (256, 320)

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * m for m in self.dim_multiplier)

    @property
    def stage_strides(self) -> Tuple[int, ...]:
        strides, s = [], 1
        for i in range(len(self.num_blocks)):
            s *= self.patch_size if i == 0 else 2
            strides.append(s)
        return tuple(strides)


@dataclass(frozen=True)
class FPNConfig:
    """YOLO PAFPN (reference: models/detection/yolox_extension/models/yolo_pafpn.py)."""
    depth: float = 0.67                 # round(3*depth) bottlenecks per CSP layer
    in_stages: Tuple[int, ...] = (2, 3, 4)
    depthwise: bool = False
    act: str = "silu"


@dataclass(frozen=True)
class HeadConfig:
    """YOLOX decoupled head + SimOTA (reference: models/detection/yolox/models/yolo_head.py)."""
    num_classes: int = 2
    strides: Tuple[int, ...] = (8, 16, 32)
    act: str = "silu"
    depthwise: bool = False
    obj_focal_loss: bool = False
    # extra L1 loss on raw reg outputs (classic YOLOX enables it for the
    # final no-augmentation epochs; off in every reference config —
    # reference: yolo_head.py:147,560-580)
    use_l1: bool = False
    reg_weight: float = 5.0
    obj_weight: float = 1.0
    cls_weight: float = 1.0
    # self-training extras (LEOD-specific)
    ignore_bbox_thresh: Optional[Tuple[float, ...]] = None  # per-class obj/cls conf
    ignore_label: int = 1024
    ignore_bg_k: float = 0.0
    bbox_loss_weighting: str = ""       # '', 'obj', 'cls', 'objxcls'
    # static-shape budgets (TPU): max GT boxes per frame in SimOTA
    max_gt: int = 64


@dataclass(frozen=True)
class PostprocessConfig:
    confidence_threshold: float = 0.1   # 0.001 at final eval (BASELINE.md)
    nms_threshold: float = 0.45
    max_dets: int = 300                 # fixed-shape NMS output budget
    pre_nms_topk: int = 1000            # score top-k before NMS


@dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    postprocess: PostprocessConfig = field(default_factory=PostprocessConfig)
    use_label_every: int = 1            # subsample dense pseudo labels in train
    ignore_image: bool = False          # drop frames whose boxes are all ignore

    @property
    def fpn_in_channels(self) -> Tuple[int, ...]:
        dims = self.backbone.stage_dims
        return tuple(dims[s - 1] for s in self.fpn.in_stages)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ZoomConfig:
    prob: float = 0.8
    zoom_in_weight: float = 8.0
    zoom_in_min: float = 1.0
    zoom_in_max: float = 1.5
    zoom_out_weight: float = 2.0
    zoom_out_min: float = 1.0
    zoom_out_max: float = 1.2


@dataclass(frozen=True)
class AugmentConfig:
    prob_hflip: float = 0.5
    prob_tflip: float = 0.0
    rotate_prob: float = 0.0
    rotate_min_deg: float = 2.0
    rotate_max_deg: float = 6.0
    zoom: ZoomConfig = field(default_factory=ZoomConfig)


@dataclass(frozen=True)
class DatasetConfig:
    name: str = "gen1"                  # 'gen1' | 'gen4'
    path: str = "./datasets/gen1"
    ev_repr_name: str = "stacked_histogram_dt=50_nbins=10"
    sequence_length: int = 21           # TBPTT window L (gen1=21, gen4=5)
    resolution_hw: Tuple[int, int] = (240, 304)
    downsample_by_factor_2: bool = False
    tflip_offset: int = -1              # label lag vs events (gen1=-1, gen4=-2)
    ratio: float = -1.0                 # WSOD frame-label subsample
    train_ratio: float = -1.0           # SSOD sequence subsample
    # every-k sequence subsampling of the eval splits, to speed up
    # val/test passes (reference: dataset_streaming.py:81-83)
    val_ratio: float = -1.0
    test_ratio: float = -1.0
    # evaluate time-reversed sequences (reference: modules/data/genx.py:148)
    reverse_event_order: bool = False
    train_sampling: str = "mixed"       # 'random' | 'stream' | 'mixed'
    # class-frequency weighted random-access sampling (reference:
    # dataset_rnd.py:228-264; disabled in every reference config)
    weighted_sampling: bool = False
    # eval sampling is always streaming (the reference asserts the same,
    # modules/data/genx.py:96); the reference's `only_load_labels` fast
    # path is unnecessary here: label-only passes (selftrain/verify.py)
    # never touch event data because h5 reads are lazy per range
    augment_random: AugmentConfig = field(default_factory=AugmentConfig)
    augment_stream: AugmentConfig = field(default_factory=lambda: AugmentConfig(
        zoom=ZoomConfig(prob=0.5, zoom_in_weight=0.0, zoom_in_min=1.0,
                        zoom_in_max=1.0, zoom_out_weight=1.0, zoom_out_max=1.2)))

    @property
    def num_classes(self) -> int:
        return 2 if self.name == "gen1" else 3

    @property
    def classes(self) -> Tuple[str, ...]:
        # labelmaps (reference: utils/evaluation/prophesee/evaluator.py:8-11)
        if self.name == "gen1":
            return ("car", "pedestrian")
        return ("pedestrian", "two-wheeler", "car")

    @property
    def loading_hw(self) -> Tuple[int, int]:
        h, w = self.resolution_hw
        if self.downsample_by_factor_2:
            return (h // 2, w // 2)
        return (h, w)


# ---------------------------------------------------------------------------
# Training / experiment
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LRSchedulerConfig:
    use: bool = True
    pct_start: float = 0.005
    div_factor: float = 25.0
    final_div_factor: float = 10000.0   # final_lr = max_lr / this (reference semantics)


@dataclass(frozen=True)
class SSODOnlineConfig:
    """Online SSOD: EMA teacher on weak views supervising the student on
    strong views (selftrain/online.py; the reference ships the
    components but never wires them — ssod_augmentor.py,
    modules/utils/ssod.py:353-460)."""
    enabled: bool = False
    alpha: float = 0.999                # EMA decay (true-average warm-up)
    update_method: str = "ema"          # 'ema' | 'every-N'
    burn_in_steps: int = 0              # GT-only steps before pseudo merge
    obj_thresh: float = 0.7             # teacher objectness threshold
    cls_thresh: float = 0.7             # teacher class-conf threshold
    skip_first_t: int = 2               # no pseudo labels right after reset
    use_gt: bool = True                 # GT frames keep GT, not pseudo


@dataclass(frozen=True)
class TrainingConfig:
    precision: str = "bf16"             # compute dtype ('bf16' | 'fp32')
    max_steps: int = 400_000
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    gradient_clip_val: float = 1.0      # clip by value, as the reference
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    batch_size_train: int = 8
    batch_size_eval: int = 8
    val_check_interval: int = 20_000
    ckpt_every_min: float = 18.0
    # every N steps render one train batch's pred-vs-GT boxes into
    # <run_dir>/viz/ (reference logs panels every 5k steps,
    # callbacks/detection.py:20-107); 0 disables
    viz_every_steps: int = 5000
    # per-PARAMETER mean |grad| in the step metrics (hundreds of scalars;
    # reference gradflow bar charts, callbacks/gradflow.py:10-27)
    gradflow: bool = False
    num_workers_train: int = 4
    num_workers_eval: int = 4
    seed: int = 0
    # static budget: max labeled frames per train step handed to the head.
    # <=0 means derive from batch size / sequence length.
    max_det_frames: int = 0
    # TBPTT remat policy for the backbone scan body: "full" recomputes
    # everything in the backward pass (lowest memory; measured fastest
    # on v5e — docs/benchmarks.md), "dots" saves matmul/conv outputs,
    # "stage1" recomputes only stage-1 attention (falls back to "full"
    # when backbone.enable_masking), "none" stores all residuals
    remat: str = "full"
    # multi-host: step cadence for the rank-consistent checkpoint-timer
    # and preemption-stop agreement (one tiny all-gather per check).
    # Size it so cadence x step time stays well inside the preemption
    # grace period; single-process runs react every step regardless.
    multihost_sync_every: int = 25
    ssod_online: SSODOnlineConfig = field(default_factory=SSODOnlineConfig)


def stem_width_fold(model: "ModelConfig") -> int:
    """Host-side width-fold factor for the event tensor: the stride-4
    S2D stem (layers._S2DStemConv) accepts [B, H, W/4, 4*C] input, which
    makes the fold a free host reshape instead of a per-step device
    layout copy. 1 when the model's stem can't consume folded input."""
    bb = model.backbone
    ok = (bb.overlap_downsample and bb.patch_size == 4
          and bb.in_res_hw[1] % 4 == 0)
    return 4 if ok else 1


def stem_fold_hw(model: "ModelConfig") -> Tuple[int, int]:
    """(fold_h, fold_w) for the host-side space-to-depth prefold. The
    stem also accepts the BOTH-axis fold [B, H/4, W/4, 16*C] (a 2x2
    stride-1 conv with all 128 lanes busy); the H fold is a transpose,
    which host loaders fold into the copy they already materialize
    (harvest_frames). Masking does not constrain the fold: the mask
    token applies to stage-1 FEATURES after the stem (backbone.py
    RVTStage.pre), whose shape is layout-independent."""
    w = stem_width_fold(model)
    h = 4 if (w == 4 and model.backbone.in_res_hw[0] % 4 == 0) else 1
    return h, w


@dataclass(frozen=True)
class ExperimentConfig:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    save_dir: str = "./runs"
    exp_name: str = "leod_tpu"


# ---------------------------------------------------------------------------
# Derivation (the reference's `dynamically_modify_train_config`)
# ---------------------------------------------------------------------------

def broadcast_gen4_thresholds(thresh, dataset_name: str):
    """gen1 2-tuple ('car', 'ped') -> gen4 3-tuple ('ped', 'cyc', 'car'):
    cyclist copies pedestrian (reference: config/modifier.py:82-98).
    The ONE owner of the class-order broadcast rule — derive() and the
    predict/val_dst CLIs all route through here."""
    if thresh is not None and dataset_name == "gen4" and len(thresh) == 2:
        return (thresh[1], thresh[1], thresh[0])
    return thresh


def derive(cfg: ExperimentConfig) -> ExperimentConfig:
    """Fill in derived fields (reference: config/modifier.py:10-108).

    - pad input H,W up to a multiple of 32*partition_split_32
    - partition_size = padded_hw / (32*split)  (window==grid size)
    - num_classes from the dataset
    - broadcast 2-class ignore thresholds to 3-class gen4
    """
    dst = cfg.dataset
    split = 1 if dst.name == "gen1" else 2
    hw = dst.loading_hw
    mult = 32 * split
    in_res = (_ceil_to(hw[0], mult), _ceil_to(hw[1], mult))
    part = (in_res[0] // mult, in_res[1] // mult)
    backbone = replace(cfg.model.backbone,
                       partition_split_32=split,
                       in_res_hw=in_res,
                       partition_size=part)
    head = replace(cfg.model.head, num_classes=dst.num_classes)
    thresh = broadcast_gen4_thresholds(head.ignore_bbox_thresh, dst.name)
    if thresh is not head.ignore_bbox_thresh:
        head = replace(head, ignore_bbox_thresh=thresh)
    model = replace(cfg.model, backbone=backbone, head=head)
    return replace(cfg, model=model)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

_EMBED_BY_SIZE = {"tiny": 32, "small": 48, "base": 64}


def dataset_preset(name: str) -> DatasetConfig:
    if name == "gen1":
        return DatasetConfig()
    if name == "gen4":
        return DatasetConfig(
            name="gen4", path="./datasets/gen4", sequence_length=5,
            resolution_hw=(720, 1280), downsample_by_factor_2=True,
            tflip_offset=-2)
    raise ValueError(f"unknown dataset {name!r}")


def model_preset(size: str = "base", **head_kwargs) -> ModelConfig:
    """Size presets mirror the reference experiment matrix exactly
    (config/experiment/gen1/{tiny,small,base}.yaml, identical for gen4):
    tiny = embed 32 + FPN depth 0.33; small = embed 48 + dim_head 24
    (48 is not divisible by the default 32) + FPN depth 0.33;
    base = embed 64 + FPN depth 0.67."""
    embed = _EMBED_BY_SIZE[size]
    dim_head = 24 if size == "small" else 32
    fpn_depth = 0.67 if size == "base" else 0.33
    return ModelConfig(backbone=BackboneConfig(embed_dim=embed,
                                               dim_head=dim_head),
                       fpn=FPNConfig(depth=fpn_depth),
                       head=HeadConfig(**head_kwargs))


def experiment_preset(dataset: str = "gen1", size: str = "base",
                      soft: bool = False) -> ExperimentConfig:
    """soft=True mirrors `rnndet-soft` (self-training student with
    ignore_bbox_thresh, reference: config/model/rnndet-soft.yaml)."""
    head_kwargs = {}
    if soft:
        head_kwargs["ignore_bbox_thresh"] = (0.7, 0.35)
    cfg = ExperimentConfig(dataset=dataset_preset(dataset),
                           model=model_preset(size, **head_kwargs))
    # experiment defaults (config/experiment/{gen1,gen4}/default.yaml):
    # both override general.yaml's OneCycle div_factor 25 -> 20; gen4
    # trains/evals at batch 12 (BASELINE.md: bs 12 x 2 GPU)
    lr = 2e-4 if dataset == "gen1" else 3.46e-4
    tr = replace(cfg.training, learning_rate=lr,
                 lr_scheduler=replace(cfg.training.lr_scheduler,
                                      div_factor=20.0))
    if dataset == "gen4":
        tr = replace(tr, batch_size_train=12, batch_size_eval=12)
    cfg = replace(cfg, training=tr)
    return derive(cfg)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
