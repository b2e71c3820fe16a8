"""Detector: recurrent backbone + PAFPN + YOLOX head (port of
`leod_tpu/models/detector.py:25-133`).

An inference detector holds its weights as modules in the compute
dtype: bf16 on the card, as `Detector(dtype=jnp.bfloat16)` computes (the
kernels accumulate in fp32). A trainable one (`trainable=True`) keeps
fp32 master parameters and BN statistics, as flax does, and computes in
`dtype` by `torch.autocast`, entered once per region it runs (a
backbone timestep, the FPN and head): each region casts a parameter to
bf16 at its use, so the gradients of a timestep's casts reach the fp32
parameter one by one and are summed there in fp32, as `jax.grad`
sums the cotangents of flax's per-use casts. Weights are made from a
seed with an explicit `torch.Generator` in flax's initializers'
distributions, or loaded from the JAX package's variables with
`convert.load_jax_variables`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from .. import resolve_device
from ..config import ModelConfig
from ..parallel.space import gather_height
from .backbone import BackboneStates, RVTBackbone, init_states
from .fpn import PAFPN
from .head import (PRIOR_BIAS, Anchors, YOLOXHead, decode_outputs,
                   make_anchors, yolox_loss)
from .layers import _S2DStemConv, _SplitGateConv, lecun_normal_


class Detector(nn.Module):
    """The detector on one device (`cuda` unless the caller asks for
    `cpu`; without a card, `cuda` raises).

    trainable=False: inference only, weights in `dtype`, no gradients;
    `forward_backbone` and `forward_detect` run through the kernels.
    trainable=True: fp32 parameters that take gradients, computing in
    `dtype` (`compute`); the train route is `forward_stage1_pre` then
    `forward_from_stage1` (`forward_backbone_modules` split at stage 1's
    ConvLSTM) and `forward_detect(train=True)`.

    Inside a space shard (`parallel/space.py`) every map is a rank's
    rows; `forward_detect` gathers the head's outputs whole before the
    decode, so anchors, SimOTA and the loss see the whole image."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16,
                 device="cuda", seed: int = 0, trainable: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.trainable = trainable
        self.backbone = RVTBackbone(cfg.backbone)
        self.fpn = PAFPN(cfg.fpn, cfg.fpn_in_channels)
        self.head = YOLOXHead(cfg.head, cfg.fpn_in_channels)
        self.init_weights(torch.Generator().manual_seed(seed))
        if trainable:
            self.to(device=dev)
        else:
            self.to(device=dev, dtype=dtype)
            self.eval()
            self.requires_grad_(False)
        self.anchors: Anchors = make_anchors(cfg.backbone.in_res_hw,
                                             cfg.head.strides, device=dev)

    @property
    def device(self) -> torch.device:
        return self.anchors.strides.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax defaults: lecun-normal kernels, zero biases, unit norms,
        LayerScale at ls_init_value, mask token N(0, 0.02), and the YOLOX
        prior-probability bias on the cls/obj predictions."""
        for name, m in self.named_modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, _S2DStemConv):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, _SplitGateConv):
                lecun_normal_(m.weight, m.weight.shape[1], generator)
            else:
                continue
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith(("cls_pred", "obj_pred")):
                m.bias.fill_(PRIOR_BIAS)
        for m in self.backbone.modules():
            if getattr(m, "mask_token", None) is not None:
                m.mask_token.copy_(torch.randn(m.mask_token.shape,
                                               generator=generator) * 0.02)

    def init_states(self, batch_size: int, dtype=None,
                    space: int = 1) -> BackboneStates:
        """Zero states for `batch_size` slots (a space rank's height slice
        of them with `space` > 1)."""
        return init_states(self.cfg.backbone, batch_size,
                           dtype or self.dtype, self.device, space)

    @torch.no_grad()
    def forward_backbone(self, x: torch.Tensor, states: BackboneStates,
                         token_mask: Optional[torch.Tensor] = None,
                         plain: bool = False):
        """One timestep: x [B, H, W, C] (or a stem fold of it) ->
        ({stage: feature}, new_states)."""
        return self.backbone(x.to(self.dtype), states, token_mask, plain)

    def compute(self):
        """The region a trainable detector computes in: `torch.autocast`
        to `dtype` where that is not fp32, else nothing."""
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)

    def forward_backbone_modules(self, x: torch.Tensor,
                                 states: BackboneStates,
                                 token_mask: Optional[torch.Tensor] = None):
        """One timestep through the module forwards, differentiable
        (`RVTBackbone.forward_modules`), in `compute()`:
        x [B, H, W, C] (or the stem's fold of it) -> ({stage: feature},
        new_states)."""
        with self.compute():
            return self.backbone.forward_modules(x, states, token_mask)

    def forward_stage1_pre(self, x: torch.Tensor,
                           token_mask: Optional[torch.Tensor] = None):
        """Stage 1's downsample and block pairs through the module
        forwards, in `compute()`, over any number of frames
        (`RVTBackbone.stage1_pre`; `leod_tpu/models/detector.py:94-98`)."""
        with self.compute():
            return self.backbone.stage1_pre(x, token_mask)

    def forward_from_stage1(self, y1: torch.Tensor, states: BackboneStates):
        """The rest of one timestep from `forward_stage1_pre`'s output,
        in `compute()` (`RVTBackbone.from_stage1`;
        `leod_tpu/models/detector.py:100-105`)."""
        with self.compute():
            return self.backbone.from_stage1(y1, states)

    def forward_detect(self, feats, train: bool = False):
        """FPN + head + decode over harvested frames.

        train=False: ([B, A, 5+C] with sigmoided obj/cls, None), no
        gradients, through the kernels' inference modules.
        train=True: ([B, A, 5+C] decoded boxes with obj/cls logits, the
        updated BN statistics `batch_stats()`), differentiable, every BN
        on batch statistics (`layers.batch_norm_train`), in
        `compute()`."""
        if not train:
            with torch.no_grad():
                raw = self.head(self.fpn(feats))
                return decode_outputs([gather_height(r) for r in raw],
                                      self.anchors, apply_sigmoid=True), None
        if not self.trainable:
            raise ValueError("forward_detect(train=True) needs a detector "
                             "built with trainable=True")
        with self.compute():
            raw = self.head(self.fpn(feats, train=True), train=True)
            out = decode_outputs([gather_height(r) for r in raw],
                                 self.anchors, apply_sigmoid=False)
        return out, self.batch_stats()

    def batch_stats(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The BN running statistics, {"fpn": {...}, "head": {...}} by
        buffer name (the JAX tree's `batch_stats`)."""
        return {part: {n: b for n, b in getattr(self, part).named_buffers()
                       if n.endswith(("running_mean", "running_var"))}
                for part in ("fpn", "head")}

    def loss(self, train_out: torch.Tensor, labels: torch.Tensor,
             frame_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`head.yolox_loss` with this model's anchors and head config."""
        return yolox_loss(train_out, labels, frame_mask, self.anchors,
                          self.cfg.head)
