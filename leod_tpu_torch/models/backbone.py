"""RVT recurrent MaxViT backbone (port of `leod_tpu/models/backbone.py`).

4 stages; each = strided-conv downsample -> N x (window-attn ->
grid-attn) -> ConvLSTM. The (h, c) state per stage is passed in and
returned explicitly, one row per stream.

Two routes through a stage: `forward` goes through the kernel wrappers
(`ops/maxvit_cuda.py`: on a CUDA tensor the hand-written kernels, which
define no backward; on the CPU their plain versions), and
`forward_modules` through the module forwards under autograd, the
port's counterpart of the flax/XLA path that `leod_tpu` trains through.
A stage's module route is `cell(pre_modules(x))`: the non-recurrent
downsample and block pairs, then the ConvLSTM. Stage 1's `pre_modules`
carries no state, so a train step may checkpoint it alone or run it over
every frame of a window at once (`RVTBackbone.stage1_pre`,
`from_stage1`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import BackboneConfig
from ..ops import maxvit_cuda
from .layers import (ConvDownsample, ConvLSTMCell, PartitionAttention,
                     block_pair_tokens)

StageState = Tuple[torch.Tensor, torch.Tensor]
BackboneStates = Tuple[StageState, ...]
BackboneFeatures = Dict[int, torch.Tensor]   # 1-indexed stage -> [B, h, w, C]


class RVTStage(nn.Module):
    """One backbone stage. Blocks are named block{i}_window and
    block{i}_grid, as the flax modules."""

    def __init__(self, cfg: BackboneConfig, in_channels: int, stage_dim: int,
                 downsample_factor: int, num_blocks: int,
                 enable_token_masking: bool = False):
        super().__init__()
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.down = ConvDownsample(in_channels, stage_dim, downsample_factor,
                                   overlap=cfg.overlap_downsample,
                                   norm_affine=cfg.norm_affine,
                                   norm_eps=cfg.norm_eps)
        for i in range(num_blocks):
            for kind, skip in (("window", i == 0), ("grid", False)):
                setattr(self, f"block{i}_{kind}", PartitionAttention(
                    stage_dim, cfg.partition_size, kind,
                    # the downsample output is already LayerNormed
                    skip_first_norm=skip, dim_head=cfg.dim_head,
                    attention_bias=cfg.attention_bias,
                    mlp_ratio=cfg.mlp_ratio, mlp_act=cfg.mlp_act,
                    mlp_gated=cfg.mlp_gated, mlp_bias=cfg.mlp_bias,
                    ls_init_value=cfg.ls_init_value, norm_eps=cfg.norm_eps))
        self.lstm = ConvLSTMCell(stage_dim, cfg.lstm_dws_conv,
                                 cfg.lstm_dws_conv_only_hidden,
                                 cfg.lstm_dws_conv_kernel_size)
        if enable_token_masking:
            self.mask_token = nn.Parameter(torch.zeros(1, 1, 1, stage_dim))
        else:
            self.mask_token = None

    def pairs(self):
        return [(getattr(self, f"block{i}_window"),
                 getattr(self, f"block{i}_grid"))
                for i in range(self.num_blocks)]

    def forward(self, x: torch.Tensor, state: StageState,
                token_mask: Optional[torch.Tensor] = None,
                plain: bool = False) -> Tuple[torch.Tensor, StageState]:
        """Downsample, mask token, then the whole stage through
        `fused_stage` (backbone.py:123-139), or, with the depthwise-conv
        LSTM, `fused_block_pair` per pair and the plain ConvLSTM.
        plain=True runs the kernels' plain versions even on CUDA."""
        c = self.cfg
        x = self.down(x)
        if self.mask_token is not None and token_mask is not None:
            x = torch.where(token_mask[..., None],
                            self.mask_token.to(x.dtype), x)
        kw = dict(dim_head=c.dim_head, act=c.mlp_act, gated=c.mlp_gated,
                  eps=c.norm_eps)
        if not c.lstm_dws_conv:
            h0, c0 = state[0].to(x.dtype), state[1].to(x.dtype)
            if plain:
                h, cc = maxvit_cuda.fused_stage_plain(
                    x, h0, c0, self.pairs(), self.lstm.gates,
                    c.partition_size)
            else:
                h, cc = maxvit_cuda.fused_stage(
                    x, h0, c0, self.pairs(), self.lstm.gates,
                    c.partition_size, skip_first_norm=True, **kw)
            return h, (h, cc)
        for i, (wb, gb) in enumerate(self.pairs()):
            if plain:
                x = maxvit_cuda.fused_block_pair_plain(x, wb, gb,
                                                       c.partition_size)
            else:
                x = maxvit_cuda.fused_block_pair(
                    x, wb, gb, c.partition_size, skip_first_norm=(i == 0),
                    **kw)
        h, cc = self.lstm(x, state)
        return h, (h, cc)

    def pre_modules(self, x: torch.Tensor,
                    token_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """The stage's non-recurrent part through its module forwards,
        differentiable: the downsample, the mask token, each block pair
        in token layout (`layers.block_pair_tokens`), as the flax stage's
        `pre` computes it (`leod_tpu/models/backbone.py:69-111`). It
        carries no state, so stage 1's can run over every timestep of a
        window at once."""
        x = self.down(x)
        if self.mask_token is not None and token_mask is not None:
            x = torch.where(token_mask[..., None],
                            self.mask_token.to(x.dtype), x)
        for wb, gb in self.pairs():
            x = block_pair_tokens(x, wb, gb, self.cfg.partition_size)
        return x

    def cell(self, y: torch.Tensor, state: StageState
             ) -> Tuple[torch.Tensor, StageState]:
        """The ConvLSTM on the output of `pre_modules`
        (`leod_tpu/models/backbone.py:112-115`). (h, c) come back in the
        dtypes of the state that went in (the compute dtype, as JAX
        carries them)."""
        h, cc = self.lstm(y, state)
        h, cc = h.to(state[0].dtype), cc.to(state[1].dtype)
        return h, (h, cc)

    def forward_modules(self, x: torch.Tensor, state: StageState,
                        token_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, StageState]:
        """The stage through its module forwards, differentiable:
        `cell(pre_modules(x))`, as the flax stage computes it
        (`leod_tpu/models/backbone.py:136-139`)."""
        return self.cell(self.pre_modules(x, token_mask), state)


class RVTBackbone(nn.Module):
    """Full recurrent backbone; one timestep per call."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        self.cfg = cfg
        in_ch = cfg.input_channels
        self.num_stages = len(cfg.num_blocks)
        for k, (dim, nblk) in enumerate(zip(cfg.stage_dims, cfg.num_blocks)):
            setattr(self, f"stage{k + 1}", RVTStage(
                cfg, in_ch, dim, cfg.patch_size if k == 0 else 2, nblk,
                enable_token_masking=cfg.enable_masking and k == 0))
            in_ch = dim

    def forward(self, x: torch.Tensor, states: BackboneStates,
                token_mask: Optional[torch.Tensor] = None,
                plain: bool = False
                ) -> Tuple[BackboneFeatures, BackboneStates]:
        features: BackboneFeatures = {}
        new_states: List[StageState] = []
        for k in range(self.num_stages):
            x, st = getattr(self, f"stage{k + 1}")(
                x, states[k], token_mask if k == 0 else None, plain)
            features[k + 1] = x
            new_states.append(st)
        return features, tuple(new_states)

    def forward_modules(self, x: torch.Tensor, states: BackboneStates,
                        token_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[BackboneFeatures, BackboneStates]:
        """One timestep through every stage's module forwards,
        differentiable: `from_stage1(stage1_pre(x))`."""
        return self.from_stage1(self.stage1_pre(x, token_mask), states)

    def stage1_pre(self, x: torch.Tensor,
                   token_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """Stage 1's non-recurrent part (`RVTStage.pre_modules`): it
        carries no state, so it takes any number of frames at once
        (`leod_tpu/models/backbone.py:177-180`)."""
        return self.stage1.pre_modules(x, token_mask)

    def from_stage1(self, y1: torch.Tensor, states: BackboneStates
                    ) -> Tuple[BackboneFeatures, BackboneStates]:
        """One timestep from stage 1's `stage1_pre` output: stage 1's
        ConvLSTM, then stages 2-4 through their module forwards
        (`leod_tpu/models/backbone.py:182-197`)."""
        x, st = self.stage1.cell(y1, states[0])
        features: BackboneFeatures = {1: x}
        new_states: List[StageState] = [st]
        for k in range(1, self.num_stages):
            x, st = getattr(self, f"stage{k + 1}").forward_modules(
                x, states[k])
            features[k + 1] = x
            new_states.append(st)
        return features, tuple(new_states)


def init_states(cfg: BackboneConfig, batch_size: int,
                dtype=torch.float32, device="cpu",
                space: int = 1) -> BackboneStates:
    """Zero LSTM states for `batch_size` streams; with `space` > 1, a
    space rank's height slice of them (h / stride / space rows)."""
    h, w = cfg.in_res_hw
    states = []
    for dim, stride in zip(cfg.stage_dims, cfg.stage_strides):
        if (h // stride) % space:
            raise ValueError(f"a state map of {h // stride} rows does not "
                             f"split over {space} space ranks")
        shape = (batch_size, h // stride // space, w // stride, dim)
        states.append((torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device)))
    return tuple(states)


def reset_states(states: BackboneStates,
                 reset: torch.Tensor) -> BackboneStates:
    """Zero the states of batch rows where `reset` is True. By SELECTION,
    not multiplication: 0 * NaN is NaN, so a poisoned slot would survive
    a multiplicative reset; torch.where clears it. Differentiable: the
    gradient reaches the rows kept, and none the rows reset."""
    def apply(s):
        r = reset.reshape((-1,) + (1,) * (s.dim() - 1))
        return torch.where(r, torch.zeros((), dtype=s.dtype,
                                          device=s.device), s)

    return tuple((apply(h), apply(c)) for h, c in states)
