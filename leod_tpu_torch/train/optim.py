"""Optimizer and LR schedule (port of `leod_tpu/train/optim.py:1-43`).

Reference: AdamW + linear OneCycle with warmup pct 0.005, div_factor 25,
final_lr = max_lr / final_div_factor (NOT torch's init_lr / final_div:
the reference redefines it, modules/detection.py:485-518 and
config/general.yaml), gradient clip 1.0 BY VALUE (train.py:236).

`ClipAdamW` is `optax.chain(optax.clip(v), optax.adamw(schedule,
weight_decay=wd))` over a module's parameters: every gradient clipped
to [-v, v], then `torch.optim.AdamW` (b1 0.9, b2 0.999, eps 1e-8, the
weight decay passed explicitly: torch's default is 0.01, the config's
0.0), with the learning rate of update n (from 0) set to `schedule(n)`,
as optax's schedule reads its count before incrementing it. A parameter
the loss did not reach gets a zero gradient, as `jax.grad` gives it, so
that the weight decay still moves it. All of it on the fp32 parameters.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple, Union

import numpy as np
import torch

from ..config import TrainingConfig

Schedule = Union[float, Callable[[int], float]]


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule(init, end, steps)(count), in float32 as
    optax evaluates it."""
    f32 = np.float32
    c = min(max(count, 0), steps)
    frac = f32(1.0) - f32(c) / f32(steps)
    return float(f32(init - end) * frac + f32(end))


def onecycle_linear(max_lr: float, total_steps: int, pct_start: float,
                    div_factor: float, final_div_factor: float
                    ) -> Callable[[int], float]:
    """Pointwise torch OneCycleLR(anneal='linear') with the reference's
    final_div reinterpretation (detection.py:499-501): peak at step
    pct_start*total - 1, min max_lr/final_div at the LAST step. The
    JAX package's optax schedule (join of two linear schedules at the
    warmup boundary), as a plain function of the step."""
    warmup = max(round(total_steps * pct_start) - 1, 1)
    decay = max(total_steps - 1 - warmup, 1)

    def schedule(step: int) -> float:
        step = int(step)
        if step < warmup:
            return _linear(max_lr / div_factor, max_lr, warmup, step)
        return _linear(max_lr, max_lr / final_div_factor, decay,
                       step - warmup)

    return schedule


class ClipAdamW:
    """Clip by value, then AdamW at `schedule(count)` (module docstring).
    `count` is the number of updates taken."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: TrainingConfig, schedule: Schedule):
        self.params = [p for p in params if p.requires_grad]
        self.clip = cfg.gradient_clip_val
        self.schedule = schedule
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.lr(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)

    def lr(self, count: int) -> float:
        return (self.schedule(count) if callable(self.schedule)
                else float(self.schedule))

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def grads(self):
        """The parameters' gradients, zeros where the loss did not reach
        a parameter."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        self.grads()
        if self.clip:
            torch.nn.utils.clip_grad_value_(self.params, self.clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr(self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


def make_optimizer(cfg: TrainingConfig, params: Iterable[torch.nn.Parameter]
                   ) -> Tuple[ClipAdamW, Schedule]:
    """(optimizer over `params`, schedule), as the JAX package's
    `make_optimizer` gives (tx, schedule)."""
    if cfg.lr_scheduler.use:
        schedule = onecycle_linear(cfg.learning_rate, cfg.max_steps,
                                   cfg.lr_scheduler.pct_start,
                                   cfg.lr_scheduler.div_factor,
                                   cfg.lr_scheduler.final_div_factor)
    else:
        schedule = cfg.learning_rate
    return ClipAdamW(params, cfg, schedule), schedule
