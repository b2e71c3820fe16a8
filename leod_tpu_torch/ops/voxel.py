"""Event voxelization on the device: the stacked-histogram and
mixed-density representations (port of `leod_tpu/ops/voxel.py:20-110`).

The reference voxelizes offline with torch scatter-add
(reference: data/utils/representations.py:38-123, StackedHistogram):
2 polarities x `bins` temporal bins, uint8 counts clipped at 255,
dt=50ms windows, nbins=10 => 20 channels. Here, as in the JAX package's
XLA scatter, it is one `index_add_` into int32 counts over a batch of
windows on the tensors' device (the card, or the CPU), with a fixed
event buffer and a validity mask. The temporal bin is computed in
float32 exactly as JAX computes it, so an event on a bin edge lands in
the same bin on either device and in either package.
"""
from __future__ import annotations

from typing import Optional

import torch

_BIG = torch.iinfo(torch.int32).max


def _norm_time(time: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(t - t0) / max(t1 - t0, 1) in float32 over each window's valid
    events ([..., N]); a window with no valid event has t0 = t1 = 0."""
    t = time.to(torch.int32)
    any_valid = valid.any(-1, keepdim=True)
    t0 = torch.where(valid, t, _BIG).amin(-1, keepdim=True)
    t1 = torch.where(valid, t, -_BIG).amax(-1, keepdim=True)
    t0 = torch.where(any_valid, t0, 0)
    t1 = torch.where(any_valid, t1, 0)
    return (t - t0).float() / torch.clamp((t1 - t0).float(), min=1.0)


def _in_canvas(x, y, valid, height: int, width: int) -> torch.Tensor:
    # out-of-canvas coordinates must DROP, not alias: x >= width would
    # wrap into row y+1 and y >= height into the next temporal-bin block
    return valid & (x >= 0) & (x < width) & (y >= 0) & (y < height)


def _scatter(flat: torch.Tensor, valid: torch.Tensor, size: int,
             values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add `values` (1 where None) at each window's `flat` [B, N] into
    int32 counts [B, size]; invalid events go to a spare slot per window
    that is cut off."""
    b = flat.shape[0]
    flat = torch.where(valid, flat, size).to(torch.int64)
    flat = flat + (size + 1) * torch.arange(b, device=flat.device)[:, None]
    if values is None:
        values = torch.ones_like(flat, dtype=torch.int32)
    hist = torch.zeros(b * (size + 1), dtype=torch.int32, device=flat.device)
    hist.index_add_(0, flat.reshape(-1), values.reshape(-1))
    return hist.reshape(b, size + 1)[:, :size]


def stacked_histogram_batch(x: torch.Tensor, y: torch.Tensor,
                            pol: torch.Tensor, time: torch.Tensor,
                            valid: torch.Tensor, bins: int, height: int,
                            width: int, count_cutoff: int = 255
                            ) -> torch.Tensor:
    """Windows of events [B, N] -> [B, 2*bins, H, W] uint8 stacked
    histograms on the inputs' device.

    Temporal binning matches the reference: t normalized by the first and
    last VALID event time, scaled to `bins`, floored, clamped to bins-1
    (representations.py:104-111). Channel layout: pol*bins + bin."""
    t_norm = _norm_time(time, valid)
    t_idx = torch.clamp(torch.floor(t_norm * bins).to(torch.int32), 0,
                        bins - 1)
    x, y, pol = (a.to(torch.int32) for a in (x, y, pol))
    valid = _in_canvas(x, y, valid, height, width)
    flat = (x + width * y + height * width * t_idx
            + bins * height * width * pol)
    hist = _scatter(flat, valid, 2 * bins * height * width)
    hist = torch.clamp(hist, max=count_cutoff).to(torch.uint8)
    return hist.reshape(-1, 2 * bins, height, width)


def stacked_histogram(x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor,
                      time: torch.Tensor, valid: torch.Tensor, bins: int,
                      height: int, width: int,
                      count_cutoff: int = 255) -> torch.Tensor:
    """One window's events [N] -> [2*bins, H, W] uint8
    (`stacked_histogram_batch` of one)."""
    return stacked_histogram_batch(
        x[None], y[None], pol[None], time[None], valid[None], bins, height,
        width, count_cutoff)[0]


def mixed_density_stack(x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor,
                        time: torch.Tensor, valid: torch.Tensor,
                        bins: int, height: int, width: int,
                        count_cutoff: Optional[int] = None) -> torch.Tensor:
    """MixedDensityEventStack (reference: representations.py:167-221) of
    one window [N] -> [bins, H, W] int32.

    Log-spaced temporal bins anchored at the window START: an event at
    normalized time t lands in raw bin floor(bins + log2(t)) (clamped),
    log2 taken as log(t) / log(2) in float32, as `jnp.log2` does; the
    cumulative sum makes channel i hold ALL events up to its
    exponential time cutoff 2^(i-bins). Values are signed polarity
    (+1/-1), optionally clipped."""
    valid = valid[None]
    t_norm = torch.clamp(_norm_time(time[None], valid), 1e-6, 1.0 - 1e-6)
    log2 = torch.log(t_norm) / torch.tensor(2.0).log().to(t_norm.device)
    bin_idx = torch.clamp(torch.floor(bins + log2).to(torch.int32), 0,
                          bins - 1)
    val = torch.where(pol[None] > 0, 1, -1).to(torch.int32)
    x, y = x[None].to(torch.int32), y[None].to(torch.int32)
    valid = _in_canvas(x, y, valid, height, width)
    flat = x + width * y + height * width * bin_idx
    hist = _scatter(flat, valid, bins * height * width, val)
    hist = hist.reshape(bins, height, width)
    # channel i accumulates bins 0..i (reference cumsum_channel,
    # representations.py:126-129)
    hist = torch.cumsum(hist, dim=0, dtype=torch.int32)
    if count_cutoff is not None:
        hist = torch.clamp(hist, -count_cutoff, count_cutoff)
    return hist
