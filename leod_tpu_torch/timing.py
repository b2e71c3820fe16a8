"""Host timers of the entry points' optional `timings` dicts."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch


def lap(timings: Optional[Dict[str, List[float]]], key: str,
        t_start: float, sync: Optional[torch.device] = None) -> float:
    """Append the host ms since `t_start` to `timings[key]`, where
    `timings` is given, after synchronizing `sync` when it is a card;
    returns the clock's reading, the start of the next lap."""
    if timings is not None:
        if sync is not None and sync.type == "cuda":
            torch.cuda.synchronize(sync)
        timings.setdefault(key, []).append(
            (time.perf_counter() - t_start) * 1e3)
    return time.perf_counter()
