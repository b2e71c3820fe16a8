"""The window's share of the card's bf16 peak: 3 x the forward FLOPs of
the frames trained (the backbone over every frame, the FPN and head over
the harvested ones; no recompute counted), by FlopCounterMode over the
reference model, over (window s x 989 TFLOP/s), in %."""
from portbench.work import PEAK_BF16


def read(run):
    flops = run.values.get("flops")
    if not flops or run.window_s <= 0:
        return None
    return 100.0 * flops / (run.window_s * PEAK_BF16)
