"""The window's share of the card's bf16 peak, in %: the forward FLOPs
of the window's batches (the backbone over every slot's frames, padding
included, as the device runs them; the FPN and head over the harvested
frames), by FlopCounterMode over the reference model, over (window s x
989 TFLOP/s)."""
from portbench.work import PEAK_BF16


def read(run):
    flops = run.values.get("flops")
    if not flops or run.window_s <= 0:
        return None
    return 100.0 * flops / (run.window_s * PEAK_BF16)
