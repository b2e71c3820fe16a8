"""`block_mlp`'s share of its roofline in the traced batches, in %: the
least time of each of its launches at its stage's shape (`work.py`,
the larger of FLOPs over the bf16 peak (fp32 for the NMS) and bytes over
3.35 TB/s) over the launches' profiled device time. None where the
trace holds no launch of it."""


def read(run):
    v = run.values.get("roofline.block_mlp_kernel")
    return None if v is None else 100.0 * v
