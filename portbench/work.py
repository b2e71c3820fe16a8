"""The yardstick's arithmetic: published peaks, the least time a piece
of work can take on the card, the forward FLOPs of the model at a
cell's shapes, and the work of each hand-written kernel.

`bound` and the peaks are frozen copies of `chip_smoke.py` lines
453-455 and 793-797; `attn_work`, `mlp_work` and `lstm_work` are the
counts of `chip_smoke.py` `attn_work` (852-864), `mlp_work` (837-849)
and `lstm_work` (893-902), rewritten over a stage's widths instead of
its modules so that a later change of a module cannot change them.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16 = 989e12          # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s
BF16 = 2


def bound(flops: float, nbytes: float, peak_ops: float) -> Tuple[float, str]:
    """(least seconds, what binds it)."""
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def attn_work(c: int, t: int, n_tok: int, has_norm1: bool):
    """(FLOPs, bytes) of `block_attention` over n_tok tokens of width c
    in partitions of t tokens: q|k|v, q k^T and p v; x read and o
    written once in bf16, the qkv weights and bias and LN1's vectors."""
    flops = 2 * n_tok * c * 3 * c + 4 * n_tok * t * c
    wbytes = (3 * c * c + 3 * c + (2 * c if has_norm1 else 0)) * BF16
    return flops, wbytes + n_tok * 2 * c * BF16


def mlp_work(c: int, inner: int, n_tok: int):
    """(FLOPs, bytes) of `block_mlp` over n_tok tokens: the projection
    and both MLP layers; their weights and vectors (proj, norm2, the MLP,
    ls1, ls2), x and o read and the output written once, in bf16."""
    flops = 2 * n_tok * c * c + 2 * n_tok * c * inner + 2 * n_tok * inner * c
    wbytes = (c * c + c + 2 * c + c * inner + inner + inner * c + c
              + 2 * c) * BF16
    return flops, wbytes + 3 * n_tok * c * BF16


def lstm_work(c: int, n_tok: int, c_bytes: int = BF16):
    """(FLOPs, bytes) of `lstm_update`: the [4C, 2C] gate mix over every
    token; x, h in and h' out in bf16, c in and c' out, the gate
    weights and bias."""
    wbytes = (4 * c * 2 * c + 4 * c) * BF16
    return 2 * n_tok * 2 * c * 4 * c, wbytes + 3 * n_tok * c * BF16 \
        + 2 * n_tok * c * c_bytes


def stage_shapes(model: Dict) -> Dict[int, Dict[str, int]]:
    """{stage width C: its map's tokens a frame, partition tokens, MLP
    width} from a configuration's `model` block."""
    h, w = model["in_res_hw"]
    ph, pw = model["partition_size"]
    out = {}
    for i, k in enumerate(model["dim_multiplier"]):
        c = model["embed_dim"] * k
        s = 4 * 2 ** i
        out[c] = {"tokens": (h // s) * (w // s), "t": ph * pw,
                  "inner": c * model["mlp_ratio"]}
    return out


def forward_flops(config: Dict) -> Tuple[float, float]:
    """(backbone FLOPs a frame, FPN + head FLOPs a frame) of the
    reference model at the configuration's input, counted by
    `torch.utils.flop_counter.FlopCounterMode` on meta tensors (matrix
    products and convolutions), whatever implements the program's
    step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.model import Anchors, Numerics, RVTDetector
    m = config["model"]
    nm = Numerics("fp32")
    with torch.device("meta"):
        model = RVTDetector(m)
        h, w = m["in_res_hw"]
        x = torch.zeros(1, h, w, m["input_channels"])
        states = model.zero_states(1, "meta")
        with FlopCounterMode(display=False) as fc:
            feats, _ = model.backbone_step(x, states, nm)
        bb = fc.get_total_flops()
        anchors = Anchors((h, w), m["strides"], "meta")
        with FlopCounterMode(display=False) as fc:
            model.detect(feats, anchors, nm, train=False, sigmoid=True)
        head = fc.get_total_flops()
    return float(bb), float(head)
