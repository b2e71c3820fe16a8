"""A checkout in a temporary directory with the benchmark and two tiny
cells beside its own: RVT-T at 64 x 96 in fp32, trained (B 2, L 3) and
streamed (2 slots of 12 reprs), held to the real cells' limits. The
harness runs there on the CPU, with everything but the look for a card.
"""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = {"tiny_train": ("train_b12_l5", "gen4_train_b12",
                       dict(batch_size=2, seq_len=3, sequences=4, reprs=24,
                            pool_frames=8, profile_from=1, profile_steps=1)),
        "tiny_eval": ("eval_b16", "gen1_eval_b16",
                      dict(batch_size=2, sequences=2, reprs=12, pool_frames=8,
                           checked_slots=2, warm_batches=1,
                           # a label in every window of 3, as the real
                           # cell has in every window of 21
                           first_label=2, label_every=3))}


def make_root(path: str) -> str:
    """The checkout at `path`: BENCHMARK.json and portbench/ copied, the
    port linked, the tiny configuration, traffic, limits and cells
    added."""
    os.makedirs(path, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "leod_tpu_torch"),
               os.path.join(path, "leod_tpu_torch"))
    pb = os.path.join(path, "portbench")
    with open(os.path.join(pb, "configs", "rvt_b_gen1.json")) as f:
        c = json.load(f)
    c["name"] = "rvt_t_tiny"
    c["preset"]["size"] = "tiny"
    c["model"].update(embed_dim=32, fpn_depth=0.33, partition_size=[2, 3],
                      in_res_hw=[64, 96])
    c["dataset"].update(resolution_hw=[64, 96], sequence_length=3)
    c["training"].update(precision="fp32", batch_size=2)
    _dump(os.path.join(pb, "configs", "rvt_t_tiny.json"), c)
    with open(os.path.join(path, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "rvt_t_tiny", "source": "test",
                         "file": "portbench/configs/rvt_t_tiny.json",
                         "reduced": [], "why": "test"})
    for cell, (traffic, real, over) in TINY.items():
        with open(os.path.join(pb, "traffic", traffic + ".json")) as f:
            t = json.load(f)
        t.update(over)
        _dump(os.path.join(pb, "traffic", cell + ".json"), t)
        shutil.copy(os.path.join(pb, "limits", real + ".json"),
                    os.path.join(pb, "limits", cell + ".json"))
        b["workloads"].append({"name": cell, "config": "rvt_t_tiny",
                               "traffic": cell, "chips": 1, "why": "test"})
        for m in b["end_to_end"] + b["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    _dump(os.path.join(path, "BENCHMARK.json"), b)
    return path


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
