"""Command-line entry points of the port (ports of the JAX package's
`cli/train.py`, `cli/val.py`, `cli/predict.py`, `cli/val_dst.py` and
`tools/selftrain_cycle.sh`):

    python -m leod_tpu_torch.cli.train ...
    python -m leod_tpu_torch.cli.val ...
    python -m leod_tpu_torch.cli.predict ...
    python -m leod_tpu_torch.cli.val_dst ...
    python -m leod_tpu_torch.cli.selftrain_cycle ...

Each takes the JAX CLI's flags and builds the same `ExperimentConfig`.
Each runs on the card unless `--cpu` is given. A flag the port does not
implement raises with the `ROADMAP.md` item that covers it.

Every `main(argv=None, *, frames=None)` can be called in process.
`frames` is the one seam against the JAX CLIs. It is an in-memory frame
store, {"<split>/<sequence>": [T, C, H, W] uint8} (`data/synthetic.py`
`render_dataset_frames`), for a dataset whose label and index files are
on disk under `--path` and whose event frames are in memory, not in h5
files (a machine may lack `h5py`). `--synthetic` renders such a store
from `--seed` and writes the label and index files that the JAX
package's `generate_dataset` writes; `selftrain_cycle` renders one and
passes it to every stage.
"""
