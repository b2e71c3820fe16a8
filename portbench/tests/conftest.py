"""The tiny cells run a model on the CPU: two threads a test process, so
that several processes (`pytest -n`) do not oversubscribe the cores."""
import torch

torch.set_num_threads(2)
