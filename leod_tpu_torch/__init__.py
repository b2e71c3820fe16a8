"""PyTorch/CUDA port of `leod_tpu` (recurrent RVT event-camera detection).

The JAX package `leod_tpu` is the reference; this package computes the
same functions with PyTorch modules and, on an NVIDIA Hopper card,
hand-written CUDA kernels in place of the Pallas kernels
(`ops/maxvit_cuda.py`, `ops/nms_cuda.py`, sources under `csrc/`).
It imports neither `jax` nor anything of `leod_tpu`.

Public functions keep the JAX package's NHWC layout. Entry points
(`Detector`, `make_serve_step`, `ServingEngine`) run on `device="cuda"`
unless the caller passes `device="cpu"`.
"""


def resolve_device(device) -> "torch.device":
    """The torch device an entry point runs on. `cuda` without a card
    raises: there is no quiet fallback to the CPU."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "leod_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
