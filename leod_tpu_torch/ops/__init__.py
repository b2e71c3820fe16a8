"""The port's ops. The kernel launches are custom ops
(`leod_tpu_torch::block_attention`, `::block_mlp`, `::block_mlp_tp`,
`::block_residual`, `::lstm_update`, `::nms_mask`) defined in C++
(`csrc/torch_ops.cpp`); `_build.load()` builds and registers them at the
first use, never at import."""
from . import maxvit_cuda, nms_cuda  # noqa: F401
