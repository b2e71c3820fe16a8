"""The port's ops. Importing the package registers the kernel launches as
`torch.library` custom ops (`leod_tpu_torch::block_attention`,
`::block_mlp`, `::lstm_update`, `::nms_mask`), which a loaded serving
artifact calls; nothing is built until a launch."""
from . import maxvit_cuda, nms_cuda  # noqa: F401
