"""PyTorch/CUDA port of the rAge-k federated-learning system.

The package mirrors ``repro``'s layout (configs, core, data, dist, fl,
kernels, models, optim). It imports ``torch``, numpy and the standard
library only. Entry points take ``device=None``, which means the CUDA
card; the CPU is used only when the caller passes ``device="cpu"``,
and the dry run (``launch.dryrun``), which traces on fake tensors, uses
no device at all.
"""
