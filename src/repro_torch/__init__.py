"""PyTorch/CUDA port of the rAge-k federated-learning system.

The package mirrors ``repro``'s layout (configs, core, data, dist, fl,
kernels, models, optim). It imports ``torch``, numpy and the standard
library only. Entry points take ``device=None``, which means the CUDA
card; the CPU is used only when the caller passes ``device="cpu"``.
``repro.dist``'s sharding rules (``dist/sharding.py``) have no
counterpart yet: they come with ROADMAP item 16.9.
"""
