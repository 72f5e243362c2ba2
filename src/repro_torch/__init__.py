"""PyTorch/CUDA port of the rAge-k federated-learning system.

The package mirrors ``repro``'s layout (configs, core, data, fl, kernels,
models, optim). It imports ``torch``, numpy and the standard library only.
Entry points take ``device=None``, which means the CUDA card; the CPU is
used only when the caller passes ``device="cpu"``. ``repro.dist`` (the
sparse gradient collective and the sharding rules) has no counterpart
yet: it comes with ROADMAP item 15.
"""
