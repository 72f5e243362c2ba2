"""Synthetic datasets, the paper's non-i.i.d. splits, the batch
pipelines and the LM token stream (the port of ``repro.data``'s
exports)."""
from repro_torch.data.synthetic import (  # noqa: F401
    make_image_dataset, mnist_like, cifar10_like,
)
from repro_torch.data.federated import (  # noqa: F401
    label_partition, paper_mnist_split, paper_cifar_split,
)
from repro_torch.data.pipeline import (  # noqa: F401
    BatchIterator, DeviceShardStore, SamplerState, token_stream,
)
