"""The paper's Network-1 (MNIST): FC(784,50) + ReLU + FC(50,10) + softmax,
39,760 parameters (Table I). The port's copy of
``repro.configs.mnist_mlp``; ``FederatedEngine("mlp")`` builds the model."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mnist-mlp",
    family="mlp",
    n_layers=2,
    d_model=50,            # hidden width
    vocab_size=10,         # classes
    act="relu",
    mlp_type="dense",
    dtype="float32",
    remat=False,
    source="rAge-k paper, Table I Network 1",
)


def smoke_config() -> ArchConfig:
    return CONFIG
