"""The paper's Network-2 (CIFAR10), 2,515,338 parameters (Table I): the
port's copy of ``repro.configs.cifar_cnn``.

Reconstruction (matches the count exactly):
  Conv(3,64,3)+BN(64) -> MaxPool(2,2) -> Conv(64,128,3)+BN(128)
  -> Conv(128,256,3,stride2)+BN(256) -> Conv(256,512,3,stride2)+BN(512)
  -> flatten(2*2*512=2048) -> FC(2048,128) -> FC(128,256) -> FC(256,512)
  -> FC(512,1024) -> FC(1024,10).
The table's "BN(64)" after the 128-channel conv is a typo (the count only
matches BN(128)); strides are chosen so that the flatten size equals the
table's FC(2048, 128) input. ``FederatedEngine("cnn")`` builds the model
(``models/paper_nets.py``); it is no LM, so ``launch.serve`` refuses it.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="cifar-cnn",
    family="cnn",
    n_layers=9,
    d_model=512,
    vocab_size=10,
    act="relu",
    mlp_type="dense",
    dtype="float32",
    remat=False,
    source="rAge-k paper, Table I Network 2",
)


def smoke_config() -> ArchConfig:
    return CONFIG
