from repro_torch.checkpoint.io import (list_checkpoints,  # noqa: F401
                                       load_checkpoint, prune_checkpoints,
                                       save_checkpoint)
from repro_torch.checkpoint.async_ckpt import AsyncCheckpointer  # noqa: F401
