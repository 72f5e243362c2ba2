from repro_torch.optim.optimizers import (  # noqa: F401
    adam, sgd, OptState, apply_updates, clip_by_global_norm, cosine_schedule,
)
from repro_torch.optim.error_feedback import (  # noqa: F401
    ef_init, ef_compensate, ef_update,
)
