"""The distributed runtime: the port of ``repro.dist``. The sharding
rules engine (``dist.sharding``: logical axis names resolved against the
active mesh, DTensor placements), the sparse (rAge-k) gradient
synchronization (``dist.sparse_sync``), and the local regions through
which the dry run's DTensors pass where DTensor has no rule
(``dist.regions``)."""
from repro_torch.dist.sparse_sync import (  # noqa: F401
    BufferState, age_state_bytes, init_age_state, init_age_state_sharded,
    make_buffered_sync, make_manual_sync, make_sync_train_step, sync_grads,
)
