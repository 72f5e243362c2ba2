"""The data-parallel gradient collective: the port of ``repro.dist``'s
sparse (rAge-k) synchronization (``dist.sparse_sync``). The sharding
rules engine (``repro.dist.sharding``) comes with ROADMAP queue 1, item
16.9."""
from repro_torch.dist.sparse_sync import (  # noqa: F401
    BufferState, age_state_bytes, init_age_state, init_age_state_sharded,
    make_buffered_sync, make_manual_sync, make_sync_train_step, sync_grads,
)
