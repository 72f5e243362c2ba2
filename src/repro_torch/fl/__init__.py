"""The federated runtime: the synchronous engine, the participation and
fault planes, the async PS service and the server math (the port of
``repro.fl``'s exports)."""
from repro_torch.fl.engine import (  # noqa: F401
    DeviceAgeState, FederatedEngine, FLResult, rage_select,
    rage_select_segmented,
)
from repro_torch.fl.faults import FaultModel  # noqa: F401
from repro_torch.fl.latency import LatencyModel  # noqa: F401
from repro_torch.fl.schedule import (  # noqa: F401
    SCHEDULES, AoIBalanced, Deadline, Full, RoundPlan, SchedState,
    Scheduler, UniformM, make_scheduler,
)
from repro_torch.fl.service import (  # noqa: F401
    AsyncService, ServiceResult, ServiceState,
)
from repro_torch.fl.simulation import run_fl  # noqa: F401
from repro_torch.fl.server import (  # noqa: F401
    GlobalServer, aggregate_sparse, aggregate_sparse_fused,
)
