"""rAge-k core: age vectors, sparsifiers, clustering, compression theory
(the port of ``repro.core``'s exports). ``segmented_age_topk`` is
``kernels.ops.segmented_age_topk``: the CUDA kernel for tensors on the
card, its plain version on the CPU."""
from repro_torch.core.sparsify import (  # noqa: F401
    rage_k, rtop_k, top_k, random_k, apply_method,
    bucket_budgets, flatten_buckets, unflatten_buckets,
)
from repro_torch.core.strategies import (  # noqa: F401
    Strategy, RAgeK, RTopK, TopK, RandomK, Dense, CAFeAgeK, make_strategy,
    age_select, segment_pack, segmented_rage_select, SegmentedSelection,
)
from repro_torch.kernels.ops import segmented_age_topk  # noqa: F401
from repro_torch.core.age import AgeState  # noqa: F401
from repro_torch.core.clustering import (  # noqa: F401
    similarity_matrix, connectivity_matrix, dbscan, cluster_clients,
)
from repro_torch.core.compression import (  # noqa: F401
    gamma_rage_k, gamma_top_k, beta_of, contraction, bytes_per_round,
)
from repro_torch.core.protocol import ParameterServer, Round  # noqa: F401
