"""Torch's intra-op threads in the port's test modules.

Under pytest-xdist every worker is a process of its own, and torch's
default gives each of them one thread a core: six workers on eight cores
run 48 threads that spin against each other. Each port test module calls
:func:`share_cores` at import, which gives every worker its share of the
cores. A run on one process keeps torch's default.
"""
import os


def share_cores(torch) -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
