"""Each pytest-xdist worker's share of the cores for PyTorch.

PyTorch starts one intra-op thread a core in every process.  Under
``-n 6`` on eight cores that is 48 threads, and the port's tests run
many small ops (the tile designs' rebuilds, the plain versions of the
kernels), each of which waits on its pool's threads at its end: with the
cores taken by the other workers, an op that takes microseconds alone
waits milliseconds, and a rebuild that takes 0.3 s alone took 20–70 s.

Every xdist worker collects every test module before it runs a test, so
importing this module sets the share for the whole run: the cores this
process may use, divided by the workers, at least one.  A run without
xdist keeps PyTorch's default.  Run a few files under xdist with this
one among them (``tests/test_torch_workers.py tests/test_torch_knn.py
-n 6``) to give them the share too.
"""

import os

import torch

_DEFAULT_THREADS = torch.get_num_threads()


def worker_threads():
    """The intra-op threads of one xdist worker, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


if worker_threads() is not None:
    torch.set_num_threads(worker_threads())


def test_worker_takes_its_share_of_the_cores():
    want = worker_threads()
    assert torch.get_num_threads() == (want or _DEFAULT_THREADS)
