"""The port's tests run torch, and numpy's BLAS, on one thread.

Tier-1 runs six pytest-xdist workers on eight cores. In each worker torch's
OpenMP pool and numpy's OpenBLAS pool take every core, and their threads
spin between the many small ops of these tests, so six workers keep dozens
of threads busy on eight cores and every test, the JAX side's too, runs
several times slower than alone. Each port test file imports
`one_torch_thread`, an autouse fixture that runs the file's tests with one
intra-op thread and one BLAS thread and gives the pools their sizes back
afterwards. Only the speed changes: the tests compare each side within one
process, or against the JAX package at a stated tolerance.
"""
import contextlib

import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:              # the BLAS pool keeps its size
    threadpool_limits = None


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    blas = threadpool_limits(1, user_api="blas") if threadpool_limits \
        else contextlib.nullcontext()
    with blas:
        yield
    torch.set_num_threads(before)


def test_port_tests_run_torch_on_one_thread():
    assert torch.get_num_threads() == 1
    assert float(torch.arange(1000.0).sum()) == 499500.0
    if threadpool_limits is not None:
        from threadpoolctl import threadpool_info
        assert all(p["num_threads"] == 1 for p in threadpool_info()
                   if p["user_api"] == "blas")
