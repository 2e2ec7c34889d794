"""PyTorch's intra-op threads for the port's tests: ``THREADS`` while a
module's tests run, the process's own count restored after.

The suite's verify command (ROADMAP.md, ``-n 6``) puts six pytest workers
on one machine, and PyTorch gives each as many OpenMP threads as the
machine has cores. A parallel region
then waits at its barrier for threads that other workers' threads hold off
their cores, so the many small operations of the tiny models (and of the
data pipeline's steps) each cost a scheduler time slice: a file whose tests
take 15-30 s alone took 300-450 s beside five others at the default and
19-70 s with two threads a process. A test module takes the cap with
``from tests.torch_threads import torch_threads  # noqa: F401``."""
import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(saved)
