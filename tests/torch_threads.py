"""One intra-op thread for PyTorch while a port test module runs.

The suite runs under ``pytest-xdist`` with six workers on an 8-core host,
and PyTorch's CPU default is one OpenMP thread per core in every worker:
six pools of spinning threads on the same cores. Six concurrent runs of
tests/test_torch_replay_cli.py took 28-30 s each with one thread and
334-336 s each with the default. Every port test module
imports :func:`one_torch_thread`, an autouse fixture that sets one thread
for the module and restores the previous count after it, so the JAX
package's tests keep PyTorch's default.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)
