"""Shared set-up of the PyTorch port's tests (tests/test_torch_*.py).

Import `one_cpu_thread` into a test file to run its torch math on one
CPU thread: a process's first multi-threaded CPU `torch.exp` can return
one worker thread's chunk (the unary math kernels split tensors over
2048 elements across threads) at ~12-bit accuracy, while the second call
and a one-thread call are exact (tools/torch_first_exp_race.py: 4 and 5
of 240 fresh processes in two runs, 1791 of 7200 entries up to 1.5e-4
relative off, on torch 2.13 for the CPU with 8 threads). Under xdist a
worker's first torch file makes that first call after any number of JAX
files, and the port's fp32 tolerances rightly refuse such values."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
