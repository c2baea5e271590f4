"""Caps PyTorch's intra-op thread pool in the port's test processes.

The tier-1 command runs the tests in six pytest-xdist workers on one
machine, and each worker's PyTorch would otherwise start a pool as wide
as the machine: the workers' pools then contend for the same cores, and
a small CPU test takes many times its time alone. Every
`tests/test_torch_*.py` file imports this module (through
`torch_replay` or directly). The cap touches only PyTorch's pool; JAX's
XLA threads are its own. Under six workers two threads ran the port's
files a little faster than one, and both about three times as fast as
no cap.
"""

import torch

TORCH_THREADS = 2

torch.set_num_threads(TORCH_THREADS)
