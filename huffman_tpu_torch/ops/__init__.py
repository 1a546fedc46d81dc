"""Device stages of the codec.

ops/{encode,pack,decode,wide}.py hold the plain PyTorch version of each
kernel; ops/cuda/ holds the wrappers that launch the hand-written CUDA
kernels (csrc/) on CUDA tensors and take the plain version only for CPU
tensors.
"""


class Counter:
    """A count that a run resets and reads: kernel launches, or calls of a
    plain version on CUDA tensors (which the main path never makes)."""

    def __init__(self) -> None:
        self.n = 0
