"""Device stages of the codec.

ops/{encode,pack,decode,wide}.py hold the plain PyTorch version of each
kernel; ops/cuda/ holds the wrappers that launch the hand-written CUDA
kernels (csrc/) on CUDA tensors and take the plain version only for CPU
tensors.  Counter (utils/timing.py) counts their launches and plain calls.
"""

from ..utils.timing import Counter

__all__ = ["Counter"]
