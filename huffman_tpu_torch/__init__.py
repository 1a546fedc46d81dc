"""huffman_tpu_torch — the PyTorch/CUDA port of huffman_tpu.

A second package beside the JAX one, with the same module names: the
host codebook (codebook.py) and its models (models/), the device stages
(ops/: histogram, scan and the plain PyTorch version of each kernel), the
hand-written CUDA kernels (csrc/, wrapped in ops/cuda/) for block encode,
dense pack, dense decode, substream encode, wide emit and wide decode, the
dense API (api.py), the wide format (wide.py), the sharded codec over a
device mesh (parallel/), the .htz v1 and v3 containers (container.py), the
golden checks (golden/: its own copies of the C++ golden codec and the
wide format's specification; verify.py), state conversion from the JAX
package (convert.py), timing, stats and device probes (utils/) and the
CLI.  It imports torch and numpy, never jax, and imports, reads or builds
nothing of the huffman_tpu package.
"""

from .codebook import Codebook, byte_histogram_host, entropy_bits_per_byte
from .config import DEFAULT_CONFIG, NUM_SYMBOLS, CodecConfig

__all__ = [
    "CodecConfig", "DEFAULT_CONFIG", "NUM_SYMBOLS",
    "Codebook", "entropy_bits_per_byte", "byte_histogram_host",
]
