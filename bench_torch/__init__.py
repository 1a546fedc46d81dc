"""The benchmark of the PyTorch and CUDA codec (huffman_tpu_torch)."""
