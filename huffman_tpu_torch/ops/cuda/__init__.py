"""Wrappers of the hand-written CUDA kernels (csrc/), one module each.

Each wrapper takes the plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, or raises; it never falls back.  `launches`
counts the kernel's launches, `SOURCE` names its CUDA file and `REPLACES`
the Pallas kernel of the JAX package it ports.
"""
