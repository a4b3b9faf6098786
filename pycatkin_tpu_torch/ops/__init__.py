"""Batched tensor kernels: thermochemistry, rate constants, the reaction
network and the dense-solve seam with its CUDA kernels."""
