"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` dispatches: CPU tensors -> ``ref``; CUDA tensors -> the CUDA
kernels in ``csrc/``, built by ``_build`` at first use.
"""
