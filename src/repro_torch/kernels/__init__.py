"""Hand-written Hopper kernels of the port, one sub-package per kernel.

Each ``ops`` module holds the kernel's wrapper, its plain PyTorch version and
its launch counter.  The wrapper takes the plain version for CPU tensors and
launches the CUDA kernel (built by ``repro_torch.kernels.build``) for CUDA
tensors; it never falls back from one to the other.
"""
