"""repro_torch: the PyTorch and CUDA port of the hierarchical compressor.

The JAX package ``repro`` is the reference; this package computes the same
compress -> decompress path with PyTorch tensors and hand-written Hopper
kernels (``repro_torch.kernels``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
