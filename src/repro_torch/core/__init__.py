"""The compressor's numerics and pipeline, ported to PyTorch.

Import the modules directly (``repro_torch.core.pipeline`` and so on); this
package file imports nothing, so that ``import repro_torch.core.errors``
stays free of torch.
"""
