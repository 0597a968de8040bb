"""The LM side of the port: dense transformer (qwen family) and Mamba-2 SSD
models, with parameters as nested dicts of tensors on the JAX package's
paths and layouts, and the stacked-layer axis kept in front."""
