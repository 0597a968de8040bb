"""llama-3.2-vision-11b — decoder + cross-attention every 5th layer; the
vision frontend is a stub (precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=500000.0,
    cross_period=5, n_vision_tokens=1601)
