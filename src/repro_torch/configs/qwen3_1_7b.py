"""qwen3-1.7b — dense, qk-norm, GQA. [hf:Qwen/Qwen3-8B (family); hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, head_dim=128, rope_theta=1000000.0,
    qk_norm=True, tie_embeddings=True)
