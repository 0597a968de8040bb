"""qwen2-1.5b — dense, GQA kv=2, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, head_dim=128, rope_theta=1000000.0,
    qkv_bias=True, tie_embeddings=True)
