"""recurrentgemma-9b — RG-LRU + local attention, (rec,rec,attn) 2:1 pattern.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256, rope_theta=10000.0,
    attn_period=3, window=2048, lru_width=4096, conv_width=4,
    subquadratic=True)
