"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, rope_theta=500000.0,
    n_experts=16, top_k=1, shared_expert=True)
