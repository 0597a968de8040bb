"""granite-moe-3b-a800m — MoE 40 experts top-8 (per-expert d_ff=512).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64, rope_theta=10000.0, tie_embeddings=True,
    n_experts=40, top_k=8, shared_expert=False)
