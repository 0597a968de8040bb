"""mamba2-370m — SSD (state-space duality), attention-free, d_ff=0.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280,
    ssm_state=128, expand=2, ssm_headdim=64, ssm_chunk=256, ssm_ngroups=1,
    subquadratic=True)
