"""whisper-medium — encoder-decoder (24+24L); conv/mel frontend is a stub
(precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64,
    n_enc_layers=24, n_frames=1500)
