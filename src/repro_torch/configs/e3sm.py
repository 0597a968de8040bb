"""Paper E3SM setup (Sec. III): blocks (6,16,16) -> 1536; k=5 per hyper-block;
GAE at (16,16)=256; latent 64; bins 0.01 (HBAE) / 0.1 (BAE)."""
from repro_torch.core.pipeline import CompressorConfig

CONFIG = CompressorConfig(
    block_elems=6 * 16 * 16, k=5, emb=128, hidden=512, hb_latent=64,
    bae_hidden=512, bae_latent=16, hb_bin=0.01, bae_bin=0.1, gae_bin=0.02,
    gae_block_elems=16 * 16)

BLOCK_SHAPE = (6, 16, 16)          # (t, y, x)
HYPERBLOCK_K = 5
NORMALIZATION = "zscore"
