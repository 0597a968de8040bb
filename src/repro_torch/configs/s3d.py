"""Paper S3D setup (Sec. III): blocks (58,5,4,4) -> flattened 4640; k=10
temporal blocks per hyper-block; GAE per species at (5,4,4)=80; latent 128;
bins 0.005/0.005."""
from repro_torch.core.pipeline import CompressorConfig

CONFIG = CompressorConfig(
    block_elems=58 * 5 * 4 * 4, k=10, emb=128, hidden=512, hb_latent=128,
    bae_hidden=512, bae_latent=16, hb_bin=0.005, bae_bin=0.005, gae_bin=0.01,
    gae_block_elems=5 * 4 * 4)

BLOCK_SHAPE = (58, 5, 4, 4)        # (species, t, y, x)
HYPERBLOCK_K = 10
NORMALIZATION = "range"            # per-species mean 0 / range 1
