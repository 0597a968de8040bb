"""Paper XGC setup (Sec. III): each (39,39) histogram is a block; the 8
toroidal planes at one node form a hyper-block; GAE per histogram (1521);
latent 64; bins 0.1/0.1."""
from repro_torch.core.pipeline import CompressorConfig

CONFIG = CompressorConfig(
    block_elems=39 * 39, k=8, emb=128, hidden=512, hb_latent=64,
    bae_hidden=512, bae_latent=16, hb_bin=0.1, bae_bin=0.1, gae_bin=0.05,
    gae_block_elems=39 * 39)

BLOCK_SHAPE = (39, 39)             # one velocity histogram
HYPERBLOCK_K = 8
NORMALIZATION = "zscore"
