"""Baseline compressors for the paper's comparisons: ``szlike`` (SZ3's
interpolation predictor), ``zfplike`` (ZFP's transform coding), ``block_ae``
(the ablation's block-wise FC autoencoder), all on the ``codec`` protocol."""
