"""Optimizers and schedules (``repro_torch.train.optim``)."""
