"""Blocking, normalization and synthetic datasets (pure numpy)."""
