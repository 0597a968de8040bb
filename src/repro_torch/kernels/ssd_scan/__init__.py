"""Mamba-2 chunked SSD scan, ``ops``."""
