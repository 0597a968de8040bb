"""block_attention kernel: see ops.py."""
