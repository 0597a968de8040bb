"""quantize kernel: see ops.py."""
