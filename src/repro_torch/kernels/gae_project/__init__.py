"""gae_project kernel: see ops.py."""
