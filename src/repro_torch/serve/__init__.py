"""Serving: batched prefill + decode with continuous batching."""
