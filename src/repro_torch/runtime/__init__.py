"""Host-side runtime of the port: the ``.rba`` archive container and the
error-bounded KV cache of the serving engine."""
