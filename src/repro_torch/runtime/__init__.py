"""Host-side runtime of the port: the ``.rba`` archive container."""
