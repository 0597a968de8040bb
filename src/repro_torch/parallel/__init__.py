"""Sharding the compressor over a mesh of devices (``mesh_exec``) and its
multi-shard parity check (``mesh_check``)."""
