"""Running over a mesh of devices: the compressor sharded (``mesh_exec``)
with its multi-shard parity check (``mesh_check``); the LMs' partition
rules and placement (``sharding``), collectives (``collectives``) and GPipe
(``pipeline``)."""
