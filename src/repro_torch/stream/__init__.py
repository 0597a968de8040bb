"""Streaming compression subsystem: pipelined stage scheduler with
device/host overlap plus an appendable archive writer.

``stream_compress`` runs the SAME per-stripe stages as the batch
``HierarchicalCompressor.compress`` — device front-end, GAE error-bound
coding, chunk entropy coding — but pipelined through a ``StreamScheduler``
so host coding of chunk *i* overlaps the device stage of chunk *i+1*, and
finished chunk sections stream to disk through
``repro_torch.runtime.stream_writer.StreamingArchiveWriter`` as they
complete.

See docs/STREAMING.md for the scheduler model and queue/backpressure
semantics (written for the JAX package; the port keeps them).
"""
from repro_torch.stream.compress import (FaultTolerance, StreamResult,
                                         stream_compress)
from repro_torch.stream.scheduler import (RetryPolicy, StageSpec, StageGraph,
                                          StreamScheduler, StreamStats)

__all__ = ["FaultTolerance", "RetryPolicy", "StageSpec", "StageGraph",
           "StreamScheduler", "StreamStats", "StreamResult",
           "stream_compress"]
