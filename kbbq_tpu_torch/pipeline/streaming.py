"""Streamed FASTQ -> FASTQ recalibration with bounded host memory.

Counterpart of ``kbbq_tpu/pipeline/streaming.py::
recalibrate_fastq_streaming`` on one device (its ``devices <= 1`` branch):
the input is read from disk chunk by chunk, through the windowed engine of
``pipeline/stream_resident.py``, with pass-boundary checkpoints and pass-4
chunk-offset resume.  On one device the public entry point IS the engine's
FASTQ entry point; the multi-device route (``StreamingBatches``, the sharded
pipelines) comes with the multi-GPU slice.
"""

from .stream_resident import (
    recalibrate_fastq_stream_resident as recalibrate_fastq_streaming)

__all__ = ["recalibrate_fastq_streaming"]
