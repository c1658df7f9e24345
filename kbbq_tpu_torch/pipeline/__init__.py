"""FASTQ -> FASTQ recalibration on one device (counterpart of
``kbbq_tpu.pipeline``): the resident path, the windowed engine and the
streamed entry point."""

from .recalibrate import RecalConfig, recalibrate_fastq, run_pipeline
from .resident import recalibrate_arrays_resident
from .stream_resident import recalibrate_arrays_windowed
from .streaming import recalibrate_fastq_streaming
