"""Resident FASTQ -> FASTQ recalibration (counterpart of
``kbbq_tpu.pipeline``, single device)."""

from .recalibrate import RecalConfig, recalibrate_fastq, run_pipeline
from .resident import recalibrate_arrays_resident
