"""FASTQ -> FASTQ and BAM/SAM -> BAM/SAM recalibration on one device
(counterpart of ``kbbq_tpu.pipeline``): the resident path, the windowed
engine and the streamed entry points."""

from .bam import recalibrate_bam, recalibrate_bam_streaming
from .recalibrate import RecalConfig, recalibrate_fastq, run_pipeline
from .resident import recalibrate_arrays_resident
from .stream_resident import recalibrate_arrays_windowed
from .streaming import recalibrate_fastq_streaming
