"""Host-side IO of the port: FASTQ reader/writer (NumPy) and ReadArrays."""

from .batcher import ReadArrays
from .fastq import FastqData, read_fastq, write_fastq_with_quals
