"""Host-side IO of the port: the FASTQ reader/writer (native codec, NumPy
versions beside it), BGZF, the chunked reader of the streamed path, and
ReadArrays."""

from .batcher import ReadArrays
from .fastq import FastqData, read_fastq, write_fastq_with_quals
