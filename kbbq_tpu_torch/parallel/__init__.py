"""More than one device: the group of ranks over ``torch.distributed``
(counterpart of ``kbbq_tpu/parallel/``), on one host or several.

- ``mesh``             — the group of ranks: one spawned process per card
                         (NCCL) or per CPU rank (gloo), ``launch`` (with
                         ``Hosts``, one group over several hosts),
                         ``SharedArrays``.
- ``merge``            — the pass-boundary merges: ``or_merge``,
                         ``sum_merge``, ``broadcast_table``.
- ``resident_sharded`` — the resident path on each rank's rows.
- ``sharded``          — the windowed engine on each rank's windows, and the
                         multi-device dispatch of the entry points.
- ``sharded_bloom``    — the hash-space-sharded filters.
- ``multihost``        — several hosts: partitions, the FASTQ, BAM and CRAM
                         routes over one group, per-host parts and
                         checkpoints (imported where used).
"""

from .mesh import Rank, SharedArrays, launch
from .merge import broadcast_table, or_merge, sum_merge
from .resident_sharded import recalibrate_arrays_resident_sharded
from .sharded import (recalibrate_bam_sharded, recalibrate_fastq_sharded,
                      resolve_layout, run_arrays_sharded,
                      sharded_recalibrate_arrays)

__all__ = ["Rank", "SharedArrays", "broadcast_table", "launch", "or_merge",
           "recalibrate_arrays_resident_sharded", "recalibrate_bam_sharded",
           "recalibrate_fastq_sharded", "resolve_layout",
           "run_arrays_sharded", "sharded_recalibrate_arrays", "sum_merge"]
