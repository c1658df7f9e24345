"""More than one device on one host: the replicated-filter layout over
``torch.distributed`` (counterpart of ``kbbq_tpu/parallel/``, less the
hash-space-sharded filters of ``sharded_bloom.py`` and the hosts of
``multihost.py``).

- ``mesh``             — the group of ranks: one spawned process per card
                         (NCCL) or per CPU rank (gloo), ``launch``,
                         ``SharedArrays``.
- ``merge``            — the pass-boundary merges: ``or_merge``,
                         ``sum_merge``, ``broadcast_table``.
- ``resident_sharded`` — the resident path on each rank's rows.
- ``sharded``          — the windowed engine on each rank's windows, and the
                         multi-device dispatch of the entry points.
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
