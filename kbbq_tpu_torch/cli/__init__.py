"""Command line: ``kbbq-tpu-torch {recalibrate,applybqsr,benchmark,plot}``
(``python -m kbbq_tpu_torch``), the counterpart of ``kbbq_tpu.cli``.

Flag names and semantics mirror the reference CLI (-k, -g, -c, -a/--alpha,
-u/--use-oq, -s/--set-oq).
"""

from .main import main
