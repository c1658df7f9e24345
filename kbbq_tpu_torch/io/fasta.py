"""FASTA reader of the reference sequences a CRAM may be encoded against.

Counterpart of ``kbbq_tpu/benchmark.py::read_fasta`` (the port keeps its own
copy; the port's ``benchmark.py`` imports it from here).
"""

from __future__ import annotations

import gzip


def read_fasta(path: str) -> dict:
    """name -> uppercase sequence bytes (plain or gzip)."""
    op = gzip.open if str(path).endswith(".gz") else open
    seqs = {}
    name = None
    chunks = []
    with op(path, "rb") as f:
        for line in f:
            line = line.rstrip()
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = b"".join(chunks).upper()
                name = line[1:].split()[0].decode()
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = b"".join(chunks).upper()
    return seqs
