"""Tiled sparse K2 backend: for now only its dense-column threshold.

Counterpart of ``tulip_tpu/kkt/sparse_ldl.py``. ``dense_threshold`` is a
verbatim copy; the structure probe (``model._probe_structure``) reads it.
``SparseK2Backend`` (``"sparse-ldl"``) is not ported yet: ROADMAP queue 1,
item 8c.
"""

from __future__ import annotations


def dense_threshold(dim: int) -> float:
    """A column of A with >= this many nonzeros (out of ``dim``) counts as
    dense: it produces a ~nnz² clique of fill under elimination, which at
    40% of the dimension stops being 'sparse plus exceptions'."""
    return max(32.0, 0.4 * dim)
