"""Shape buckets for padded request tensors (copy of
``promptttspp_tpu/data/batching.py::round_up`` / ``bucket_shape``).

Padding lengths up to fixed quanta keeps the set of request shapes small,
and the parity tests run the port at exactly the padded shapes the JAX
package uses.
"""

from __future__ import annotations


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def bucket_shape(length: int, quantum: int, minimum: int = 0) -> int:
    """Round a padded length up to the next shape bucket."""
    return max(round_up(max(length, 1), quantum), minimum)
