"""Batched problems on one device.

Counterpart of :mod:`darsia_tpu.parallel`, of which only the batched W1 solve
is ported: on one card the batch is a leading tensor axis.  The mesh-sharded
parts (``sharded_wasserstein_batch``, the halo exchange, the sharded
pipelines) wait for a multi-GPU port (ROADMAP.md, Queue 1, item 8).
"""

from .wasserstein import batched_wasserstein

__all__ = ["batched_wasserstein"]
