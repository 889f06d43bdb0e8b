"""Host-side utilities: priority queue, logging.

A copy of ``volcano_tpu/utils/__init__.py``.
"""

from volcano_tpu_torch.utils.priority_queue import PriorityQueue

__all__ = ["PriorityQueue"]
