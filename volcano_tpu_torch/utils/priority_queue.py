"""Heap priority queue driven by a less-function.

A copy of ``volcano_tpu/utils/priority_queue.py``.

Reference: pkg/scheduler/util/priority_queue.go (container/heap over LessFn).
Stable for equal elements via an insertion sequence number, which also gives
deterministic pop order — a requirement for bindings-equivalence with the
device path.
"""

from __future__ import annotations

import functools
import heapq
from typing import Callable, List


class PriorityQueue:
    def __init__(self, less_fn: Callable[[object, object], bool]):
        self._less = less_fn
        self._heap: List = []
        self._seq = 0

    def push(self, item) -> None:
        heapq.heappush(self._heap, _Entry(item, self._seq, self._less))
        self._seq += 1

    def pop(self):
        if not self._heap:
            return None
        return heapq.heappop(self._heap).item

    def empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)


@functools.total_ordering
class _Entry:
    __slots__ = ("item", "seq", "less")

    def __init__(self, item, seq: int, less):
        self.item = item
        self.seq = seq
        self.less = less

    def __lt__(self, other: "_Entry") -> bool:
        if self.less(self.item, other.item):
            return True
        if self.less(other.item, self.item):
            return False
        return self.seq < other.seq

    def __eq__(self, other) -> bool:
        return self is other
