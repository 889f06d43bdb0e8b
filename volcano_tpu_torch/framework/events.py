"""Session events fired at every allocate/deallocate mutation.

A copy of ``volcano_tpu/framework/events.py``.

Reference: pkg/scheduler/framework/events.go.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from volcano_tpu_torch.api import TaskInfo


@dataclass
class Event:
    task: TaskInfo


@dataclass
class EventHandler:
    allocate_func: Optional[Callable[[Event], None]] = None
    deallocate_func: Optional[Callable[[Event], None]] = None
