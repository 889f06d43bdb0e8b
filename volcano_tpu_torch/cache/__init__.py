"""The scheduler cache: its interface, the ``SchedulerCache`` with its
change tracking (``PackEpoch``), its client half (the default binder,
evictor and status updater over a ``SchedulerClient``, and the pipelined
commit plane), and :func:`feed_from_dicts` and :func:`feed_events` to
deliver cluster state carried across as plain dicts."""

from volcano_tpu_torch.cache.interface import Binder, Cache, Evictor, StatusUpdater
from volcano_tpu_torch.cache.cache import (
    DefaultBinder,
    DefaultEvictor,
    DefaultStatusUpdater,
    PackEpoch,
    SchedulerCache,
)
from volcano_tpu_torch.cache.feed import feed_events, feed_from_dicts

__all__ = [
    "Binder",
    "Cache",
    "Evictor",
    "StatusUpdater",
    "DefaultBinder",
    "DefaultEvictor",
    "DefaultStatusUpdater",
    "PackEpoch",
    "SchedulerCache",
    "feed_events",
    "feed_from_dicts",
]
