"""The scheduler cache: its interface and the synchronous
``SchedulerCache`` with its change tracking (``PackEpoch``), and
:func:`feed_from_dicts` and :func:`feed_events` to deliver cluster state
carried across as plain dicts."""

from volcano_tpu_torch.cache.interface import Binder, Cache, Evictor, StatusUpdater
from volcano_tpu_torch.cache.cache import PackEpoch, SchedulerCache
from volcano_tpu_torch.cache.feed import feed_events, feed_from_dicts

__all__ = [
    "Binder",
    "Cache",
    "Evictor",
    "StatusUpdater",
    "PackEpoch",
    "SchedulerCache",
    "feed_events",
    "feed_from_dicts",
]
