"""The scheduler cache: its interface and the synchronous
``SchedulerCache``, with :func:`feed_from_dicts` to load cluster state
carried across as plain dicts."""

from volcano_tpu_torch.cache.interface import Binder, Cache, Evictor, StatusUpdater
from volcano_tpu_torch.cache.cache import SchedulerCache
from volcano_tpu_torch.cache.feed import feed_from_dicts

__all__ = [
    "Binder",
    "Cache",
    "Evictor",
    "StatusUpdater",
    "SchedulerCache",
    "feed_from_dicts",
]
