"""GC quiesce: thaw, collect, freeze.

A copy of ``volcano_tpu/utils/gcutil.py``.  Long-lived cluster state (a
50k-pod cache graph is millions of objects) makes every gen-2 collection
inside a hot region re-traverse it all; freezing survivors into the
permanent generation removes them from the collector's working set.
Thaw first so objects frozen by a PREVIOUS quiesce that have since died
in a cycle are reclaimed — delayed by one quiesce interval, never
leaked.  Used by the scheduler loop (``gc_quiesce_period``).
"""

from __future__ import annotations

import gc


def gc_quiesce() -> None:
    gc.unfreeze()
    gc.collect()
    gc.freeze()
