"""The sharded scheduler federation's shard-map record, read side only.

A copy of ``read_shard_map`` from ``volcano_tpu/federation/leases.py``.
The port has no federation, so nothing in it writes the record; the
incident bundle's ``shard_map.json`` and ``vtctl top``'s target
discovery read it all the same, and find None unless a federation of
the JAX package shares the store.
"""

from __future__ import annotations

import json
from typing import Optional

SHARD_MAP_NAME = "vtpu-shard-map"
SHARD_MAP_KEY = "shards.volcano.tpu/map"
NAMESPACE = "volcano-system"


def read_shard_map(api, namespace: str = NAMESPACE) -> Optional[dict]:
    """The parsed shard-map record, or None when federation never ran.
    Read through the API surface only, so it is the same over the
    in-process store and ``--bus``."""
    cm = api.get("ConfigMap", namespace, SHARD_MAP_NAME)
    if cm is None:
        return None
    try:
        return json.loads(cm.data.get(SHARD_MAP_KEY, ""))
    except (ValueError, AttributeError):
        return None
