"""Deterministic shard assignment + the per-process ownership set.

A copy of ``volcano_tpu/federation/sharding.py``: the same crc32 hashes,
so a port member and a JAX member agree on every slice.

Two fixed hash maps partition the cluster into ``n_shards`` slices:

* **node → shard**: ``crc32(node_name) % n_shards``.  The map never
  changes while ``n_shards`` is fixed, so what rebalancing moves is the
  *shard → holder* assignment (the lease layer) — a joining or dying
  scheduler moves only whole slices, never individual nodes.  This is
  the fixed-slot degenerate case of a consistent-hash ring (slots ==
  shards); crc32 is process-stable, unlike salted ``hash()``.
* **job → home shard**: ``crc32("<namespace>/<group>") % n_shards``
  over the job's namespace-qualified PodGroup identity — the
  namespace/queue tenancy unit, which collapses to the job identity
  under per-job PodGroups (a namespace- or queue-level hash would
  degenerate a single-tenant cluster onto one shard).

Both sides of every boundary (schedulers, vtctl, the
policy-equivalence checker) compute these from the same two
functions, so there is no assignment to gossip — only ownership.
"""

from __future__ import annotations

import threading
import zlib
from typing import Set


def shard_of_node(name: str, n_shards: int) -> int:
    """The shard a node permanently belongs to."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(name.encode()) % n_shards


def home_shard(namespace: str, group: str, n_shards: int) -> int:
    """The shard whose scheduler owns placing a job's tasks first
    (spillover goes cross-shard only after the home cycle failed)."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(f"{namespace}/{group}".encode()) % n_shards


def home_shard_of_job_id(job_id: str, n_shards: int) -> int:
    """Home shard from a cache job uid (already ``namespace/group``)."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(job_id.encode()) % n_shards


class ShardState:
    """The shards this process currently owns.

    Written by the lease-manager thread (acquire/release callbacks),
    read from informer-dispatch threads (the filter) and the scheduler
    thread (spillover eligibility) — hence the lock.  ``n_shards == 1``
    is single-shard federation mode: shard 0 covers everything and the
    filter passes every event through, which is what keeps ``--shards
    1`` bit-identical to the non-federated scheduler.
    """

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self._lock = threading.Lock()
        self._owned: Set[int] = set()  # guarded-by: self._lock

    def set_n_shards(self, n_shards: int) -> None:
        """Adopt a new shard count (the autoscaler's elastic re-key).
        Ownership clears with it: the caller has already released every
        applied shard through the lease callbacks, and slices under the
        new count must be re-claimed through the lease plane — never
        carried over from a partition that no longer exists."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        with self._lock:
            self.n_shards = n_shards
            self._owned.clear()

    def owned(self) -> Set[int]:
        with self._lock:
            return set(self._owned)

    def acquire(self, shard: int) -> None:
        with self._lock:
            self._owned.add(shard)

    def release(self, shard: int) -> None:
        with self._lock:
            self._owned.discard(shard)

    def owns_shard(self, shard: int) -> bool:
        with self._lock:
            return shard in self._owned

    def owns_node(self, name: str) -> bool:
        with self._lock:
            return shard_of_node(name, self.n_shards) in self._owned

    def owns_job(self, namespace: str, group: str) -> bool:
        with self._lock:
            return home_shard(namespace, group, self.n_shards) in self._owned

    def owns_job_id(self, job_id: str) -> bool:
        with self._lock:
            return home_shard_of_job_id(job_id, self.n_shards) in self._owned
