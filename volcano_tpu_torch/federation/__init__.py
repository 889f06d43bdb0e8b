"""Sharded scheduler federation — scale *across* scheduler processes.

The port of ``volcano_tpu/federation/``, module for module, so a
federation may mix port and JAX members over one store: the same shard
map record, the same hashes, the same CAS transitions.

The reference Volcano runs exactly one vc-scheduler against the API
server; everything else in the package scales the one process (device
kernels, warm packing, the pipelined commit plane, event-driven
micro-cycles).  Federation partitions the cluster itself:
N scheduler processes each own a disjoint **node shard** via bus-backed
shard-assignment leases (the ``serving/leader.py`` CAS-lease machinery
generalized to a shard map object), run the full existing pipeline over
their slice, and handle cross-shard pressure with Omega-style
optimistic CAS binds — conflicts are detected at the store, never
prevented by locks (the shared-state scheduling lineage in PAPERS.md).

Pieces:

* :mod:`sharding` — the deterministic hash assignment (node → shard,
  job → home shard) and the ``ShardState`` ownership set.
* :mod:`leases` — ``ShardLeaseManager``: claim / renew / absorb-on-
  expiry / release-on-join over one CAS-updated ConfigMap.
* :mod:`filter` — ``ShardInformerFilter``: shard-filters informer
  deliveries so cache and pack stay O(nodes/N), with relist-on-acquire
  when ownership moves; keeps an OWNED-slice capacity ledger and
  publishes it as the free-capacity sketch on the lease heartbeat.
* :mod:`sketches` — ``SketchSolicitor``: the per-shard free-capacity
  sketches on the lease map are the ONLY foreign state a member holds
  (no O(cluster) mirror); candidates solicited from them are verified
  against per-node store truth at CAS/txn time, so a stale sketch only
  PRUNES, never overcommits.
* :mod:`spillover` — ``SpilloverController``: home-shard-stuck tasks
  CAS-bind onto sketch-solicited foreign-shard nodes with bounded
  retry on conflict.
* :mod:`broker` — ``GangBroker``: cross-shard gang assembly — a
  home-owned gang below ``minMember`` solicits foreign capacity
  (sketch-gated, O(shards)) and commits a full-gang placement via one
  atomic VBUS v6 ``txn_commit``; conflicts discard the assembly WHOLE
  and retry with bounded backoff, so a partial gang can never exist.
* :mod:`autoscale` — ``ShardAutoscaler``: SLO-driven shard-count
  control — the member holding shard 0's lease windows the fleet's
  submit→bind p99 and pending depth (both piggybacked on the lease
  heartbeats) and CASes a one-step target change into the map, with
  hysteresis, sustain, and cooldown; members adopt the new count
  through the lease manager's elastic mode.
* :mod:`runtime` — ``FederatedScheduler``: one federation member
  (cache + filter + leases + spillover + broker + scheduler), the unit
  ``vtpu-scheduler --shards N`` runs and the tests and ``chip_smoke.py``
  instantiate in-process.
* :mod:`verify` — the multi-shard policy-equivalence checker (each pod
  bound at most once, binds satisfy predicates, no gang partially
  placed below minMember — proven ACROSS shards from API truth).
"""

from volcano_tpu_torch.federation.sharding import (  # noqa: F401
    home_shard,
    shard_of_node,
    ShardState,
)
from volcano_tpu_torch.federation.leases import (  # noqa: F401
    read_shard_map,
    SHARD_MAP_KEY,
    SHARD_MAP_NAME,
    ShardLeaseManager,
)
from volcano_tpu_torch.federation.broker import (  # noqa: F401
    GangBroker,
    solicitable_shards,
)
from volcano_tpu_torch.federation.sketches import SketchSolicitor  # noqa: F401
from volcano_tpu_torch.federation.autoscale import (  # noqa: F401
    AutoscalePolicy,
    ShardAutoscaler,
)
from volcano_tpu_torch.federation.runtime import FederatedScheduler  # noqa: F401
from volcano_tpu_torch.federation.verify import verify_federation  # noqa: F401
