"""Cross-shard spillover — Omega-style optimistic CAS binds.

A copy of ``volcano_tpu/federation/spillover.py``, over the port's
``cas_bind`` (in process, and VBUS v4 over the wire).

A job that keeps failing to place on its home shard is not stuck: its
home scheduler may simply own a full slice while a foreign slice sits
idle.  Locking foreign state is exactly what the shared-state lineage
(PAPERS.md) rejects; instead the home scheduler *optimistically* binds
the pod onto a foreign node and lets the store detect conflicts — the
``cas_bind`` operation succeeds only if the pod is still unbound and
its resourceVersion is unchanged, so two schedulers racing for one pod
(or a deleted pod racing its bind) resolve at the store, never by
coordination.  Conflicts are retried against the next candidate, a
bounded number of times, and every outcome is counted in
``volcano_spillover_binds_total{result}`` so spillover pressure — the
signal that the shard hash is skewed for this workload — is observable
(also published into the shard-map ConfigMap for ``vtctl shards``).

Eligibility is deliberately conservative:

* a task spills only after staying Pending across
  ``spill_after`` consecutive post-cycle observations — the home cycle
  must have had a real chance first (spilling instantly would bypass
  home scheduling entirely);
* **gang semantics stay within home shards**: a task of a
  ``minMember > 1`` group spills only when the gang is already
  satisfied at home (the spill is surplus), never to assemble a gang
  across shards (that is the gang broker's job, federation/broker.py).

One difference from the reference: every cross-shard bind is kept as a
claim on the member's ``SketchSolicitor`` (``account_bound_pod``), which
debits it from the node's sketch entry until the holder's sketch covers
it (federation/sketches.py), so a burst of tasks solicited from one
stale sketch does not overcommit its freest node.

Runs on the scheduler thread via ``Scheduler.post_cycle`` — never
concurrently with a session, so a freshly-spilled pod can't race its
own home placement.
"""

from __future__ import annotations

import threading
from typing import Dict

from volcano_tpu_torch.client.apiserver import ApiError, ConflictError
from volcano_tpu_torch.federation.filter import ShardInformerFilter
from volcano_tpu_torch.federation.sharding import ShardState
from volcano_tpu_torch.federation.sketches import SketchSolicitor, UNREAD
from volcano_tpu_torch import metrics
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


# Both API surfaces a controller can hold implement ``cas_bind`` —
# the in-process APIServer natively, RemoteAPIServer as the VBUS v4 op
# (with its own old-server get+CAS-update fallback).  The check-and-
# bind logic deliberately lives in those two places ONLY; a surface
# without the method fails loudly here rather than getting a third,
# drift-prone copy.


def account_bound_pod(filter_, cache, api, old, bound, message,
                      sketches=None) -> None:
    """Post-bind accounting shared by spillover and the gang broker
    (federation/broker.py): ledger + forward the bound pod immediately
    (the watch echo reconciles later, and the very next home cycle must
    not re-place it), keep a bind onto a foreign node as a claim on
    ``sketches``, then record the audit Event best-effort — ONE copy,
    so a fix to the accounting-vs-echo race cannot drift between the
    two cross-shard bind paths."""
    filter_.note_spill_bind(bound)
    if sketches is not None and not filter_.state.owns_node(
        bound.spec.node_name
    ):
        sketches.note_claim(bound)
    try:
        cache.update_pod(old, bound)
    except Exception as e:  # noqa: BLE001 — accounting races the echo;
        # the informer delivery converges it
        log.debug("cross-shard bind accounting: %s", e)
    try:
        from volcano_tpu_torch.client.clients import record_event_via

        record_event_via(
            api, bound.metadata.namespace,
            {"kind": "Pod", "namespace": bound.metadata.namespace,
             "name": bound.metadata.name},
            "Normal", "Scheduled", message,
        )
    except ApiError:
        pass  # audit events are best-effort, like _record_event


class SpilloverController:
    """Post-cycle spillover pass for one federation member."""

    def __init__(
        self,
        cache,
        state: ShardState,
        filter_: ShardInformerFilter,
        api,
        spill_after: int = 2,
        max_per_cycle: int = 128,
        candidate_retries: int = 3,
        sketches: SketchSolicitor = None,
    ):
        self.cache = cache
        self.state = state
        self.filter = filter_
        self.api = api
        #: foreign-candidate source: the other members' published
        #: capacity sketches (the runtime shares one solicitor with the
        #: gang broker so the verified/stale counters aggregate)
        self.sketches = sketches or SketchSolicitor(api, state)
        self.spill_after = spill_after
        self.max_per_cycle = max_per_cycle
        self.candidate_retries = candidate_retries
        #: pod key → consecutive post-cycle observations still Pending
        #: (scheduler-thread state; run_once is never reentered)
        self._seen: Dict[str, int] = {}
        self._ctr_lock = threading.Lock()
        #: result → count, mirrored into the shard-map stats blob
        self._counters: Dict[str, int] = {}  # guarded-by: self._ctr_lock

    def counters(self) -> Dict[str, int]:
        with self._ctr_lock:
            return dict(self._counters)

    def _count(self, result: str) -> None:
        metrics.register_spillover_bind(result)
        with self._ctr_lock:
            self._counters[result] = self._counters.get(result, 0) + 1

    def run_once(self, view=None) -> int:
        """One spillover pass (Scheduler.post_cycle).  ``view`` is an
        optional pre-taken ``pending_spill_view()`` — the runtime
        shares one O(jobs) scan between this pass and the gang broker
        (their eligibility sets are disjoint: spillover acts only on
        satisfied-or-solo gangs, the broker only below minMember).
        Returns how many pods were successfully spilled."""
        if self.state.n_shards <= 1:
            return 0
        if view is None:
            view = self.cache.pending_spill_view()
        live = set()
        eligible = []
        for entry in view:
            if not self.state.owns_job_id(entry["job_id"]):
                continue  # not ours to spill (mid-rebalance residue)
            gang_ok = (
                entry["min_member"] <= 1
                or entry["ready"] >= entry["min_member"]
            )
            for task in entry["tasks"]:
                key = f"{task.namespace}/{task.name}"
                live.add(key)
                seen = self._seen.get(key, 0) + 1
                self._seen[key] = seen
                if gang_ok and seen > self.spill_after:
                    eligible.append(task)
        # tasks that bound, finished, or left drop their streak
        for key in list(self._seen):
            if key not in live:
                del self._seen[key]
        spilled = 0
        rec = UNREAD
        for task in eligible[: self.max_per_cycle]:
            if rec is UNREAD:
                # one shard-map read per PASS with eligible work, not
                # per task — the sketches only change on lease ticks,
                # and per-node truth is re-verified at bind time anyway
                rec = self.sketches.read_map()
            if self._spill_one(task, rec):
                spilled += 1
                self._seen.pop(f"{task.namespace}/{task.name}", None)
        return spilled

    def _spill_one(self, task, rec=UNREAD) -> bool:
        from volcano_tpu_torch import obs

        if rec is UNREAD:
            rec = self.sketches.read_map()
        if not obs.enabled():
            return self._spill_one_inner(task, rec)
        with obs.span(
            "spillover:cas_bind", cat="federation",
            trace_id=obs.trace_id_for_pod(task.namespace, task.name),
            args={"pod": f"{task.namespace}/{task.name}"},
        ):
            return self._spill_one_inner(task, rec)

    def _spill_one_inner(self, task, rec) -> bool:
        candidates = self.sketches.spill_candidates(
            task, rec, limit=self.candidate_retries
        )
        if not candidates:
            self._count("no-fit")
            return False
        for hostname in candidates:
            # sketch-solicited: check the node's store truth before the
            # CAS — a vanished/cordoned node is the sketch's staleness
            # window showing (a pruning event), try the next candidate
            if not self.sketches.verify_node(hostname):
                continue
            try:
                pre = self.api.get("Pod", task.namespace, task.name)
                if pre is None or pre.spec.node_name:
                    # someone else bound (or deleted) it since the cycle
                    self._count("lost-race")
                    return False
                bound = self.api.cas_bind(
                    task.namespace, task.name, hostname,
                    expected_rv=pre.metadata.resource_version,
                )
            except ConflictError:
                self._count("conflict")
                continue  # optimistic concurrency working as intended
            except ApiError as e:
                log.error("spillover bind of %s/%s to %s failed: %s",
                          task.namespace, task.name, hostname, e)
                self._count("error")
                return False
            self._count("bound")
            log.info("spillover: bound %s/%s to foreign node %s",
                     task.namespace, task.name, hostname)
            account_bound_pod(
                self.filter, self.cache, self.api, pre, bound,
                f"Successfully assigned {task.namespace}/{task.name}"
                f" to {hostname} (cross-shard spillover)",
                sketches=self.sketches,
            )
            return True
        # every candidate CAS-conflicted — bounded retry exhausted; the
        # next post-cycle pass tries again with fresh truth
        self._count("exhausted")
        return False
