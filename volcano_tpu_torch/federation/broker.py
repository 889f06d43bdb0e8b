"""Cross-shard gang assembly — the federation gang broker.

A copy of ``volcano_tpu/federation/broker.py``, over the port's
``txn_commit`` (in process, and VBUS v6 over the wire).

Without the broker the federation refuses the hardest gang case: a
``minMember > 1`` PodGroup whose home shard cannot fit the minimum
stays Pending even when the cluster as a whole has room.  The refusal
exists because
assembling a gang across shards needs an all-or-nothing multi-pod
write — a partially-assembled cross-shard gang is exactly the state
gang scheduling exists to forbid.  VBUS v6's ``txn_commit`` is that
write: N conditional binds checked and applied atomically under one
store lock hold, logged as ONE WAL record and replicated as a unit.

The broker runs on the home scheduler's post-cycle seam (after the
spillover pass — never concurrently with a session):

1. **Observe**: a home-owned gang still below ``minMember`` after
   ``assemble_after`` consecutive post-cycle observations is a
   candidate — the home gang loop must have had a real chance first.
2. **Solicit**: foreign shards are considered only when the
   free-capacity *sketch* their holder piggybacks on the lease-map
   heartbeat could plausibly host a claim (``solicitable_shards``) —
   solicitation is O(shards), not O(cluster) — and the candidate
   nodes themselves are materialized from the surviving sketches'
   ``topNodes`` entries (``SketchSolicitor.foreign_entries``), the
   ONLY foreign state a member holds (federation/sketches.py).
3. **Assemble**: ``ShardInformerFilter.plan_gang_assembly`` builds a
   full-gang placement — home nodes fill first (from the owned-slice
   ledger), sketch-solicited foreign claims fill the remainder,
   honoring selectors/taints via the same predicate helpers the
   spillover candidates use, with claims debited inside the plan so
   the assembly cannot overcommit a node against itself.
4. **Commit**: foreign nodes are checked against per-node store truth
   (a stale sketch PRUNES, never decides), every claim is re-verified
   against store truth (fresh resourceVersions) and the whole
   assembly ships as one
   ``txn_commit``.  On conflict the per-item results say which claim
   went stale; the assembly is discarded WHOLE — the host gang loop's
   discard-until-stable cascade semantics, transaction-sized — and
   retried with bounded exponential backoff against fresh truth.

Outcomes land in ``volcano_gang_assemblies_total{result}``
(committed | conflict | aborted | infeasible) and the shard map's
stats blob (``vtctl shards`` renders them); the transaction round
trip lands in ``volcano_txn_commit_latency_milliseconds``.

Degraded modes stay honest: ``--gang-broker off`` disables the broker
outright, and a pre-v6 bus (the old-peer ``txn_commit`` fallback is an
ABORT, never a per-object replay) parks it permanently — both leave
the refusal behavior, pinned by the ``test_gang_broker_off`` /
old-peer tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set

from volcano_tpu_torch.client.apiserver import ApiError
from volcano_tpu_torch.federation.filter import ShardInformerFilter
from volcano_tpu_torch.federation.sharding import ShardState
from volcano_tpu_torch.federation.sketches import SketchSolicitor, UNREAD
from volcano_tpu_torch import metrics
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: conflict backoff ceiling, in post-cycle passes skipped
_MAX_BACKOFF = 8


def solicitable_shards(
    rec: Optional[dict],
    n_shards: int,
    want_cpu: float,
    want_mem: float,
    own_shards: Set[int],
) -> Set[int]:
    """Foreign shards whose holder's free-capacity sketch could
    plausibly host at least the smallest claim of the gang — the
    O(shards) solicitation filter.  ``want_cpu``/``want_mem`` are
    COMPONENT-WISE minima across the gang's tasks (milli-cpu / bytes):
    keying on any single task's full resreq could prune the only shard
    able to host a high-cpu/low-memory member of a heterogeneous gang.
    A shard with no holder, or whose holder published no sketch (an
    older member), is included: the plan's per-node checks still gate
    it, so the sketch only ever PRUNES work, never correctness."""
    out: Set[int] = set()
    shards = (rec or {}).get("shards", {})
    stats = (rec or {}).get("stats", {})
    for shard in range(n_shards):
        if shard in own_shards:
            continue
        holder = (shards.get(str(shard)) or {}).get("holder") or ""
        sketch = (stats.get(holder) or {}).get("sketch") if holder else None
        if sketch is None:
            out.add(shard)  # no signal — solicit; per-node checks gate
            continue
        if (
            sketch.get("freeSlots", 0) > 0
            and sketch.get("maxFreeCpuMilli", 0) >= want_cpu
            and sketch.get("maxFreeMemory", 0) >= want_mem
        ):
            out.add(shard)
    return out


class GangBroker:
    """Post-cycle cross-shard gang assembly for one federation member.

    ``kill_hook`` is the ``gang.kill_mid_assembly`` fault-point sink —
    the SIGKILL-mid-assembly chaos drill fires it between building an
    assembly and committing it, the widest window in which a partial
    gang could exist if the transaction were not atomic."""

    def __init__(
        self,
        cache,
        state: ShardState,
        filter_: ShardInformerFilter,
        api,
        assemble_after: int = 2,
        max_gangs_per_cycle: int = 8,
        kill_hook: Optional[Callable[[], None]] = None,
        sketches: SketchSolicitor = None,
    ):
        self.cache = cache
        self.state = state
        self.filter = filter_
        self.api = api
        #: foreign-candidate source: the other members' published
        #: capacity sketches (the runtime shares one solicitor with the
        #: spillover controller so the verified/stale counters aggregate)
        self.sketches = sketches or SketchSolicitor(api, state)
        self.assemble_after = assemble_after
        self.max_gangs_per_cycle = max_gangs_per_cycle
        self.kill_hook = kill_hook
        # thread confinement (the guarded-by discipline): everything
        # below except _counters is touched ONLY by the scheduler
        # thread's post_cycle pass (never reentered), so it carries no
        # `# guarded-by:` — declaring a lock it doesn't take would lie
        # to both the lexical pass and the runtime race detector.  The
        # one cross-thread reader is counters(), served under _ctr_lock.
        #: permanently parked: the bus reported txn_commit unsupported
        #: (pre-v6 peer) — the honest refusal mode (scheduler-thread
        #: state; post_cycle is never reentered)
        self.disabled = False
        #: the kill hook fired (crash-mode chaos): this member is dead —
        #: it must not plan or commit ANYTHING further, including other
        #: gangs later in the same run_once pass
        self._halted = False
        #: job_id → consecutive below-minMember post-cycle observations
        self._streak: Dict[str, int] = {}
        #: job_id → passes to skip before the next attempt (conflict
        #: backoff), and the attempt count behind the exponent
        self._backoff: Dict[str, int] = {}
        self._attempts: Dict[str, int] = {}
        self._ctr_lock = threading.Lock()
        #: result → count, mirrored into the shard-map stats blob
        self._counters: Dict[str, int] = {}  # guarded-by: self._ctr_lock

    def counters(self) -> Dict[str, int]:
        with self._ctr_lock:
            return dict(self._counters)

    def _count(self, result: str) -> None:
        metrics.register_gang_assembly(result)
        with self._ctr_lock:
            self._counters[result] = self._counters.get(result, 0) + 1

    # ---- one post-cycle pass ----

    def run_once(self, view=None) -> int:
        """One assembly pass (Scheduler.post_cycle, after spillover).
        ``view`` is an optional pre-taken ``pending_spill_view()`` —
        the runtime shares one O(jobs) scan between spillover and the
        broker.  Returns how many gangs were committed."""
        if self.disabled or self._halted or self.state.n_shards <= 1:
            return 0
        if view is None:
            view = self.cache.pending_spill_view()
        live = set()
        committed = 0
        budget = self.max_gangs_per_cycle
        rec = UNREAD
        for entry in view:
            if self._halted:
                # the kill hook fired mid-pass (crash mode): a SIGKILLed
                # member issues nothing further — not even other gangs
                return committed
            mm = entry["min_member"]
            if mm <= 1 or entry["ready"] >= mm:
                continue  # not a gang, or satisfied (spillover's case)
            if not self.state.owns_job_id(entry["job_id"]):
                continue  # not ours to broker (mid-rebalance residue)
            jid = entry["job_id"]
            live.add(jid)
            streak = self._streak.get(jid, 0) + 1
            self._streak[jid] = streak
            if streak <= self.assemble_after or budget <= 0:
                continue  # home cycles get a real chance first
            skip = self._backoff.get(jid, 0)
            if skip > 0:
                self._backoff[jid] = skip - 1
                continue
            if rec is UNREAD:
                # one shard-map read per PASS, not per gang — the map
                # only changes on lease ticks, and each gang's claims
                # are re-verified against store truth anyway.  None
                # means no foreign state: home-only plans this pass.
                rec = self.sketches.read_map()
            budget -= 1
            if self._assemble_one(entry, rec):
                committed += 1
                self._drop(jid)
        # gangs that completed, bound, or left drop their state
        for jid in list(self._streak):
            if jid not in live:
                self._drop(jid)
        return committed

    def _drop(self, jid: str) -> None:
        self._streak.pop(jid, None)
        self._backoff.pop(jid, None)
        self._attempts.pop(jid, None)

    def _defer(self, jid: str) -> None:
        """Bounded exponential backoff: the next attempt waits out
        2^attempts post-cycle passes (capped), so a hot conflict loop
        cannot hammer the store while foreign state churns."""
        n = self._attempts.get(jid, 0) + 1
        self._attempts[jid] = n
        self._backoff[jid] = min(2 ** n, _MAX_BACKOFF)

    # ---- assembly ----

    def _assemble_one(self, entry: dict, rec: Optional[dict]) -> bool:
        from volcano_tpu_torch import obs

        if not obs.enabled():
            # recorder off: skip the member-annotation scan entirely
            return self._assemble_one_inner(entry, rec)
        gang = self._gang_ident(entry)
        with obs.span(
            "gang:assemble", cat="federation",
            trace_id=(obs.trace_id_for_gang(*gang) if gang else None),
            args={"gang": f"{gang[0]}/{gang[1]}"} if gang else None,
        ):
            return self._assemble_one_inner(entry, rec)

    @staticmethod
    def _gang_ident(entry: dict):
        """(namespace, podgroup-name) for the flight-recorder trace id,
        from the members' group annotation — the same identity ``vtctl
        trace gang`` derives its trace id from."""
        from volcano_tpu_torch.apis import scheduling as _sched

        for task in entry.get("tasks", ()):
            pod = getattr(task, "pod", None)
            if pod is None:
                continue
            name = pod.metadata.annotations.get(
                _sched.GROUP_NAME_ANNOTATION_KEY, ""
            )
            if name:
                return (task.namespace, name)
        return None

    def _assemble_one_inner(self, entry: dict, rec: Optional[dict]) -> bool:
        from volcano_tpu_torch import faults, obs

        jid = entry["job_id"]
        mm = entry["min_member"]
        need = mm - entry["ready"]
        tasks = entry["tasks"]
        if len(tasks) < need:
            # not every member exists yet — nothing to assemble; defer
            # like any other infeasible outcome (a stuck gang must not
            # burn the pass budget every cycle and starve assembleable
            # peers) — the streak keeps counting so arrival completes
            # the picture
            self._count("infeasible")
            self._defer(jid)
            return False
        foreign: List[list] = []
        if rec is not None:
            with obs.span("gang:solicit", cat="federation"):
                ok = solicitable_shards(
                    rec, self.state.n_shards,
                    min(t.resreq.get("cpu") for t in tasks),
                    min(t.resreq.get("memory") for t in tasks),
                    self.state.owned(),
                )
                # materialize candidates only for shards whose aggregate
                # sketch could plausibly host a claim — the per-node
                # topNodes entries of everything else stay unread
                foreign = self.sketches.foreign_entries(
                    rec, shard_ok=ok.__contains__
                )
        with obs.span("gang:plan", cat="federation"):
            plan = self.filter.plan_gang_assembly(
                tasks, foreign_entries=foreign
            )
        if len(plan) < need:
            # the cluster (as this ledger sees it) cannot host the
            # minimum — the honest Pending outcome, counted so operator
            # dashboards distinguish "no room anywhere" from conflicts
            self._count("infeasible")
            self._defer(jid)
            return False
        fp = faults.get_plane()
        if fp.enabled and fp.should("gang.kill_mid_assembly"):
            # the chaos drill: die between assembling and committing —
            # the orphaned assembly must be discarded whole (no bind
            # ever issued) or committed whole, never partial.  Halt
            # BEFORE the hook: in crash mode the hook returns, and a
            # dead member must not go on assembling other gangs.
            log.error("gang.kill_mid_assembly fired: dying mid-assembly")
            self._halted = True
            if self.kill_hook is not None:
                self.kill_hook()
            return False
        # sketch-solicited foreign nodes: check store truth before the
        # transaction — a vanished/cordoned node is the sketch's
        # staleness window showing (a pruning event); discard the
        # assembly whole and retry against fresh truth
        for host in {h for _t, h in plan if not self.state.owns_node(h)}:
            if not self.sketches.verify_node(host):
                self._count("conflict")
                self._defer(jid)
                return False
        # re-verify every claim against store truth and stamp the
        # resourceVersions the transaction will insist on
        binds: List[dict] = []
        fresh: List[object] = []
        for task, hostname in plan:
            try:
                pre = self.api.get("Pod", task.namespace, task.name)
            except ApiError as e:
                log.error("gang assembly read-back of %s/%s failed: %s",
                          task.namespace, task.name, e)
                self._count("aborted")
                self._defer(jid)
                return False
            if pre is None or pre.spec.node_name:
                # a member vanished or bound since the cycle — the
                # whole assembly is stale; discard it, never ship part
                self._count("conflict")
                self._defer(jid)
                return False
            binds.append({
                "namespace": task.namespace, "name": task.name,
                "hostname": hostname,
                "expected_rv": pre.metadata.resource_version,
            })
            fresh.append(pre)
        t0 = time.perf_counter()
        try:
            with obs.span("gang:txn_commit", cat="federation",
                          args={"binds": len(binds)}):
                result = self.api.txn_commit(binds)
        except ApiError as e:
            log.error("gang txn_commit for %s failed: %s", jid, e)
            self._count("aborted")
            self._defer(jid)
            return False
        metrics.observe_txn_commit(time.perf_counter() - t0)
        if not result.get("committed"):
            if result.get("reason") == "unsupported":
                # pre-v6 bus: park permanently — the honest refusal
                # mode (no per-object replay can be atomic)
                log.warning(
                    "bus does not support txn_commit; cross-shard gang "
                    "assembly disabled (pre-v6 refusal mode)"
                )
                self.disabled = True
                self._count("aborted")
                return False
            stale = [
                binds[i]["name"]
                for i, err in enumerate(result.get("results", []))
                if err
            ]
            log.info("gang assembly for %s conflicted on %s; discarded "
                     "whole, will retry", jid, stale)
            self._count("conflict")
            self._defer(jid)
            return False
        self._count("committed")
        log.info("gang assembly: committed %d binds for %s (%d home + %d "
                 "foreign)", len(binds), jid,
                 sum(1 for _t, h in plan if self.state.owns_node(h)),
                 sum(1 for _t, h in plan if not self.state.owns_node(h)))
        self._account(plan, fresh, result.get("objects", ()))
        return True

    def _account(self, plan, fresh, objects) -> None:
        """Account the committed binds through the accounting path the
        spillover binds share (spillover.account_bound_pod) — one copy,
        so the two cross-shard bind paths cannot drift.  ``fresh`` is
        the read-back pod per claim (the exact pre-bind store state the
        transaction verified), passed as the accounting ``old`` like
        the spillover path does — the cycle-time ``task.pod`` snapshot
        can lag the store."""
        from volcano_tpu_torch.federation.spillover import account_bound_pod

        by_key = {
            f"{o.metadata.namespace}/{o.metadata.name}": o for o in objects
        }
        for (task, hostname), pre in zip(plan, fresh):
            bound = by_key.get(f"{task.namespace}/{task.name}")
            if bound is None:
                continue
            account_bound_pod(
                self.filter, self.cache, self.api, pre, bound,
                f"Successfully assigned {task.namespace}/{task.name} "
                f"to {hostname} (cross-shard gang assembly)",
                sketches=self.sketches,
            )
