"""OpenSession/CloseSession — session lifecycle.

A copy of ``volcano_tpu/framework/framework.py`` for full sessions: the
port has no restricted (incremental) sessions, so ``open_session``
always takes a full snapshot.  It stamps the snapshot's change-tracking
epoch and clone-pool generation on the session, and ``close_session``
hands the session's untouched clones back to the cache's pool.

Reference: pkg/scheduler/framework/framework.go:30-66.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, List

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.cache.interface import Cache
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.interface import get_plugin_builder
from volcano_tpu_torch.framework.job_updater import JobUpdater
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:  # the policy types import the framework package
    from volcano_tpu_torch.conf import Configuration, Tier

log = get_logger(__name__)


def open_session(
    cache: Cache, tiers: List[Tier], configurations: List[Configuration],
) -> Session:
    """framework.go:30-53 + session.go openSession:72-139."""
    rec = trace.get_recorder()
    open_start = time.perf_counter()
    ssn = Session(cache)
    ssn.tiers = tiers
    ssn.configurations = configurations

    snapshot = cache.snapshot()
    ssn.jobs = snapshot.jobs
    ssn.nodes = snapshot.nodes
    ssn.queues = snapshot.queues
    ssn.namespace_info = snapshot.namespace_info
    ssn.pvcs = snapshot.pvcs
    ssn.pack_epoch = getattr(snapshot, "pack_epoch", None)
    ssn.clone_gen = getattr(snapshot, "clone_gen", 0)

    # Instantiate plugins listed in tiers (framework.go:37-45).
    for tier in tiers:
        for opt in tier.plugins:
            builder = get_plugin_builder(opt.name)
            if builder is None:
                log.error("Failed to get plugin %s", opt.name)
                continue
            plugin = builder(opt.arguments or Arguments())
            ssn.plugins[plugin.name()] = plugin

    # Record incoming PodGroup status, filter invalid jobs at open
    # (session.go:105-129; the reference DeepCopies).  Must be a COPY:
    # Session.job_status mutates job.pod_group.status in place, so a
    # stored reference would alias the "new" status and the updater's
    # is_pod_group_status_updated gate could never fire again once a
    # job carried conditions.  Conditions entries are replaced (not
    # mutated) by update_job_condition, so a shallow list copy is deep
    # enough.
    for job in list(ssn.jobs.values()):
        if job.pod_group is not None:
            st = job.pod_group.status
            ssn.pod_group_phase0[job.uid] = st.phase
            if st.conditions:
                ssn.pod_group_status[job.uid] = scheduling.PodGroupStatus(
                    phase=st.phase,
                    conditions=list(st.conditions),
                    running=st.running,
                    succeeded=st.succeeded,
                    failed=st.failed,
                )

    for plugin in ssn.plugins.values():
        start = time.perf_counter()
        plugin.on_session_open(ssn)
        plugin_s = time.perf_counter() - start
        metrics.update_plugin_duration(plugin.name(), plugin_s)
        if rec.enabled:
            rec.complete(
                f"plugin:{plugin.name()}.open", "plugin", start, plugin_s
            )

    for job in list(ssn.jobs.values()):
        vr = ssn.job_valid(job)
        if vr is not None:
            if not vr.pass_:
                # rejected before any action ran — still one scheduling
                # attempt in the reference's attempts accounting
                metrics.register_schedule_attempt("unschedulable")
                ssn.update_job_condition(
                    job,
                    scheduling.PodGroupCondition(
                        type=scheduling.POD_GROUP_UNSCHEDULABLE_TYPE,
                        status="True",
                        transition_id=ssn.uid,
                        last_transition_time=time.time(),
                        reason=vr.reason,
                        message=vr.message,
                    ),
                )
            del ssn.jobs[job.uid]

    if rec.enabled:
        rec.complete(
            "open_session",
            "framework",
            open_start,
            time.perf_counter() - open_start,
            jobs=len(ssn.jobs),
            nodes=len(ssn.nodes),
            queues=len(ssn.queues),
        )
    log.debug(
        "Open session %s with %d jobs and %d queues",
        ssn.uid,
        len(ssn.jobs),
        len(ssn.queues),
    )
    return ssn


def close_session(ssn: Session) -> None:
    """framework.go:56-66 + session.go closeSession:141-155."""
    rec = trace.get_recorder()
    close_start = time.perf_counter()
    for plugin in ssn.plugins.values():
        start = time.perf_counter()
        plugin.on_session_close(ssn)
        plugin_s = time.perf_counter() - start
        metrics.update_plugin_duration(plugin.name(), plugin_s)
        if rec.enabled:
            rec.complete(
                f"plugin:{plugin.name()}.close", "plugin", start, plugin_s
            )

    JobUpdater(ssn).update_all()

    # hand untouched clones back for reuse by the next snapshot (no-op
    # unless the cache opted into snapshot_reuse) — after plugin closes
    # and the job updater, which are the last clone-mutating steps
    release = getattr(ssn.cache, "release_session_clones", None)
    if release is not None:
        release(ssn.clone_gen, ssn.touched_jobs, ssn.touched_nodes)

    if rec.enabled:
        rec.complete(
            "close_session", "framework", close_start,
            time.perf_counter() - close_start,
        )

    ssn.jobs = {}
    ssn.nodes = {}
    ssn.plugins = {}
    ssn.event_handlers = []
    ssn.job_order_fns = {}
    ssn.namespace_order_fns = {}
    ssn.queue_order_fns = {}
    log.debug("Close session %s", ssn.uid)
