"""vtctl — the control CLI of the port.

The port of ``volcano_tpu/cli/vtctl.py``, for the commands whose callers
the port has:

  vtctl job run|list|view|suspend|resume|delete
  vtctl queue create|get|list|operate|delete
  vtctl describe job|podgroup   (conditions + Events + the
                                 unschedulable-reason histogram)
  vtctl trace pod|gang    the flight recorder's cross-process submit→bind
                          waterfall of one pod or gang (``--chrome`` also
                          writes the merged multi-process Chrome JSON)
  vtctl trace record|replay|diff|export
                          the cycle journal (``cmd/trace.py``'s commands)
  vtctl top               /metrics aggregated across the membership
  vtctl incidents list|show|collect|capture
                          the incident bundles the SLO watchdog (or an
                          operator) captures
  vtctl faults validate   parse a fault schedule and print it normalized
  vtctl shards            the federation's live shard map: lease holders,
                          member heartbeats, spillover, gang-assembly and
                          sketch counters
  vtctl bus status|add-replica|remove-replica
                          the durable, replicated store: role, leader,
                          term, WAL and snapshot, follower lag; dynamic
                          membership of the replication group
  vtctl lint              the port's static-analysis suite
                          (``python -m volcano_tpu_torch.analysis``)

Commands run against an API server: an empty in-process one by default
(tests pass theirs to :func:`main`), or a ``vtpu-apiserver`` of the port
or of the JAX package with ``--bus tcp://host:port``.  The text of each
command is the JAX ``vtctl``'s for the same store.

suspend/resume emit Command CRs consumed by the job controller
(pkg/cli/job/suspend.go, resume.go).

Usage: python -m volcano_tpu_torch.cli.vtctl [--bus URL] job run -N NAME
       python -m volcano_tpu_torch.cli.vtctl [--bus URL] trace pod -N NAME

Not present in the port yet: ``explore`` (the interleaving explorer,
whose lease machine drives federation's leases).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from volcano_tpu_torch import obs
from volcano_tpu_torch.apis import batch, bus, core, scheduling
from volcano_tpu_torch.client import ApiError, APIServer, VolcanoClient
from volcano_tpu_torch.cmd import trace as trace_cmd
from volcano_tpu_torch.metrics import scrape as _scrape
from volcano_tpu_torch.federation.leases import read_shard_map


def _parse_resource_list(text: str) -> Dict[str, str]:
    """"cpu=1000m,memory=100Mi" → dict (cli/util.go populateResourceListV1)."""
    out: Dict[str, str] = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"invalid resource {part!r}, expected name=quantity")
        name, quantity = part.split("=", 1)
        out[name.strip()] = quantity.strip()
    return out


def _construct_job(args) -> batch.Job:
    """pkg/cli/job/util.go constructLaunchJobFlagsJob."""
    requests = _parse_resource_list(args.requests)
    limits = _parse_resource_list(args.limits)
    task = batch.TaskSpec(
        name=args.taskname,
        replicas=args.replicas,
        template=core.PodTemplateSpec(
            metadata=core.ObjectMeta(name=args.name),
            spec=core.PodSpec(
                containers=[
                    core.Container(
                        name=args.name,
                        image=args.image,
                        resources={"requests": requests, "limits": limits},
                    )
                ]
            ),
        ),
    )
    return batch.Job(
        metadata=core.ObjectMeta(name=args.name, namespace=args.namespace),
        spec=batch.JobSpec(
            min_available=args.min_available,
            queue=args.queue,
            scheduler_name=args.scheduler,
            tasks=[task],
        ),
    )


def _load_job_file(path: str) -> batch.Job:
    import yaml

    if not (path.endswith(".yaml") or path.endswith(".yml")):
        raise ValueError("only support yaml file")
    with open(path) as f:
        data = yaml.safe_load(f)
    return batch.Job.from_dict(data)


def _issue_command(vc: VolcanoClient, namespace: str, job_name: str, action: str) -> None:
    """suspend/resume create a Command CR targeted at the job."""
    vc.create_command(
        bus.Command(
            metadata=core.ObjectMeta(
                name=f"{job_name}-{action.lower()}-{int(time.time() * 1000)}",
                namespace=namespace,
            ),
            action=action,
            target_object=core.OwnerReference(kind="Job", name=job_name),
        )
    )


# ---- job subcommands ----

def _job_run(vc: VolcanoClient, args, out) -> int:
    if not args.name and not args.filename:
        print("job name cannot be left blank", file=out)
        return 1
    job = _load_job_file(args.filename) if args.filename else _construct_job(args)
    if args.filename and args.namespace != "default":
        job.metadata.namespace = args.namespace
    created = vc.create_job(job)
    print(f"run job {created.metadata.name} successfully", file=out)
    return 0


def _job_list(vc: VolcanoClient, args, out) -> int:
    jobs = vc.list_jobs(args.namespace if args.namespace != "" else None)
    print(
        f"{'Name':<25}{'Creation':<21}{'Phase':<12}{'Replicas':<10}"
        f"{'Min':<6}{'Pending':<9}{'Running':<9}{'Succeeded':<11}{'Failed':<8}",
        file=out,
    )
    for job in jobs:
        replicas = sum(t.replicas for t in job.spec.tasks)
        created = time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime(job.metadata.creation_timestamp)
        )
        s = job.status
        print(
            f"{job.metadata.name:<25}{created:<21}{s.state.phase:<12}{replicas:<10}"
            f"{s.min_available:<6}{s.pending:<9}{s.running:<9}{s.succeeded:<11}{s.failed:<8}",
            file=out,
        )
    return 0


def _job_view(vc: VolcanoClient, args, out) -> int:
    job = vc.get_job(args.namespace, args.name)
    if job is None:
        print(f"job {args.namespace}/{args.name} not found", file=out)
        return 1
    import yaml

    print(yaml.safe_dump(job.to_dict(), sort_keys=False), file=out)

    # Events section (kubectl-describe style): the audit trail for the
    # job's pods and its podgroup (cache.go:600-610, 832-867 recorders).
    # Pod names follow <job>-<task>-<idx> — match exactly that shape per
    # task spec (a bare "<job>-" prefix would also swallow events of a
    # sibling job named "<job>-something").
    import re

    jn = re.escape(job.metadata.name)
    patterns = [
        re.compile(rf"^{jn}-{re.escape(t.name)}-\d+$") for t in job.spec.tasks
    ]
    def _belongs(name: str) -> bool:
        return name == job.metadata.name or any(p.match(name) for p in patterns)

    events = _collect_events(vc, args.namespace, _belongs)
    if events:
        _print_events(events, out)
    return 0


def _job_suspend(vc: VolcanoClient, args, out) -> int:
    _issue_command(vc, args.namespace, args.name, batch.ABORT_JOB_ACTION)
    print(f"suspend job {args.name} successfully", file=out)
    return 0


def _job_resume(vc: VolcanoClient, args, out) -> int:
    _issue_command(vc, args.namespace, args.name, batch.RESUME_JOB_ACTION)
    print(f"resume job {args.name} successfully", file=out)
    return 0


def _job_delete(vc: VolcanoClient, args, out) -> int:
    vc.delete_job(args.namespace, args.name)
    print(f"delete job {args.name} successfully", file=out)
    return 0


# ---- queue subcommands ----

def _queue_create(vc: VolcanoClient, args, out) -> int:
    vc.create_queue(
        scheduling.Queue(
            metadata=core.ObjectMeta(name=args.name, namespace=""),
            spec=scheduling.QueueSpec(weight=args.weight),
        )
    )
    print(f"create queue {args.name} successfully", file=out)
    return 0


def _queue_get(vc: VolcanoClient, args, out) -> int:
    queue = vc.get_queue(args.name)
    if queue is None:
        print(f"queue {args.name} not found", file=out)
        return 1
    print(f"{'Name':<25}{'Weight':<8}{'State':<10}{'Inqueue':<9}{'Pending':<9}{'Running':<9}", file=out)
    s = queue.status
    print(
        f"{queue.metadata.name:<25}{queue.spec.weight:<8}{s.state or queue.spec.state:<10}"
        f"{s.inqueue:<9}{s.pending:<9}{s.running:<9}",
        file=out,
    )
    return 0


def _queue_list(vc: VolcanoClient, args, out) -> int:
    print(f"{'Name':<25}{'Weight':<8}{'State':<10}{'Inqueue':<9}{'Pending':<9}{'Running':<9}", file=out)
    for queue in vc.list_queues():
        s = queue.status
        print(
            f"{queue.metadata.name:<25}{queue.spec.weight:<8}{s.state or queue.spec.state:<10}"
            f"{s.inqueue:<9}{s.pending:<9}{s.running:<9}",
            file=out,
        )
    return 0


def _queue_operate(vc: VolcanoClient, args, out) -> int:
    """pkg/cli/queue/operate.go — open/close via Command CR, update weight
    directly."""
    if args.action in ("open", "close"):
        action = "OpenQueue" if args.action == "open" else "CloseQueue"
        vc.create_command(
            bus.Command(
                metadata=core.ObjectMeta(
                    name=f"{args.name}-{args.action}-{int(time.time() * 1000)}", namespace=""
                ),
                action=action,
                target_object=core.OwnerReference(kind="Queue", name=args.name),
            )
        )
    elif args.action == "update":
        if args.weight is None:
            print("update action requires --weight", file=out)
            return 1
        queue = vc.get_queue(args.name)
        if queue is None:
            print(f"queue {args.name} not found", file=out)
            return 1
        queue.spec.weight = args.weight
        vc.update_queue(queue)
    else:
        print(f"invalid action {args.action}", file=out)
        return 1
    print(f"operate queue {args.name} successfully", file=out)
    return 0


def _queue_delete(vc: VolcanoClient, args, out) -> int:
    vc.delete_queue(args.name)
    print(f"delete queue {args.name} successfully", file=out)
    return 0


# ---- describe subcommands (the "why is my job pending" surface) ----

def _collect_events(vc: VolcanoClient, namespace: str, belongs) -> list:
    return sorted(
        (
            e
            for e in vc.api.list("Event", namespace)
            if belongs(e.involved_object.get("name", ""))
        ),
        key=lambda e: e.metadata.resource_version,
    )


def _print_events(events, out) -> None:
    if not events:
        print("Events:             <none>", file=out)
        return
    print("Events:", file=out)
    print(
        f"  {'Type':<8} {'Count':<6} {'Reason':<18} {'Object':<32} Message",
        file=out,
    )
    for e in events:
        obj = f"{e.involved_object.get('kind', '')}/{e.involved_object.get('name', '')}"
        print(
            f"  {e.type:<8} {e.count:<6} {e.reason:<18} {obj:<32} {e.message}",
            file=out,
        )


def _describe_scheduling(vc: VolcanoClient, namespace: str, name: str,
                         pg, belongs, out) -> None:
    """The shared body of ``describe job`` / ``describe podgroup``:
    PodGroup conditions, the unschedulable-reason histogram aggregated
    out of recorded Warning/Unschedulable Events, and the raw Events
    table.  An aggregated Event's message is the LATEST occurrence's
    detail (the correlator refreshes it), so each event contributes its
    current per-reason node counts once — NOT multiplied by the
    historical repeat count, which would inflate the current cause by
    however long the task was stuck on a previous one.  Reads only the
    API surface, so it renders identically over the in-process backend
    and ``--bus``."""
    from volcano_tpu_torch.api.unschedule_info import parse_fit_errors

    if pg is not None:
        s = pg.status
        print(f"Phase:              {s.phase}", file=out)
        print(f"Min Member:         {pg.spec.min_member}", file=out)
        print(f"Queue:              {pg.spec.queue}", file=out)
        if s.conditions:
            print("Conditions:", file=out)
            print(f"  {'Type':<16} {'Status':<8} {'Reason':<22} Message", file=out)
            for c in s.conditions:
                print(
                    f"  {c.type:<16} {c.status:<8} {c.reason:<22} {c.message}",
                    file=out,
                )
        else:
            print("Conditions:         <none>", file=out)
    else:
        print("PodGroup:           <none>", file=out)

    events = _collect_events(vc, namespace, belongs)
    histogram: Dict[str, int] = {}
    for e in events:
        if e.type != "Warning" or e.reason != "Unschedulable":
            continue
        parsed = parse_fit_errors(e.message)
        if parsed is None:
            continue
        for reason, count in parsed[1].items():
            histogram[reason] = histogram.get(reason, 0) + count
    if histogram:
        print("Unschedulable Reasons:", file=out)
        print(f"  {'Nodes':<7} Reason", file=out)
        for reason, count in sorted(histogram.items(), key=lambda kv: -kv[1]):
            print(f"  {count:<7} {reason}", file=out)
    _print_events(events, out)


def _describe_job(vc: VolcanoClient, args, out) -> int:
    job = vc.get_job(args.namespace, args.name)
    if job is None:
        print(f"job {args.namespace}/{args.name} not found", file=out)
        return 1
    print(f"Name:               {job.metadata.name}", file=out)
    print(f"Namespace:          {job.metadata.namespace}", file=out)
    print(f"Scheduler:          {job.spec.scheduler_name}", file=out)
    s = job.status
    print(
        f"Status:             pending={s.pending} running={s.running} "
        f"succeeded={s.succeeded} failed={s.failed}",
        file=out,
    )

    # pod names follow <job>-<task>-<idx> (the _job_view matcher)
    import re

    jn = re.escape(job.metadata.name)
    patterns = [
        re.compile(rf"^{jn}-{re.escape(t.name)}-\d+$") for t in job.spec.tasks
    ]

    def belongs(name: str) -> bool:
        return name == job.metadata.name or any(p.match(name) for p in patterns)

    # the job controller names the PodGroup after the job (actions.go:423)
    pg = vc.get_pod_group(args.namespace, args.name)
    _describe_scheduling(vc, args.namespace, args.name, pg, belongs, out)
    return 0


def _describe_podgroup(vc: VolcanoClient, args, out) -> int:
    pg = vc.get_pod_group(args.namespace, args.name)
    if pg is None:
        # the group may live on the bus as a raw v1alpha1 kind
        from volcano_tpu_torch.apis import scheme as _scheme

        raw = vc.api.get("PodGroupV1alpha1", args.namespace, args.name)
        if raw is not None:
            pg = _scheme.pod_group_v1alpha1_to_hub(raw)
    if pg is None:
        print(f"podgroup {args.namespace}/{args.name} not found", file=out)
        return 1
    print(f"Name:               {pg.metadata.name}", file=out)
    print(f"Namespace:          {pg.metadata.namespace}", file=out)

    prefix = f"{pg.metadata.name}-"

    def belongs(name: str) -> bool:
        return name == pg.metadata.name or name.startswith(prefix)

    _describe_scheduling(vc, args.namespace, args.name, pg, belongs, out)
    return 0


# ---- shards (the federation observability surface) ----

def _shards(vc: VolcanoClient, args, out) -> int:
    """Render the live shard map: per-shard lease holders, the member
    heartbeats, and each member's published stats (nodes owned,
    spillover counters, rebalances, capacity-sketch freshness and the
    sketch-vs-truth verification split).  Reads ONLY the shard-map
    ConfigMap through the API surface — sketch age is computed against
    the newest renew tick ON the map, never a call-time clock — so the
    output is byte-identical over the in-process backend and ``--bus``
    for the same store state."""
    rec = read_shard_map(vc.api)
    if rec is None:
        print("no shard map — the federation has not run "
              "(start schedulers with --shards N)", file=out)
        return 1
    n = int(rec.get("nShards", 0))
    print(f"Shards:             {n}", file=out)
    scale = rec.get("autoscale")
    if scale:
        # the autoscaler's last committed decision — stored fields
        # only, so the line stays byte-identical across backends
        print(
            f"Autoscale:          target {scale.get('target', n)} "
            f"({scale.get('direction', '?')}: "
            f"{scale.get('reason', '')}; "
            f"decisions {scale.get('decisions', 0)})",
            file=out,
        )
    print(f"  {'SHARD':<7}{'HOLDER':<22}{'LEASE':<8}{'RENEWED':<20}", file=out)
    for i in range(n):
        entry = rec.get("shards", {}).get(str(i), {})
        holder = entry.get("holder") or "<unheld>"
        lease = entry.get("leaseDurationSeconds", 0)
        renewed = entry.get("renewTime", 0)
        print(f"  {i:<7}{holder:<22}{lease:<8g}{renewed:<20}", file=out)
    members = rec.get("members", {})
    print("Members:", file=out)
    if not members:
        print("  <none>", file=out)
    for ident in sorted(members):
        m = members[ident]
        print(
            f"  {ident:<22}heartbeat {m.get('heartbeat', 0)}  "
            f"lease {m.get('leaseDurationSeconds', 0):g}s",
            file=out,
        )
    stats = rec.get("stats", {})
    if stats:
        print("Stats:", file=out)
        for ident in sorted(stats):
            s = stats[ident]
            spill = s.get("spillover", {})
            spill_txt = " ".join(
                f"{k}={spill[k]}" for k in sorted(spill)
            ) or "<none>"
            print(
                f"  {ident:<22}nodes={s.get('nodesOwned', 0)} "
                f"rebalances={s.get('rebalances', 0)} "
                f"spillover: {spill_txt}",
                file=out,
            )
            # cross-shard gang assembly (federation/broker.py) — only
            # members running the broker publish the blob, so the line
            # is absent (not zeroed) for --gang-broker off members
            gang = s.get("gangAssembly")
            if gang is not None:
                gang_txt = " ".join(
                    f"{k}={gang[k]}" for k in sorted(gang)
                ) or "<none>"
                print(f"  {'':<22}gang-assembly: {gang_txt}", file=out)
            # the free-capacity sketch rides the lease heartbeat, so
            # its age is the member's heartbeat measured against the
            # NEWEST renew tick on the map (stored fields only — a
            # call-time clock would break cross-backend byte-identity);
            # a sketch older than the member's lease TTL is the signal
            # foreign solicitation is flying blind on this member
            sketch = s.get("sketch")
            if sketch is not None:
                latest = max(
                    [e.get("renewTime", 0)
                     for e in rec.get("shards", {}).values()]
                    + [m.get("heartbeat", 0) for m in members.values()]
                    + [0]
                )
                m = members.get(ident, {})
                hb = m.get("heartbeat", 0)
                ttl = m.get("leaseDurationSeconds", 0)
                age = max(0.0, float(latest) - float(hb))
                fresh = "fresh" if age <= ttl else "STALE"
                print(
                    f"  {'':<22}sketch: slots={sketch.get('freeSlots', 0)} "
                    f"topNodes={len(sketch.get('topNodes') or ())} "
                    f"age={age:g}s/ttl={ttl:g}s ({fresh})",
                    file=out,
                )
            # sketch-vs-truth: how often a sketch-solicited candidate
            # survived (verified) or failed (stale) the bind-time
            # per-node truth check — the observable cost of trading
            # the O(cluster) mirror for O(shards·K) sketches
            checks = s.get("sketchChecks")
            if checks is not None:
                checks_txt = " ".join(
                    f"{k}={checks[k]}" for k in sorted(checks)
                ) or "<none>"
                print(f"  {'':<22}sketch-checks: {checks_txt}", file=out)
    return 0


# ---- bus (the replicated persistent bus observability surface) ----

def _bus_status(vc: VolcanoClient, args, out) -> int:
    """Render the bus durability/replication status: role, leader
    identity, term/epoch, applied + committed sequence, WAL/snapshot
    sizes and fsync stats, and per-follower replication lag (entries +
    ms).  Reads ONLY the ``bus_status`` payload (stored/derived state,
    no call-time clocks), so the output is byte-identical over the
    in-process backend and ``--bus`` for the same store state — the
    ``vtctl shards`` discipline."""
    api = vc.api
    st = api.bus_status() if hasattr(api, "bus_status") else {
        "role": "standalone", "persistent": False,
    }
    print(f"Role:               {st.get('role', 'unknown')}", file=out)
    if st.get("identity"):
        print(f"Identity:           {st['identity']} "
              f"(index {st.get('index', '?')} of "
              f"{st.get('replicas', '?')})", file=out)
    if "leader" in st:
        print(f"Leader:             {st.get('leader') or '<none elected>'}",
              file=out)
    print(f"Persistent:         {str(bool(st.get('persistent'))).lower()}",
          file=out)
    if not st.get("persistent"):
        return 0
    print(f"Epoch:              {st.get('epoch', '')}", file=out)
    print(f"Term:               {st.get('term', 0)}", file=out)
    if "membership_epoch" in st:
        members = ", ".join(st.get("membership", ()))
        print(f"Membership:         epoch {st['membership_epoch']} "
              f"[{members}]", file=out)
    print(f"Applied seq:        {st.get('seq', 0)}", file=out)
    if "commit_seq" in st:
        print(f"Committed seq:      {st['commit_seq']}", file=out)
    if "quorum" in st:
        print(f"Quorum:             {st['quorum']} of "
              f"{st.get('replicas', 1)}", file=out)
    print(f"WAL:                {st.get('wal_size_bytes', 0)} bytes, "
          f"{st.get('wal_records', 0)} records since snapshot", file=out)
    print(f"Snapshot:           {st.get('snapshot_size_bytes', 0)} bytes "
          f"@ seq {st.get('snapshot_seq', 0)}", file=out)
    print(f"Last fsync:         {st.get('last_fsync_ms', 0)} ms "
          f"at {st.get('last_fsync_ts', 0)}", file=out)
    if "wal_codec" in st:
        print(f"WAL codec:          {st['wal_codec']}", file=out)
    followers = st.get("followers", {})
    if followers:
        print("Followers:", file=out)
        print(f"  {'ID':<22}{'ACKED':<9}{'LAG':<7}{'LAG-MS':<9}"
              f"{'CODEC':<7}", file=out)
        for fid in sorted(followers):
            f = followers[fid]
            print(
                f"  {fid:<22}{f.get('acked_seq', 0):<9}"
                f"{f.get('lag_entries', 0):<7}{f.get('lag_ms', 0):<9g}"
                f"{f.get('codec', 'json'):<7}",
                file=out,
            )
    elif st.get("role") == "leader" and int(st.get("replicas", 1)) > 1:
        print("Followers:          <none attached>", file=out)
    return 0


def _bus_membership_change(vc: VolcanoClient, args, out, what: str) -> int:
    """Shared driver for ``bus add-replica`` / ``bus remove-replica``:
    sends the VBUS v7 membership op (the server routes it to the
    leader) and renders the committed config."""
    api = vc.api
    method = getattr(api, f"bus_{what}_replica", None)
    if method is None:
        # the in-process backend has no replication group to change
        print("error: dynamic membership needs a replicated bus — "
              "connect with --bus tcp://...", file=out)
        return 1
    res = method(args.url)
    members = "\n".join(f"  {u}" for u in res.get("endpoints", ()))
    print(f"membership change committed at seq {res.get('seq', 0)} "
          f"(epoch {res.get('epoch', 0)}):", file=out)
    print(members, file=out)
    return 0


def _bus_add_replica(vc: VolcanoClient, args, out) -> int:
    return _bus_membership_change(vc, args, out, "add")


def _bus_remove_replica(vc: VolcanoClient, args, out) -> int:
    return _bus_membership_change(vc, args, out, "remove")


# ---- the cycle journal (cmd/trace.py's commands) ----

def _journal(vc: VolcanoClient, args, out) -> int:
    return trace_cmd.COMMANDS[args.cmd](args, out)


# ---- flight recorder (obs/): the cross-process waterfall ----

def _trace_identity(vc: VolcanoClient, args, out, gang: bool) -> int:
    """Shared body of ``vtctl trace pod`` / ``vtctl trace gang``:
    collect the durably-held telemetry segments from the bus, select
    the identity's trace (matched spans + ancestor closure + the
    cycles' process-scope sub-spans) and render the submit→bind
    waterfall; ``--chrome`` additionally writes the merged
    multi-process trace_event JSON with real pid/tid rows.  Reads only
    the API surface — identical over in-process and ``--bus``."""
    spans = obs.collect_spans(vc.api)
    if gang:
        idents = [(args.namespace, args.name)]
    else:
        # a pod's waterfall unions the pod, its PodGroup, and its
        # owning Job (the controller's status-writeback trace)
        idents = obs.related_identities(vc.api, args.namespace, args.name)
    trace = obs.select_union(spans, idents)
    kind = "gang" if gang else "pod"
    print(f"Flight recorder — {kind} {args.namespace}/{args.name} "
          f"(trace {obs.trace_id_for(args.namespace, args.name)})",
          file=out)
    obs.render_waterfall(trace, out)
    if getattr(args, "chrome", ""):
        with open(args.chrome, "w") as f:
            f.write(json.dumps(obs.chrome_export(trace), indent=1))
        print(f"wrote merged Chrome trace to {args.chrome}", file=out)
    return 0 if trace else 1


def _trace_pod(vc: VolcanoClient, args, out) -> int:
    return _trace_identity(vc, args, out, gang=False)


def _trace_gang(vc: VolcanoClient, args, out) -> int:
    return _trace_identity(vc, args, out, gang=True)


# ---- top (federated /metrics aggregation) ----

#: the write-path ops whose latency the COMMIT column aggregates
_COMMIT_OPS = ("create", "commit_batch", "cas_bind", "txn_commit")


def _top_targets(vc: VolcanoClient, args) -> Dict[str, str]:
    """member label → host:port /metrics address.  Discovery is
    configuration-free: scheduler members advertise ``metricsAddr`` on
    the shard lease map's stats blob, apiservers advertise
    ``metrics_address`` on ``bus_status`` (every endpoint in the
    ``--bus`` list is asked).  ``--metrics a,b`` adds explicit extra
    targets."""
    targets: Dict[str, str] = {}
    try:
        rec = read_shard_map(vc.api)
    except ApiError:
        rec = None
    if rec:
        for ident in sorted(rec.get("stats") or {}):
            addr = (rec["stats"][ident] or {}).get("metricsAddr")
            if addr:
                targets[ident] = addr
    bus = getattr(args, "bus", "") or ""
    if bus:
        from volcano_tpu_torch.bus import BusError, connect_bus

        for i, url in enumerate(u.strip() for u in bus.split(",")):
            if not url:
                continue
            try:
                remote = connect_bus(url, wait=2.0)
                try:
                    st = remote.bus_status()
                finally:
                    remote.close()
            except (BusError, ApiError):
                continue
            addr = st.get("metrics_address")
            if addr:
                targets[f"apiserver-{i} [{st.get('role', '?')}]"] = addr
    else:
        st = vc.api.bus_status() if hasattr(vc.api, "bus_status") else {}
        addr = st.get("metrics_address")
        if addr:
            targets[f"apiserver [{st.get('role', '?')}]"] = addr
    for addr in (getattr(args, "metrics", "") or "").split(","):
        addr = addr.strip()
        if addr:
            targets.setdefault(addr, addr)
    return targets


def _max_burn(s) -> float:
    """Worst fast-window SLO burn rate in one scrape — max over the
    ``volcano_slo_burn{window="fast"}`` series (summing across SLOs
    would manufacture a breach out of several healthy ones)."""
    values = [
        v for (name, labels), v in s.series.items()
        if name == "volcano_slo_burn" and ("window", "fast") in labels
    ]
    return max(values) if values else 0.0


def _top(vc: VolcanoClient, args, out) -> int:
    """Aggregate /metrics across the whole membership (one row per
    member + a cluster TOTAL row); ``--watch N`` redraws every N
    seconds (``--count`` bounds the frames), ``--json`` emits the same
    numbers machine-readably."""
    watch = getattr(args, "watch", 0.0) or 0.0
    if watch <= 0:
        return _top_once(vc, args, out)
    count = getattr(args, "count", 0) or 0
    frames = 0
    rc = 0
    try:
        while True:
            rc = _top_once(vc, args, out)
            frames += 1
            if count and frames >= count:
                return rc
            time.sleep(watch)
            print("", file=out)
    except KeyboardInterrupt:
        return rc


def _top_once(vc: VolcanoClient, args, out) -> int:
    """One ``vtctl top`` frame: per-member rows + a cluster-wide TOTAL
    row.  With ``--interval S`` two scrapes bound a window and the
    counters/histograms become rates and windowed percentiles;
    otherwise the columns are process-lifetime cumulative."""
    targets = _top_targets(vc, args)
    if not targets:
        print("no scrape targets discovered — need a running federation "
              "(shard map with metricsAddr), a --bus endpoint list, or "
              "explicit --metrics host:port", file=out)
        return 1

    def scrape_all() -> Dict[str, object]:
        scrapes = {}
        for label, addr in targets.items():
            try:
                scrapes[label] = _scrape.parse_metrics(
                    _scrape.fetch_metrics(addr)
                )
            except OSError as e:
                print(f"  scrape of {label} ({addr}) failed: {e}", file=out)
        return scrapes

    first = scrape_all()
    interval = getattr(args, "interval", 0.0) or 0.0
    if interval > 0:
        time.sleep(interval)
        second = scrape_all()
        scrapes = {
            label: _scrape.delta(second[label], first[label])
            for label in second if label in first
        }
        window = f"{interval:g}s window"
    else:
        scrapes = first
        window = "cumulative"
    if not scrapes:
        print("every scrape failed", file=out)
        return 1

    def stats_for(s) -> dict:
        q = _scrape.histogram_quantile
        cycles = s.histogram("volcano_e2e_scheduling_latency_milliseconds")
        commit = _scrape.merge_histograms([h for h in (
            *(s.histogram("volcano_bus_request_latency_milliseconds",
                          method=op) for op in _COMMIT_OPS),
            *(s.histogram("volcano_bus_server_request_latency_milliseconds",
                          op=op) for op in _COMMIT_OPS),
        ) if h])
        return {
            "cycles": int((cycles or {}).get("count", 0)),
            "binds": int(s.value("volcano_pod_schedule_successes")),
            "s2bP99Ms": q(s.histogram(
                "volcano_submit_to_bind_latency_milliseconds"), 0.99),
            "commitP99Ms": q(commit, 0.99),
            "fsyncP99Ms": q(s.histogram(
                "volcano_wal_fsync_latency_milliseconds"), 0.99),
            "quorumP99Ms": q(s.histogram(
                "volcano_repl_quorum_wait_milliseconds"), 0.99),
            "dropped": int(s.value("volcano_telemetry_dropped_total")),
            "burn": _max_burn(s),
        }

    def row(label: str, st: dict) -> str:
        return (
            f"  {label:<30}"
            f"{st['cycles']:<8}"
            f"{st['binds']:<8}"
            f"{st['s2bP99Ms']:<9.1f}"
            f"{st['commitP99Ms']:<11.1f}"
            f"{st['fsyncP99Ms']:<10.1f}"
            f"{st['quorumP99Ms']:<11.1f}"
            f"{st['dropped']:<8}"
            f"{st['burn']:<6.2f}"
        )

    # cluster-wide: histograms merge pointwise, counters sum; the BURN
    # column takes the fleet max (a burn is a per-process judgement)
    total = _scrape.Scrape()
    for s in scrapes.values():
        for key, v in s.series.items():
            name = key[0]
            if name.endswith("_total") or name.endswith("_counts") or (
                "pod_schedule" in name
            ):
                total.series[key] = total.series.get(key, 0.0) + v
        for key, h in s.histograms.items():
            cur = total.histograms.get(key)
            total.histograms[key] = (
                _scrape.merge_histograms([cur, h]) if cur else h
            )
    member_stats = {label: stats_for(scrapes[label])
                    for label in sorted(scrapes)}
    cluster = stats_for(total)
    cluster["burn"] = max(
        [st["burn"] for st in member_stats.values()], default=0.0
    )
    if getattr(args, "json", False):
        report = {"window": window, "members": member_stats,
                  "cluster": cluster}
        if interval > 0:
            report["bindRatePerS"] = round(cluster["binds"] / interval, 3)
        print(json.dumps(report, indent=1, sort_keys=True), file=out)
        return 0
    print(f"Cluster metrics ({window}; {len(scrapes)} member(s)):",
          file=out)
    print(
        f"  {'MEMBER':<30}{'CYCLES':<8}{'BINDS':<8}{'S2B-99':<9}"
        f"{'COMMIT-99':<11}{'FSYNC-99':<10}{'QUORUM-99':<11}{'DROPPED':<8}"
        f"{'BURN':<6}",
        file=out,
    )
    for label, st in member_stats.items():
        print(row(label, st), file=out)
    print(row("CLUSTER", cluster), file=out)
    if interval > 0:
        print(f"  cluster bind rate: {cluster['binds'] / interval:.1f}/s",
              file=out)
    return 0


# ---- incidents (obs/incident.py) ----

def _select_incidents(vc: VolcanoClient, args):
    records = obs.list_incidents(vc.api)
    identity = getattr(args, "identity", "") or ""
    if identity:
        records = [r for r in records
                   if r["meta"].get("identity") == identity]
    return records


def _fmt_ts(ts: float) -> str:
    """Stored capture timestamp → fixed UTC rendering (derived from
    stored fields only — the byte-identity discipline)."""
    import datetime as _dt

    return _dt.datetime.fromtimestamp(ts, _dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _incidents_list(vc: VolcanoClient, args, out) -> int:
    records = _select_incidents(vc, args)
    if not records:
        print("no incident bundles published on this bus", file=out)
        return 0
    print(f"  {'#':<4}{'WHEN (UTC)':<22}{'IDENTITY':<24}{'TRIGGER':<28}"
          f"{'SPANS':<7}ALERTS", file=out)
    for i, rec in enumerate(records):
        meta = rec["meta"]
        alerts = ",".join(a.get("name", "?")
                          for a in meta.get("alerts") or []) or "-"
        print(
            f"  {i:<4}{_fmt_ts(meta.get('ts', 0.0)):<22}"
            f"{meta.get('identity', '?'):<24}"
            f"{meta.get('reason', '?'):<28}"
            f"{len(rec['spans']):<7}{alerts}",
            file=out,
        )
    return 0


def _incidents_show(vc: VolcanoClient, args, out) -> int:
    records = _select_incidents(vc, args)
    if not records:
        print("no matching incident bundle", file=out)
        return 1
    index = args.index if args.index is not None else len(records) - 1
    if not 0 <= index < len(records):
        print(f"error: index {index} out of range "
              f"(0..{len(records) - 1})", file=out)
        return 1
    rec = records[index]
    meta = dict(rec["meta"])
    print(f"incident {rec['object']}:", file=out)
    print(json.dumps(meta, indent=1, sort_keys=True), file=out)
    if rec["spans"]:
        print("", file=out)
        obs.render_waterfall(rec["spans"], out)
    return 0


def _incidents_collect(vc: VolcanoClient, args, out) -> int:
    """Pull every member's published incident summary into one local
    directory — the fleet-wide black-box retrieval."""
    records = _select_incidents(vc, args)
    if not records:
        print("no incident bundles published on this bus", file=out)
        return 0
    os.makedirs(args.out, exist_ok=True)
    for rec in records:
        path = os.path.join(args.out, f"{rec['object']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
    print(f"collected {len(records)} incident summar"
          f"{'y' if len(records) == 1 else 'ies'} into {args.out}",
          file=out)
    return 0


def _incidents_capture(vc: VolcanoClient, args, out) -> int:
    """Operator-initiated capture: arm the cluster-wide boost, wait
    the settle window so boosted-fidelity spans land, write a bundle
    locally from whatever the bus holds."""
    from volcano_tpu_torch.obs.incident import IncidentManager, set_capture_boost

    identity = args.identity or "vtctl"
    try:
        boost = set_capture_boost(vc.api, identity, "manual",
                                  args.boost_ttl)
    except Exception as e:  # noqa: BLE001 — boostless capture still
        # beats no capture
        print(f"  capture-boost CAS failed ({e}); capturing unboosted",
              file=out)
        boost = None
    if args.settle > 0:
        time.sleep(args.settle)
    mgr = IncidentManager(
        vc.api, identity, args.dir,
        boost_ttl_s=args.boost_ttl, settle_s=0.0,
    )
    path = mgr.capture("manual", detail="vtctl incidents capture",
                       boost=boost)
    print(f"bundle: {path}", file=out)
    return 0


def _faults_validate(vc: VolcanoClient, args, out) -> int:
    """Parse a fault schedule and print it normalized — catches a
    typo'd point name or malformed modifier before it reaches a daemon
    flag (where it would be a startup error at deploy time)."""
    from volcano_tpu_torch.faults import parse_faults

    spec = parse_faults(args.spec)  # ValueError → main's error path
    print(f"seed: {spec.seed}", file=out)
    if not spec.rules:
        print("no fault rules (plane would be a no-op)", file=out)
    for rule in spec.rules.values():
        mods = []
        if rule.count is not None:
            mods.append(f"at most {rule.count} firings")
        if rule.after:
            mods.append(f"after {rule.after} evaluations")
        if rule.ms:
            mods.append(f"{rule.ms:g} ms")
        suffix = f" ({', '.join(mods)})" if mods else ""
        print(f"  {rule.point}: p={rule.probability:g}{suffix}", file=out)
    print(f"normalized: {spec.format()}", file=out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vtctl", description="volcano-tpu control CLI")
    parser.add_argument(
        "--bus", default="",
        help="talk to a live vtpu-apiserver at tcp://host:port (the "
        "kubeconfig equivalent for the multi-process topology)",
    )
    sub = parser.add_subparsers(dest="group", required=True)

    job = sub.add_parser("job").add_subparsers(dest="cmd", required=True)

    run = job.add_parser("run")
    run.add_argument("--name", "-N", default="")
    run.add_argument("--namespace", "-n", default="default")
    run.add_argument("--image", "-i", default="busybox")
    run.add_argument("--replicas", "-r", type=int, default=1)
    run.add_argument("--min", dest="min_available", type=int, default=1)
    run.add_argument("--requests", "-R", default="cpu=1000m,memory=100Mi")
    run.add_argument("--limits", "-L", default="cpu=1000m,memory=100Mi")
    run.add_argument("--scheduler", "-S", default="volcano-tpu")
    run.add_argument("--queue", "-q", default="default")
    run.add_argument("--taskname", default="task")
    run.add_argument("--filename", "-f", default="")

    for name in ("list",):
        p = job.add_parser(name)
        p.add_argument("--namespace", "-n", default="")

    for name in ("view", "suspend", "resume", "delete"):
        p = job.add_parser(name)
        p.add_argument("--name", "-N", required=True)
        p.add_argument("--namespace", "-n", default="default")

    queue = sub.add_parser("queue").add_subparsers(dest="cmd", required=True)
    qc = queue.add_parser("create")
    qc.add_argument("--name", "-N", required=True)
    qc.add_argument("--weight", "-w", type=int, default=1)
    qg = queue.add_parser("get")
    qg.add_argument("--name", "-N", required=True)
    queue.add_parser("list")
    qo = queue.add_parser("operate")
    qo.add_argument("--name", "-N", required=True)
    qo.add_argument("--action", "-a", required=True, choices=["open", "close", "update"])
    qo.add_argument("--weight", "-w", type=int, default=None)
    qd = queue.add_parser("delete")
    qd.add_argument("--name", "-N", required=True)

    desc = sub.add_parser(
        "describe",
        description="conditions + events + unschedulable-reason histogram",
    ).add_subparsers(dest="cmd", required=True)
    for name in ("job", "podgroup"):
        p = desc.add_parser(name)
        p.add_argument("--name", "-N", required=True)
        p.add_argument("--namespace", "-n", default="default")

    shards = sub.add_parser(
        "shards",
        description="live shard map: lease holders, member heartbeats, "
        "spillover counters (sharded scheduler federation)",
    )
    shards.set_defaults(cmd=None)

    bus_p = sub.add_parser(
        "bus",
        description="replicated persistent bus (WAL + leader/follower "
        "apiserver HA)",
    ).add_subparsers(dest="cmd", required=True)
    bus_p.add_parser(
        "status",
        description="role, leader identity, term, WAL/snapshot sizes, "
        "fsync stats, per-follower replication lag, membership epoch",
    )
    bus_add = bus_p.add_parser(
        "add-replica",
        description="admit ONE new replica to the running replication "
        "group (dynamic membership, VBUS v7): start the new "
        "vtpu-apiserver with --replicas listing the whole new group "
        "(itself last) so it catches up as a learner, then run this — "
        "the leader logs a replicated membership record once the "
        "joiner's lag has closed",
    )
    bus_add.add_argument("url", help="the joiner's bus endpoint "
                         "(tcp://host:port)")
    bus_rm = bus_p.add_parser(
        "remove-replica",
        description="retire ONE replica from the running group; "
        "refused when the remaining members could not commit a write "
        "(reachable-majority floor) or when aimed at the leader",
    )
    bus_rm.add_argument("url", help="the retiring replica's bus endpoint")

    trace_p = sub.add_parser(
        "trace", description="cycle journal: record, replay, diff, export; "
        "flight recorder: pod, gang"
    ).add_subparsers(dest="cmd", required=True)
    trace_cmd.add_commands(trace_p)

    for name in ("pod", "gang"):
        tp = trace_p.add_parser(
            name,
            description="flight recorder: render the cross-process "
            "submit→bind waterfall for one "
            + ("gang (PodGroup identity)" if name == "gang"
               else "pod identity")
            + " from the telemetry segments on the bus",
        )
        tp.add_argument("--name", "-N", required=True)
        tp.add_argument("--namespace", "-n", default="default")
        tp.add_argument(
            "--chrome", default="",
            help="also write the merged multi-process Chrome "
            "trace_event JSON here (real pid/tid rows)",
        )

    top = sub.add_parser(
        "top",
        description="aggregate /metrics across the whole membership "
        "(scheduler shards discovered from the shard lease map, "
        "apiservers from the --bus endpoint list): per-member and "
        "cluster-wide rates, commit/fsync/quorum latency columns",
    )
    top.set_defaults(cmd=None)
    top.add_argument(
        "--metrics", default="",
        help="extra host:port /metrics targets, comma-separated "
        "(for daemons outside the federation/replica discovery)",
    )
    top.add_argument(
        "--interval", type=float, default=0.0,
        help="seconds between two scrapes: columns become windowed "
        "rates/percentiles instead of process-lifetime cumulative",
    )
    top.add_argument(
        "--watch", type=float, default=0.0, metavar="N",
        help="redraw every N seconds until interrupted",
    )
    top.add_argument(
        "--count", type=int, default=0,
        help="with --watch: stop after this many frames (0 = forever)",
    )
    top.add_argument(
        "--json", action="store_true",
        help="emit the per-member and cluster stats as JSON",
    )

    inc = sub.add_parser(
        "incidents", aliases=["incident"],
        description="cluster incident bundles — the black box the SLO "
        "burn-rate watchdog (or an operator) captures at a breach: "
        "kept traces, metrics window, bus/shard state, capture-boost "
        "record (volcano_tpu_torch/obs/incident.py)",
    ).add_subparsers(dest="cmd", required=True)
    il = inc.add_parser(
        "list", description="every incident summary published on the "
        "bus, fleet-wide, oldest first",
    )
    il.add_argument("--identity", default="",
                    help="only bundles captured by this daemon identity")
    ish = inc.add_parser(
        "show", description="one incident's meta + the breach-window "
        "waterfall, from the stored summary",
    )
    ish.add_argument("--identity", default="")
    ish.add_argument("--index", type=int, default=None,
                     help="row from `incidents list` (default: latest)")
    ic = inc.add_parser(
        "collect", description="download every member's published "
        "incident summary into a local directory",
    )
    ic.add_argument("--identity", default="")
    ic.add_argument("--out", "-o", required=True,
                    help="destination directory")
    icap = inc.add_parser(
        "capture", description="operator-initiated capture: CAS the "
        "cluster-wide capture boost, wait --settle seconds for "
        "full-fidelity spans to land, write one bundle locally",
    )
    icap.add_argument("--dir", "-d", required=True,
                      help="bundle ring directory")
    icap.add_argument("--identity", default="",
                      help="identity stamped on the bundle "
                      "(default 'vtctl')")
    icap.add_argument("--settle", type=float, default=2.0,
                      help="seconds between boost and bundle write")
    icap.add_argument("--boost-ttl", type=float, default=30.0,
                      help="capture-boost TTL seconds")

    faults_p = sub.add_parser(
        "faults",
        description="fault-injection schedules (volcano_tpu_torch.faults)",
    ).add_subparsers(dest="cmd", required=True)
    fv = faults_p.add_parser(
        "validate",
        description="parse a --faults/VTPU_FAULTS spec and print the "
        "normalized schedule (rejects typos before a chaos run)",
    )
    fv.add_argument("--spec", "-s", required=True)

    lint = sub.add_parser(
        "lint",
        description="run the port's project-invariant static-analysis "
        "suite (volcano_tpu_torch.analysis: lock discipline, determinism, "
        "VBUS serde drift, metric hygiene); extra arguments are "
        "forwarded, e.g. `vtctl lint --pass lock --report out.json`",
    )
    lint.set_defaults(cmd=None)
    lint.add_argument("lint_args", nargs=argparse.REMAINDER)
    return parser


_HANDLERS = {
    ("job", "run"): _job_run,
    ("job", "list"): _job_list,
    ("job", "view"): _job_view,
    ("job", "suspend"): _job_suspend,
    ("job", "resume"): _job_resume,
    ("job", "delete"): _job_delete,
    ("queue", "create"): _queue_create,
    ("queue", "get"): _queue_get,
    ("queue", "list"): _queue_list,
    ("queue", "operate"): _queue_operate,
    ("queue", "delete"): _queue_delete,
    ("describe", "job"): _describe_job,
    ("describe", "podgroup"): _describe_podgroup,
    ("shards", None): _shards,
    ("top", None): _top,
    **{("trace", name): _journal for name in trace_cmd.COMMANDS},
    ("trace", "pod"): _trace_pod,
    ("trace", "gang"): _trace_gang,
    ("faults", "validate"): _faults_validate,
    ("bus", "status"): _bus_status,
    ("bus", "add-replica"): _bus_add_replica,
    ("bus", "remove-replica"): _bus_remove_replica,
    # the singular alias parses with group="incident"
    **{(group, cmd): handler
       for group in ("incidents", "incident")
       for cmd, handler in (("list", _incidents_list), ("show", _incidents_show),
                            ("collect", _incidents_collect),
                            ("capture", _incidents_capture))},
}


def main(argv: Optional[List[str]] = None, api: Optional[APIServer] = None, out=None) -> int:
    out = out if out is not None else sys.stdout
    raw = list(sys.argv[1:] if argv is None else argv)
    # `lint` is intercepted before argparse: pure source analysis — no
    # store, no bus — and its flags are forwarded verbatim (argparse
    # REMAINDER refuses leading optionals).  The scan skips the root
    # parser's own options so `vtctl --bus X lint …` routes here too
    # (the bus is simply ignored; lint never touches a store).
    i = 0
    while i < len(raw):
        tok = raw[i]
        if tok == "--bus":
            i += 2
            continue
        if tok.startswith("--bus="):
            i += 1
            continue
        if tok == "lint":
            from volcano_tpu_torch.analysis.__main__ import main as lint_main

            return lint_main(raw[i + 1:], out=out)
        break  # any other first positional/option: normal dispatch
    args = build_parser().parse_args(argv)
    remote = None
    if api is None and getattr(args, "bus", ""):
        from volcano_tpu_torch.bus import BusError, connect_bus

        try:
            api = remote = connect_bus(args.bus, wait=10.0)
        except BusError as e:
            print(f"error: {e}", file=out)
            return 1
    if api is None:
        api = APIServer()  # empty standalone instance
    vc = VolcanoClient(api)
    handler = _HANDLERS[(args.group, args.cmd)]
    try:
        return handler(vc, args, out)
    except (ApiError, ValueError, OSError) as e:
        print(f"error: {e}", file=out)
        return 1
    except RuntimeError as e:
        # only for trace commands: RuntimeError there means a
        # supported-but-unavailable executor (replay on the card with no
        # card, native without the C++ toolchain) — a user error, not a
        # crash.  Elsewhere it's a genuine internal error whose
        # traceback must surface.
        if args.group == "trace":
            print(f"error: {e}", file=out)
            return 1
        raise
    finally:
        if remote is not None:
            remote.close()


if __name__ == "__main__":
    sys.exit(main())
