"""The scheduler's "why is my job pending" debug surface.

The port of ``volcano_tpu/serving/explain.py``.  ``GET
/explain?namespace=&job=`` (serving/http.py, gated like
``/debug/stacks``) renders the scheduler's live view of unschedulable
work.  Fit errors live on session clones and are discarded at session
close, so the durable source is the cache's *unschedulable digest* —
parked by the status writeback (``cache.record_job_status_event``) —
merged with the most recent cycle's device-derived reason summary
(``ops/explain.last_explain``), including per-node attribution when
plane retention is on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.api.unschedule_info import parse_fit_errors
from volcano_tpu_torch.ops.explain import last_explain


def _digest_entry(
    uid: str, digest: dict, job, device_tasks: Dict[str, Any]
) -> Dict[str, Any]:
    entry: Dict[str, Any] = {
        "namespace": digest["namespace"],
        "name": digest["name"],
        "queue": digest["queue"],
    }
    if job is not None:
        entry["min_available"] = int(job.min_available)
        entry["ready_tasks"] = int(job.ready_task_num())
        entry["pending_tasks"] = len(
            job.task_status_index.get(TaskStatus.Pending, {})
        )
        if job.pod_group is not None:
            entry["phase"] = job.pod_group.status.phase
    if digest.get("job_fit_errors"):
        entry["job_fit_errors"] = digest["job_fit_errors"]
    tasks = []
    for task_uid, info in digest["tasks"].items():
        item: Dict[str, Any] = {
            "uid": task_uid,
            "name": info["name"],
            "message": info["message"],
        }
        parsed = parse_fit_errors(info["message"])
        if parsed is not None:
            item["total_nodes"], item["reasons"] = parsed
        device = device_tasks.get(task_uid)
        if device and device.get("nodes"):
            # per-node attribution from the device explain pass (only
            # present when plane retention is enabled)
            item["nodes"] = device["nodes"]
        tasks.append(item)
    entry["unschedulable"] = tasks
    return entry


def explain_jobs(
    cache, namespace: str = "", job_name: str = ""
) -> Optional[Dict[str, Any]]:
    """The /explain payload: jobs whose last status writeback recorded
    unschedulable tasks (or the one named job), plus the last device
    explain summary.  Returns None when a specific job was asked for
    and has nothing recorded."""
    device = last_explain() or {}
    device_tasks = device.get("tasks", {})

    jobs = []
    with cache._mutex:
        for uid, digest in cache.unschedulable_digest.items():
            if namespace and digest["namespace"] != namespace:
                continue
            if job_name and digest["name"] != job_name:
                continue
            jobs.append(
                _digest_entry(uid, digest, cache.jobs.get(uid), device_tasks)
            )
    if job_name and not jobs:
        return None
    out: Dict[str, Any] = {"jobs": jobs}
    if device:
        out["last_cycle"] = {
            "cycle": device.get("cycle", -1),
            "n_nodes": device.get("n_nodes", 0),
            "reasons": device.get("summary", {}),
        }
    return out
