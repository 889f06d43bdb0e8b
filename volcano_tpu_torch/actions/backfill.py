"""Backfill action — place best-effort tasks on any feasible node.

A copy of ``volcano_tpu/actions/backfill.py``.

Reference: pkg/scheduler/actions/backfill/backfill.go.
"""

from __future__ import annotations

from volcano_tpu_torch.api import FitError, TaskStatus
from volcano_tpu_torch.api.unschedule_info import FitErrors
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.framework.interface import Action
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.scheduler import util as sched_util


class BackfillAction(Action):
    def name(self) -> str:
        return "backfill"

    def execute(self, ssn: Session) -> None:
        """backfill.go:41-91."""
        for job in sorted(ssn.jobs.values(), key=lambda j: j.uid):
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == scheduling.POD_GROUP_PENDING
            ):
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue

            for task in sorted(
                job.task_status_index.get(TaskStatus.Pending, {}).values(),
                key=lambda t: t.uid,
            ):
                if not task.init_resreq.is_empty():
                    continue
                allocated = False
                fe = FitErrors()
                for node in sched_util.get_node_list(ssn.nodes):
                    try:
                        ssn.predicate_fn(task, node)
                    except FitError as err:
                        fe.set_node_error(node.name, err)
                        continue
                    try:
                        ssn.allocate(task, node.name)
                    except FitError as err:
                        # propagate the bare reasons — re-wrapping str(err)
                        # would stuff the whole "task X on node Y: reason"
                        # line into the list and corrupt the
                        # FitErrors.error() reason histogram
                        fe.set_node_error(
                            node.name, FitError(task, node, *err.reasons)
                        )
                        continue
                    except Exception as err:  # noqa: BLE001 — try next node
                        fe.set_node_error(node.name, FitError(task, node, str(err)))
                        continue
                    allocated = True
                    break
                if not allocated:
                    job.nodes_fit_errors[task.uid] = fe
                    ssn.touched_jobs.add(job.uid)


def new() -> BackfillAction:
    return BackfillAction()
