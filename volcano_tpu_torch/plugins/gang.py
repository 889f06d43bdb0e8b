"""Gang plugin — all-or-nothing co-scheduling policy.

A copy of ``volcano_tpu/plugins/gang.py``.

Reference: pkg/scheduler/plugins/gang/gang.go.
"""

from __future__ import annotations

import time
from typing import List

from volcano_tpu_torch.api import JobInfo, TaskInfo, TaskStatus, ValidateResult
from volcano_tpu_torch.api.unschedule_info import FitErrors
from volcano_tpu_torch.apis import scheduling
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.interface import Plugin
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch import metrics

PLUGIN_NAME = "gang"


class GangPlugin(Plugin):
    def __init__(self, arguments: Arguments):
        self.arguments = arguments

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn: Session) -> None:
        def valid_job_fn(obj) -> ValidateResult:
            """gang.go:52-71 — enough valid tasks to reach minAvailable.

            PodGroupPending jobs pass: their pods may not exist yet by
            design (delay-pod-creation: enqueue promotes Pending→Inqueue
            from minResources alone, docs/design/delay-pod-creation.md),
            and every pod-consuming action skips Pending PodGroups anyway
            (allocate.go:61-63 etc.)."""
            if not isinstance(obj, JobInfo):
                return ValidateResult(pass_=False, message=f"Failed to convert {obj} to JobInfo")
            if (
                obj.pod_group is not None
                and obj.pod_group.status.phase == scheduling.POD_GROUP_PENDING
            ):
                return ValidateResult(pass_=True)
            vtn = obj.valid_task_num()
            if vtn < obj.min_available:
                return ValidateResult(
                    pass_=False,
                    reason=scheduling.NOT_ENOUGH_PODS_REASON,
                    message=(
                        f"Not enough valid tasks for gang-scheduling, "
                        f"valid: {vtn}, min: {obj.min_available}"
                    ),
                )
            return ValidateResult(pass_=True)

        ssn.add_job_valid_fn(self.name(), valid_job_fn)

        def preemptable_fn(preemptor: TaskInfo, preemptees: List[TaskInfo]) -> List[TaskInfo]:
            """gang.go:75-94 — victim's job must stay >= minAvailable."""
            victims = []
            for preemptee in preemptees:
                job = ssn.jobs.get(preemptee.job)
                if job is None:
                    continue
                occupied = job.ready_task_num()
                if job.min_available <= occupied - 1 or job.min_available == 1:
                    victims.append(preemptee)
            return victims

        ssn.add_reclaimable_fn(self.name(), preemptable_fn)
        ssn.add_preemptable_fn(self.name(), preemptable_fn)

        def job_order_fn(l, r) -> int:
            """gang.go:100-123 — not-ready jobs first."""
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(self.name(), job_order_fn)
        ssn.add_job_ready_fn(self.name(), lambda obj: obj.ready())
        ssn.add_job_pipelined_fn(self.name(), lambda obj: obj.pipelined())

    def on_session_close(self, ssn: Session) -> None:
        """gang.go:136-179 — unschedulable conditions + metrics."""
        unschedule_job_count = 0
        for job in ssn.jobs.values():
            if job.ready():
                continue
            unready = job.min_available - job.ready_task_num()
            msg = (
                f"{unready}/{len(job.tasks)} tasks in gang unschedulable: "
                f"{job.fit_error()}"
            )
            job.job_fit_errors = msg
            ssn.touched_jobs.add(job.uid)
            unschedule_job_count += 1
            metrics.update_unschedule_task_count(job.name, int(unready))
            metrics.register_job_retries(job.name)

            ssn.update_job_condition(
                job,
                scheduling.PodGroupCondition(
                    type=scheduling.POD_GROUP_UNSCHEDULABLE_TYPE,
                    status="True",
                    transition_id=ssn.uid,
                    last_transition_time=time.time(),
                    reason=scheduling.NOT_ENOUGH_RESOURCES_REASON,
                    message=msg,
                ),
            )

            # Allocated tasks follow the job fit error (gang.go:164-174).
            for task in job.task_status_index.get(TaskStatus.Allocated, {}).values():
                if task.uid not in job.nodes_fit_errors:
                    fe = FitErrors()
                    fe.set_error(msg)
                    job.nodes_fit_errors[task.uid] = fe

        metrics.update_unschedule_job_count(unschedule_job_count)


def new(arguments: Arguments) -> Plugin:
    return GangPlugin(arguments)
