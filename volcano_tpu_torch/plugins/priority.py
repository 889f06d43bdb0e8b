"""Priority plugin — PriorityClass-driven ordering and preemption.

A copy of ``volcano_tpu/plugins/priority.py``.

Reference: pkg/scheduler/plugins/priority/priority.go.
"""

from __future__ import annotations

from typing import List

from volcano_tpu_torch.api import TaskInfo
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.interface import Plugin
from volcano_tpu_torch.framework.session import Session

PLUGIN_NAME = "priority"


class PriorityPlugin(Plugin):
    def __init__(self, arguments: Arguments):
        self.arguments = arguments

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn: Session) -> None:
        def task_order_fn(l: TaskInfo, r: TaskInfo) -> int:
            """priority.go:44-60 — higher task priority first."""
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_task_order_fn(self.name(), task_order_fn)

        def job_order_fn(l, r) -> int:
            """priority.go:65-81."""
            if l.priority > r.priority:
                return -1
            if l.priority < r.priority:
                return 1
            return 0

        ssn.add_job_order_fn(self.name(), job_order_fn)

        def preemptable_fn(preemptor: TaskInfo, preemptees: List[TaskInfo]) -> List[TaskInfo]:
            """priority.go:85-102 — only strictly lower-priority jobs."""
            preemptor_job = ssn.jobs.get(preemptor.job)
            if preemptor_job is None:
                return []
            victims = []
            for preemptee in preemptees:
                preemptee_job = ssn.jobs.get(preemptee.job)
                if preemptee_job is None:
                    continue
                if preemptee_job.priority < preemptor_job.priority:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name(), preemptable_fn)


def new(arguments: Arguments) -> Plugin:
    return PriorityPlugin(arguments)
