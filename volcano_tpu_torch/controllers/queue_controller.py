"""Queue controller — reconciles Queue status and the open/close state
machine driven by Command CRs.

A copy of ``volcano_tpu/controllers/queue_controller.py``.

Reference: pkg/controllers/queue/{queue_controller.go,
queue_controller_action.go, state/*.go}.
"""

from __future__ import annotations

import queue as _queue

from volcano_tpu_torch.apis import bus, scheduling
from volcano_tpu_torch.client import ADDED, APIServer, MODIFIED, NotFoundError, VolcanoClient
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

OPEN_QUEUE_ACTION = "OpenQueue"
CLOSE_QUEUE_ACTION = "CloseQueue"


class QueueController:
    def __init__(self, api: APIServer):
        self.api = api
        self.vc = VolcanoClient(api)
        self.queue: _queue.Queue = _queue.Queue()
        api.watch("Queue", self._on_queue)
        api.watch("PodGroup", self._on_pod_group)
        # dual informer set: raw v1alpha1 podgroups count too
        api.watch("PodGroupV1alpha1", self._on_pod_group)
        api.watch("Command", self._on_command)

    # ---- handlers (queue_controller.go:93-166) ----

    def _on_queue(self, event, old, new) -> None:
        if event == ADDED:
            self.queue.put((new.metadata.name, ""))
        elif event == MODIFIED:
            # Status writes come from our own sync — re-enqueue only on
            # spec changes to keep the reconcile loop convergent.
            if old is None or old.spec != new.spec:
                self.queue.put((new.metadata.name, ""))

    def _on_pod_group(self, event, old, new) -> None:
        pg = new if new is not None else old
        if pg is not None and pg.spec.queue:
            self.queue.put((pg.spec.queue, ""))

    def _on_command(self, event, old, new) -> None:
        if event != ADDED:
            return
        cmd: bus.Command = new
        if cmd.target_object.kind != "Queue":
            return
        try:
            self.vc.delete_command(cmd.metadata.namespace, cmd.metadata.name)
        except NotFoundError:
            return
        self.queue.put((cmd.target_object.name, cmd.action))

    # ---- worker ----

    def process_next(self) -> bool:
        try:
            name, action = self.queue.get(block=False)
        except _queue.Empty:
            return False
        try:
            self.sync_queue(name, action)
        except Exception as e:  # noqa: BLE001
            log.error("failed to sync queue %s: %s", name, e)
        return True

    def drain(self) -> None:
        while self.process_next():
            pass

    # ---- state machine (queue/state/*.go folded into transitions) ----

    def sync_queue(self, name: str, action: str = "") -> None:
        """queue_controller_action.go:33-155."""
        queue = self.vc.get_queue(name)
        if queue is None:
            return

        state = queue.spec.state or scheduling.QUEUE_STATE_OPEN

        if action == CLOSE_QUEUE_ACTION and state == scheduling.QUEUE_STATE_OPEN:
            queue.spec.state = scheduling.QUEUE_STATE_CLOSING
            queue = self.vc.update_queue(queue)
            state = queue.spec.state
        elif action == OPEN_QUEUE_ACTION and state in (
            scheduling.QUEUE_STATE_CLOSED,
            scheduling.QUEUE_STATE_CLOSING,
        ):
            queue.spec.state = scheduling.QUEUE_STATE_OPEN
            queue = self.vc.update_queue(queue)
            state = queue.spec.state

        # Recount podgroup phases (syncQueue :33-80).
        counts = {"pending": 0, "running": 0, "inqueue": 0, "unknown": 0}
        all_pgs = self.vc.list_pod_groups() + self.api.list("PodGroupV1alpha1")
        for pg in all_pgs:
            if pg.spec.queue != name:
                continue
            phase = pg.status.phase
            if phase == scheduling.POD_GROUP_PENDING:
                counts["pending"] += 1
            elif phase == scheduling.POD_GROUP_RUNNING:
                counts["running"] += 1
            elif phase == scheduling.POD_GROUP_INQUEUE:
                counts["inqueue"] += 1
            else:
                counts["unknown"] += 1

        # Closing → Closed once no active podgroups remain.
        if state == scheduling.QUEUE_STATE_CLOSING and (
            counts["running"] + counts["inqueue"] + counts["pending"] == 0
        ):
            queue.spec.state = scheduling.QUEUE_STATE_CLOSED
            queue = self.vc.update_queue(queue)
            state = queue.spec.state

        queue.status.state = state
        queue.status.pending = counts["pending"]
        queue.status.running = counts["running"]
        queue.status.inqueue = counts["inqueue"]
        queue.status.unknown = counts["unknown"]
        self.vc.update_queue_status(queue)
