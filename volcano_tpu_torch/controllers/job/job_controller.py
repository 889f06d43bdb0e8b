"""Job controller — reconciles the Job CRD through its state machine.

A copy of ``volcano_tpu/controllers/job/job_controller.py``.

Reference: pkg/controllers/job/{job_controller.go, job_controller_actions.go,
job_controller_handler.go, job_controller_util.go}.  Event flow: watch
jobs/pods/commands → Request{event} → fnv-hash-sharded worker queues →
applyPolicies (task-level overrides job-level, version fencing) →
state.Execute → syncJob (create PodGroup/PVCs/pods, status rollup) or
killJob (delete non-retained pods, version bump).
"""

from __future__ import annotations

import queue as _queue
import threading
import zlib
from typing import Dict, List, Optional, Set

from volcano_tpu_torch.apis import batch, bus, core, scheduling
from volcano_tpu_torch.client import (
    ADDED,
    AlreadyExistsError,
    APIServer,
    DELETED,
    KubeClient,
    MODIFIED,
    NotFoundError,
    VolcanoClient,
)
from volcano_tpu_torch.controllers.apis import JobInfo, Request
from volcano_tpu_torch.controllers.cache import JobCache
from volcano_tpu_torch.controllers.job import state as jobstate
from volcano_tpu_torch.controllers.job.plugins import get_plugin_builder, plugin_done_key
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Retry budget for failed reconciles (the reference requeues through a
#: rate-limited workqueue; this is the bounded equivalent).
MAX_REQUEUE = 15


#: Pod name format (jobhelpers.PodNameFmt "%s-%s-%d").
def make_pod_name(job_name: str, task_name: str, index: int) -> str:
    return f"{job_name}-{task_name}-{index}"


def classify_pod(pod: core.Pod, counts: Dict[str, int]) -> None:
    """classifyAndAddUpPodBaseOnPhase."""
    phase = pod.status.phase
    if phase == "Pending":
        counts["pending"] += 1
    elif phase == "Running":
        counts["running"] += 1
    elif phase == "Succeeded":
        counts["succeeded"] += 1
    elif phase == "Failed":
        counts["failed"] += 1
    else:
        counts["unknown"] += 1


def create_job_pod(job: batch.Job, task: batch.TaskSpec, index: int) -> core.Pod:
    """job_controller_util.go:39-121 — template → pod with identity
    annotations/labels and job volumes."""
    import copy

    spec = copy.deepcopy(task.template.spec)
    meta = copy.deepcopy(task.template.metadata)
    task_name = task.name or batch.DEFAULT_TASK_SPEC

    pod = core.Pod(
        metadata=core.ObjectMeta(
            name=make_pod_name(job.metadata.name, task_name, index),
            namespace=job.metadata.namespace,
            labels=dict(meta.labels),
            annotations=dict(meta.annotations),
            owner_references=[
                core.OwnerReference(
                    kind="Job",
                    name=job.metadata.name,
                    uid=job.metadata.uid,
                    controller=True,
                )
            ],
        ),
        spec=spec,
    )

    if not pod.spec.scheduler_name:
        pod.spec.scheduler_name = job.spec.scheduler_name

    # Job volumes → pod volumes + mounts (util.go:60-87).
    seen: Set[str] = set()
    for i, volume in enumerate(job.spec.volumes):
        vc_name = volume.volume_claim_name
        if not vc_name or vc_name in seen:
            continue
        seen.add(vc_name)
        vol_name = f"{job.metadata.name}-volume-{i}"
        pod.spec.volumes.append(
            core.Volume(name=vol_name, source={"persistentVolumeClaim": {"claimName": vc_name}})
        )
        for container in pod.spec.containers:
            container.volume_mounts.append(
                core.VolumeMount(name=vol_name, mount_path=volume.mount_path)
            )

    pod.metadata.annotations[batch.TASK_SPEC_KEY] = task_name
    pod.metadata.annotations[scheduling.GROUP_NAME_ANNOTATION_KEY] = job.metadata.name
    pod.metadata.annotations[batch.JOB_NAME_KEY] = job.metadata.name
    pod.metadata.annotations[batch.JOB_VERSION_KEY] = str(job.status.version)
    pod.metadata.labels[batch.JOB_NAME_KEY] = job.metadata.name
    return pod


def apply_policies(job: batch.Job, req: Request) -> str:
    """job_controller_util.go:123-179 — explicit action > OutOfSync >
    version fence > task policies > job policies > SyncJob."""
    if req.action:
        return req.action
    if req.event == batch.OUT_OF_SYNC_EVENT:
        return batch.SYNC_JOB_ACTION
    if req.job_version < job.status.version:
        return batch.SYNC_JOB_ACTION

    if req.task_name:
        for task in job.spec.tasks:
            if task.name != req.task_name:
                continue
            for policy in task.policies:
                if req.event and policy.matches_event(req.event):
                    return policy.action
                if policy.exit_code is not None and policy.exit_code == req.exit_code:
                    return policy.action
            break

    for policy in job.spec.policies:
        if req.event and policy.matches_event(req.event):
            return policy.action
        if policy.exit_code is not None and policy.exit_code == req.exit_code:
            return policy.action

    return batch.SYNC_JOB_ACTION


class JobController:
    def __init__(self, api: APIServer, workers: int = 4):
        self.api = api
        self.kube = KubeClient(api)
        self.vc = VolcanoClient(api)
        self.cache = JobCache()
        self.workers = workers
        self.queues: List[_queue.Queue] = [_queue.Queue() for _ in range(workers)]
        self.priority_classes: Dict[str, core.PriorityClass] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

        # Wire the state machine's action fns (job_controller.go:217-218).
        jobstate.SyncJob = self.sync_job
        jobstate.KillJob = self.kill_job

        self._watch()

    # ---- informer handlers (job_controller_handler.go) ----

    def _watch(self) -> None:
        self.api.watch("Job", self._on_job)
        self.api.watch("Pod", self._on_pod)
        self.api.watch("Command", self._on_command)
        self.api.watch("PriorityClass", self._on_priority_class)
        self.api.watch("PodGroup", self._on_pod_group)

    def _on_pod_group(self, event, old, new) -> None:
        """PG phase transitions re-sync the owning job (the reference's
        pgInformer; needed for the delay-pod-creation gate, where pod
        creation only succeeds after the scheduler moves the PG past
        Pending)."""
        if event != MODIFIED or new is None:
            return
        if old is not None and old.status.phase == new.status.phase:
            return
        self._enqueue(
            Request(
                namespace=new.metadata.namespace,
                job_name=new.metadata.name,
                event=batch.OUT_OF_SYNC_EVENT,
            )
        )

    def _enqueue(self, req: Request) -> None:
        """fnv-hash job key → worker queue (job_controller.go:265-293)."""
        idx = zlib.crc32(req.key().encode()) % self.workers
        self.queues[idx].put(req)

    def _on_job(self, event, old, new) -> None:
        if event == ADDED:
            try:
                self.cache.add(new)
            except ValueError as e:
                log.error("add job to cache failed: %s", e)
            self._enqueue(
                Request(
                    namespace=new.metadata.namespace,
                    job_name=new.metadata.name,
                    event=batch.OUT_OF_SYNC_EVENT,
                )
            )
        elif event == MODIFIED:
            self.cache.update(new)
            # Re-sync on spec changes OR phase transitions; plain status
            # count updates are ignored (handler.go updateJob:86-91) —
            # that gate is what keeps the reconcile loop convergent.
            if old is not None and (
                old.spec != new.spec
                or old.status.state.phase != new.status.state.phase
            ):
                self._enqueue(
                    Request(
                        namespace=new.metadata.namespace,
                        job_name=new.metadata.name,
                        event=batch.OUT_OF_SYNC_EVENT,
                    )
                )
        elif event == DELETED:
            self.cache.delete(old)

    def _pod_request(self, pod: core.Pod, event: str, exit_code=None) -> Optional[Request]:
        job_name = pod.metadata.annotations.get(batch.JOB_NAME_KEY, "")
        if not job_name:
            return None
        version = int(pod.metadata.annotations.get(batch.JOB_VERSION_KEY, "0"))
        return Request(
            namespace=pod.metadata.namespace,
            job_name=job_name,
            task_name=pod.metadata.annotations.get(batch.TASK_SPEC_KEY, ""),
            event=event,
            job_version=version,
            exit_code=exit_code,
        )

    def _on_pod(self, event, old, new) -> None:
        """job_controller_handler.go addPod/updatePod/deletePod:
        pod phase transitions become lifecycle events."""
        pod = new if new is not None else old
        if batch.JOB_NAME_KEY not in pod.metadata.annotations:
            return

        if event == ADDED:
            try:
                self.cache.add_pod(pod)
            except ValueError as e:
                log.error("add pod to cache failed: %s", e)
            req = self._pod_request(pod, batch.OUT_OF_SYNC_EVENT)
            if req:
                self._enqueue(req)
        elif event == MODIFIED:
            try:
                self.cache.update_pod(pod)
            except ValueError as e:
                log.error("update pod in cache failed: %s", e)
            if old is None or old.status.phase == new.status.phase:
                return
            if new.status.phase == "Failed":
                req = self._pod_request(pod, batch.POD_FAILED_EVENT, new.status.exit_code)
            elif new.status.phase == "Succeeded":
                key = f"{pod.metadata.namespace}/{pod.metadata.annotations[batch.JOB_NAME_KEY]}"
                task = pod.metadata.annotations.get(batch.TASK_SPEC_KEY, "")
                if self.cache.task_completed(key, task):
                    req = self._pod_request(pod, batch.TASK_COMPLETED_EVENT)
                else:
                    req = self._pod_request(pod, batch.OUT_OF_SYNC_EVENT)
            else:
                req = self._pod_request(pod, batch.OUT_OF_SYNC_EVENT)
            if req:
                self._enqueue(req)
        elif event == DELETED:
            try:
                self.cache.delete_pod(pod)
            except ValueError as e:
                log.error("delete pod from cache failed: %s", e)
            if pod.status.phase not in ("Succeeded", "Failed"):
                req = self._pod_request(pod, batch.POD_EVICTED_EVENT)
                if req:
                    self._enqueue(req)

    def _on_command(self, event, old, new) -> None:
        """Commands target jobs; consume + delete (handler.go:364-395)."""
        if event != ADDED:
            return
        cmd: bus.Command = new
        if cmd.target_object.kind != "Job":
            return
        try:
            self.vc.delete_command(cmd.metadata.namespace, cmd.metadata.name)
        except NotFoundError:
            return
        self._enqueue(
            Request(
                namespace=cmd.metadata.namespace,
                job_name=cmd.target_object.name,
                event=batch.COMMAND_ISSUED_EVENT,
                action=cmd.action,
            )
        )

    def _on_priority_class(self, event, old, new) -> None:
        if event in (ADDED, MODIFIED):
            self.priority_classes[new.metadata.name] = new
        elif event == DELETED:
            self.priority_classes.pop(old.metadata.name, None)

    # ---- worker loop ----

    def process_next(self, idx: int = 0, block: bool = False) -> bool:
        """job_controller.go:295-356."""
        try:
            req: Request = self.queues[idx].get(block=block, timeout=0.5 if block else None)
        except _queue.Empty:
            return False
        try:
            job_info = self.cache.get(req.key())
            if job_info is None or job_info.job is None:
                return True
            st = jobstate.new_state(job_info)
            action = apply_policies(job_info.job, req)
            st.execute(action)
        except NotFoundError as e:
            # the job was deleted while this request sat in the queue —
            # forget the key, like syncJob's IsNotFound return-nil path
            # (job_controller_actions.go); requeueing would only retry a
            # tombstone until the budget runs out
            log.debug("job %s gone before handling: %s", req.key(), e)
        except Exception as e:  # noqa: BLE001
            log.error("failed to handle job %s: %s", req.key(), e)
            # Requeue with a retry budget (AddRateLimited equivalent) so a
            # transient deny — e.g. the pod admission gate while the
            # PodGroup is still Pending — retries instead of stalling.
            req.retries += 1
            if req.retries < MAX_REQUEUE:
                self.queues[idx].put(req)
        return True

    def drain(self) -> None:
        """Process all pending requests (test/deterministic mode).  New
        requests generated by processing are drained too."""
        progressed = True
        while progressed:
            progressed = False
            for idx in range(self.workers):
                while self.process_next(idx):
                    progressed = True

    def run(self) -> None:
        for idx in range(self.workers):
            t = threading.Thread(target=self._worker, args=(idx,), daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self, idx: int) -> None:
        while not self._stop.is_set():
            self.process_next(idx, block=True)

    def stop(self) -> None:
        self._stop.set()

    # ---- plugins (job_controller_plugins.go:30-90) ----

    def _plugins_for(self, job: batch.Job):
        out = []
        for name, args in job.spec.plugins.items():
            builder = get_plugin_builder(name)
            if builder is None:
                raise ValueError(f"plugin {name} not found")
            out.append(builder(self.kube, args))
        return out

    def plugin_on_job_add(self, job: batch.Job) -> None:
        for plugin in self._plugins_for(job):
            if job.status.controlled_resources.get(plugin_done_key(plugin.name())):
                continue
            plugin.on_job_add(job)

    def plugin_on_job_delete(self, job: batch.Job) -> None:
        for plugin in self._plugins_for(job):
            plugin.on_job_delete(job)

    def plugin_on_pod_create(self, job: batch.Job, pod: core.Pod) -> None:
        for plugin in self._plugins_for(job):
            plugin.on_pod_create(pod, job)

    # ---- sync/kill (job_controller_actions.go) ----

    def _write_status(self, job: batch.Job) -> batch.Job:
        """The one status-writeback site all sync/kill paths share —
        wrapped in a flight-recorder ``controller:status`` span keyed
        to the job identity, so the controller's leg shows up in the
        cross-process waterfall (``vtctl trace pod/gang``)."""
        from volcano_tpu_torch import obs

        ns = job.metadata.namespace
        name = job.metadata.name
        with obs.span(
            "controller:status", cat="controller",
            trace_id=obs.trace_id_for(ns, name),
            args={"job": f"{ns}/{name}",
                  "phase": job.status.state.phase},
        ):
            return self.vc.update_job_status(job)

    def _init_job_status(self, job: batch.Job) -> batch.Job:
        """actions.go initJobStatus."""
        if job.status.state.phase:
            return job
        job.status.state.phase = batch.JOB_PENDING
        job.status.min_available = job.spec.min_available
        updated = self._write_status(job)
        self.cache.update(updated)
        return updated

    def _create_job_io_if_not_exist(self, job: batch.Job) -> batch.Job:
        """actions.go:336-421 — ensure PVCs exist."""
        need_update = False
        for index, volume in enumerate(job.spec.volumes):
            vc_name = volume.volume_claim_name
            if not vc_name:
                base = f"{job.metadata.name}-pvc-{index}"
                vc_name = base
                n = 0
                while self.kube.get_pvc(job.metadata.namespace, vc_name) is not None:
                    n += 1
                    vc_name = f"{base}-{n}"
                job.spec.volumes[index].volume_claim_name = vc_name
                need_update = True
                if volume.volume_claim:
                    self.kube.create_pvc(
                        core.PersistentVolumeClaim(
                            metadata=core.ObjectMeta(
                                name=vc_name, namespace=job.metadata.namespace
                            ),
                            spec=dict(volume.volume_claim),
                        )
                    )
            else:
                if self.kube.get_pvc(job.metadata.namespace, vc_name) is None:
                    raise ValueError(
                        f"pvc {vc_name} is not found, the job will stay Pending until it exists"
                    )
            job.status.controlled_resources[f"volume-pvc-{vc_name}"] = vc_name
        if need_update:
            updated = self.vc.update_job(job)
            updated.status = job.status
            return updated
        return job

    def _calc_pg_min_resources(self, job: batch.Job) -> Dict[str, object]:
        """actions.go:472-504 — priority-sorted first-minAvailable request sum."""
        from volcano_tpu_torch.api.resource import Resource

        tasks = []
        for task in job.spec.tasks:
            pri = 0
            pc = self.priority_classes.get(task.template.spec.priority_class_name)
            if pc is not None:
                pri = pc.value
            tasks.append((pri, task))
        tasks.sort(key=lambda t: -t[0])

        total = Resource()
        count = 0
        for _, task in tasks:
            for _ in range(task.replicas):
                if count >= job.spec.min_available:
                    break
                count += 1
                for c in task.template.spec.containers:
                    requests = (c.resources or {}).get("requests") or {}
                    total.add(Resource.from_resource_list(requests))
        out: Dict[str, object] = {}
        if total.milli_cpu:
            out["cpu"] = f"{int(total.milli_cpu)}m"
        if total.memory:
            out["memory"] = str(int(total.memory))
        for name, v in total.scalars.items():
            out[name] = f"{int(v)}m"
        return out

    def _create_pod_group_if_not_exist(self, job: batch.Job) -> None:
        """actions.go:423-458."""
        if self.vc.get_pod_group(job.metadata.namespace, job.metadata.name) is not None:
            return
        pg = scheduling.PodGroup(
            metadata=core.ObjectMeta(
                name=job.metadata.name,
                namespace=job.metadata.namespace,
                annotations=dict(job.metadata.annotations),
                owner_references=[
                    core.OwnerReference(
                        kind="Job", name=job.metadata.name, uid=job.metadata.uid, controller=True
                    )
                ],
            ),
            spec=scheduling.PodGroupSpec(
                min_member=job.spec.min_available,
                queue=job.spec.queue,
                min_resources=self._calc_pg_min_resources(job),
                priority_class_name=job.spec.priority_class_name,
            ),
        )
        try:
            self.vc.create_pod_group(pg)
        except AlreadyExistsError:
            pass

    def _create_job(self, job: batch.Job) -> batch.Job:
        job = self._init_job_status(job)
        self.plugin_on_job_add(job)
        job = self._create_job_io_if_not_exist(job)
        self._create_pod_group_if_not_exist(job)
        return job

    def sync_job(self, job_info: JobInfo, update_status) -> None:
        """actions.go:175-334."""
        job = job_info.job.clone()
        if job.metadata.deletion_timestamp is not None:
            return
        job = self._create_job(job)

        counts = {"pending": 0, "running": 0, "succeeded": 0, "failed": 0, "unknown": 0}
        terminating = 0
        pod_to_create: List[core.Pod] = []
        pod_to_delete: List[core.Pod] = []

        for ts in job.spec.tasks:
            task_name = ts.name or batch.DEFAULT_TASK_SPEC
            pods = dict(job_info.pods.get(task_name, {}))
            for i in range(ts.replicas):
                pod_name = make_pod_name(job.metadata.name, task_name, i)
                pod = pods.pop(pod_name, None)
                if pod is None:
                    new_pod = create_job_pod(job, ts, i)
                    self.plugin_on_pod_create(job, new_pod)
                    pod_to_create.append(new_pod)
                else:
                    if pod.metadata.deletion_timestamp is not None:
                        terminating += 1
                        continue
                    classify_pod(pod, counts)
            pod_to_delete.extend(pods.values())

        for pod in pod_to_create:
            try:
                created = self.kube.create_pod(pod)
                classify_pod(created, counts)
            except AlreadyExistsError:
                pass

        for pod in pod_to_delete:
            try:
                self.kube.delete_pod(pod.metadata.namespace, pod.metadata.name)
                terminating += 1
            except NotFoundError:
                pass

        status = batch.JobStatus(
            state=job.status.state,
            pending=counts["pending"],
            running=counts["running"],
            succeeded=counts["succeeded"],
            failed=counts["failed"],
            terminating=terminating,
            unknown=counts["unknown"],
            version=job.status.version,
            min_available=job.spec.min_available,
            controlled_resources=job.status.controlled_resources,
            retry_count=job.status.retry_count,
        )
        job.status = status
        if update_status is not None:
            import time as _time

            if update_status(job.status):
                job.status.state.last_transition_time = _time.time()
        updated = self._write_status(job)
        self.cache.update(updated)

    def kill_job(self, job_info: JobInfo, pod_retain_phases: Set[str], update_status) -> None:
        """actions.go:39-143."""
        job = job_info.job.clone()
        if job.metadata.deletion_timestamp is not None:
            return

        counts = {"pending": 0, "running": 0, "succeeded": 0, "failed": 0, "unknown": 0}
        terminating = 0
        for pods in job_info.pods.values():
            for pod in pods.values():
                if pod.metadata.deletion_timestamp is not None:
                    terminating += 1
                    continue
                if pod.status.phase not in pod_retain_phases:
                    try:
                        self.kube.delete_pod(pod.metadata.namespace, pod.metadata.name)
                        terminating += 1
                        continue
                    except NotFoundError:
                        pass
                classify_pod(pod, counts)

        # Version bump fences stale pod events (actions.go:92).
        job.status = batch.JobStatus(
            state=job.status.state,
            pending=counts["pending"],
            running=counts["running"],
            succeeded=counts["succeeded"],
            failed=counts["failed"],
            terminating=terminating,
            unknown=counts["unknown"],
            version=job.status.version + 1,
            min_available=job.spec.min_available,
            controlled_resources=job.status.controlled_resources,
            retry_count=job.status.retry_count,
        )
        if update_status is not None:
            import time as _time

            if update_status(job.status):
                job.status.state.last_transition_time = _time.time()
        updated = self._write_status(job)
        self.cache.update(updated)

        # Delete PodGroup (actions.go:128-135).
        try:
            self.vc.delete_pod_group(job.metadata.namespace, job.metadata.name)
        except NotFoundError:
            pass

        self.plugin_on_job_delete(job)
