"""Action registry — mirrors the blank-import registration in
cmd/scheduler/main.go:36-38.

The port's actions: the host ``enqueue``, ``allocate``, ``backfill``,
``preempt`` and ``reclaim``; ``gpu-allocate`` and ``gpu-preempt``, whose
device phases run the CUDA session and preempt kernels; and
``gpu-reclaim``, the packed reclaim replay (numpy on the host, as in the
reference)."""

from volcano_tpu_torch.framework.interface import register_action

from volcano_tpu_torch.actions import (
    allocate,
    backfill,
    enqueue,
    gpu_allocate,
    gpu_preempt,
    gpu_reclaim,
    preempt,
    reclaim,
)


def register_all() -> None:
    register_action(enqueue.new())
    register_action(allocate.new())
    register_action(backfill.new())
    register_action(preempt.new())
    register_action(reclaim.new())
    register_action(gpu_allocate.new())
    register_action(gpu_preempt.new())
    register_action(gpu_reclaim.new())


register_all()
