"""Action registry — mirrors the blank-import registration in
cmd/scheduler/main.go:36-38.

The port's actions: the host ``allocate`` and ``gpu-allocate``, whose
KERNEL phase runs the CUDA session kernel."""

from volcano_tpu_torch.framework.interface import register_action

from volcano_tpu_torch.actions import allocate, gpu_allocate


def register_all() -> None:
    register_action(allocate.new())
    register_action(gpu_allocate.new())


register_all()
