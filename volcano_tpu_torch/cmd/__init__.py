"""Entry points of the port: the scheduler daemon
(``python -m volcano_tpu_torch.cmd.scheduler``), the API-server daemon
(``python -m volcano_tpu_torch.cmd.apiserver``), the controller manager
(``python -m volcano_tpu_torch.cmd.controllers``), the admission
webhooks (``python -m volcano_tpu_torch.cmd.admission``), the whole
control plane (``python -m volcano_tpu_torch.cmd.local_up``), the
compute-plane sidecar (``python -m volcano_tpu_torch.cmd.compute_plane``)
and the cycle journal tool (``python -m volcano_tpu_torch.cmd.trace``).

The daemon classes are exported lazily, so that the sidecar and the
journal tool start without the scheduler's modules.
"""

import importlib

_DAEMONS = {
    "AdmissionDaemon": "volcano_tpu_torch.cmd.admission",
    "ApiServerDaemon": "volcano_tpu_torch.cmd.apiserver",
    "ControllersDaemon": "volcano_tpu_torch.cmd.controllers",
    "SchedulerDaemon": "volcano_tpu_torch.cmd.scheduler",
}

__all__ = sorted(_DAEMONS)


def __getattr__(name):
    if name in _DAEMONS:
        return getattr(importlib.import_module(_DAEMONS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
