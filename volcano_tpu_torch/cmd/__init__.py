"""Entry points of the port: the scheduler daemon
(``python -m volcano_tpu_torch.cmd.scheduler``), the API-server daemon
(``python -m volcano_tpu_torch.cmd.apiserver``), the compute-plane
sidecar (``python -m volcano_tpu_torch.cmd.compute_plane``) and the
cycle journal tool (``python -m volcano_tpu_torch.cmd.trace``).  The
controllers and admission daemons of ``volcano_tpu/cmd`` are not
present in the port.

``SchedulerDaemon`` and ``ApiServerDaemon`` are exported lazily, so
that the sidecar and the journal tool start without the scheduler's
modules.
"""

__all__ = ["ApiServerDaemon", "SchedulerDaemon"]


def __getattr__(name):
    if name == "SchedulerDaemon":
        from volcano_tpu_torch.cmd.scheduler import SchedulerDaemon

        return SchedulerDaemon
    if name == "ApiServerDaemon":
        from volcano_tpu_torch.cmd.apiserver import ApiServerDaemon

        return ApiServerDaemon
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
