"""Entry points of the port: the compute-plane sidecar
(``python -m volcano_tpu_torch.cmd.compute_plane``).  The scheduler,
controllers and admission daemons of ``volcano_tpu/cmd`` are not
present in the port yet: they need the API client and the bus.
"""
