"""Serving surface of the port: the compute-plane sidecar's wire
protocol, server and client (``compute_plane``), and the scheduler's
HTTP port — /healthz, Prometheus /metrics, /explain, /debug/stacks
(``http``, ``explain``).  The reference's ConfigMap-lock leader
election (``volcano_tpu/serving/leader.py``) is not present in the port
yet: it needs the API client.
"""

from volcano_tpu_torch.serving.http import ServingServer

__all__ = ["ServingServer"]
