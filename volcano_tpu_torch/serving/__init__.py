"""Serving surface of the port: the compute-plane sidecar's wire
protocol, server and client (``compute_plane``), the scheduler's HTTP
port — /healthz, Prometheus /metrics, /explain, /debug/stacks
(``http``, ``explain``) — and the ConfigMap-lock leader election the
daemons gate their work loops on (``leader``).
"""

from volcano_tpu_torch.serving.http import ServingServer
from volcano_tpu_torch.serving.leader import LEASE_KEY, LeaderElector

__all__ = ["LEASE_KEY", "LeaderElector", "ServingServer"]
