"""The in-process API server and the typed clients over it: the store
the scheduler cache fills from and commits into (a copy of
``volcano_tpu/client``)."""

from volcano_tpu_torch.client.apiserver import (
    ADDED,
    MODIFIED,
    DELETED,
    AdmissionError,
    AlreadyExistsError,
    APIServer,
    ApiError,
    ConflictError,
    NotFoundError,
)
from volcano_tpu_torch.client.clients import KubeClient, SchedulerClient, VolcanoClient

__all__ = [
    "ADDED",
    "MODIFIED",
    "DELETED",
    "AdmissionError",
    "AlreadyExistsError",
    "APIServer",
    "ApiError",
    "ConflictError",
    "NotFoundError",
    "KubeClient",
    "SchedulerClient",
    "VolcanoClient",
]
