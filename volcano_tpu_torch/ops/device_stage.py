"""Device-resident session planes with delta staging.

The port of ``volcano_tpu/ops/device_stage.py``.  The warm packer
(ops/pack_cache.py) knows exactly which rows of which planes changed
since the previous cycle; this module keeps the previous cycle's planes
resident on the kernel's device and applies those deltas with
``buf.index_copy_(0, rows, vals)`` instead of re-shipping full arrays.
A full put copies from pinned host memory with ``non_blocking=True``, so
gpu-allocate stages the dynamic node planes here *before* its ORDER
phase and the transfer runs while ORDER runs on the host (the "relay
overlap" of the warm cycle).

The session kernel (ops/session_kernel.run_packed_cuda) builds its node
operands — ``nd``, the class-feasibility matrix and the class lists —
from the staged planes through ``PackedSnapshot.device_planes``; for a
snapshot no packer staged it makes one full put with a stager of its
own.  That is the one consumer, so the reference's
``device_plane`` (a staged plane or else the numpy one) has no caller
here and is left out.  The task planes are not staged: the kernel's task
rows carry a feasibility-class column computed on the host each
session, so they travel with the session.

The reference pads each scatter to a power-of-two row bucket so that
XLA compiles one scatter per bucket rather than per dirty-row count.
PyTorch compiles nothing per shape, so the port's ``index_copy_`` takes
the dirty rows as they are.

A uint32 bit plane is resident as an int32 tensor holding the same bits
(``ops.kernels.as_tensor``'s convention); :func:`fetch_plane` gives it
back with the numpy plane's dtype.

Safety contract: the packer never mutates a plane array after handing
it to ``prestage``/``stage`` (each pack assembles fresh arrays), so an
asynchronous host→device read can never observe a torn write.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

#: planes mirrored on the device: every node plane the session kernel's
#: node operands are built from, and the job and tolerance planes its
#: gang fixpoint reads
STAGED_PLANES = (
    "task_job",
    "node_idle",
    "node_used",
    "node_alloc",
    "node_label_bits",
    "node_taint_bits",
    "node_ok",
    "node_task_count",
    "node_max_tasks",
    "job_min_available",
    "job_ready_count",
    "tolerance",
)

#: dynamic node planes safe to stage before the task pass (nothing in
#: the task pass can change them — label back-patching only touches
#: node_label_bits, which is deliberately NOT in this set)
PRESTAGE_PLANES = ("node_idle", "node_used", "node_task_count", "node_ok")


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A plane as a CPU tensor (a uint32 plane as int32 with the same
    bits)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr)


def fetch_plane(buf: torch.Tensor, like: np.ndarray) -> np.ndarray:
    """A staged plane back on the host, with ``like``'s dtype."""
    out = buf.cpu().numpy()
    return out.view(like.dtype) if out.dtype != like.dtype else out


class DeviceStager:
    """Per-PackCache device mirror of the staged planes."""

    def __init__(self, cache_key: str, device: torch.device):
        self.cache_key = cache_key
        self.device = torch.device(device)
        self.bufs: Dict[str, torch.Tensor] = {}
        self.plane_rev: Dict[str, int] = {}
        #: host→device bytes since the last :meth:`take_bytes`
        self.h2d_bytes = 0

    def take_bytes(self) -> int:
        """The host→device bytes moved since the last call."""
        n, self.h2d_bytes = self.h2d_bytes, 0
        return n

    def _ship(self, host: torch.Tensor) -> torch.Tensor:
        self.h2d_bytes += host.numel() * host.element_size()
        if self.device.type == "cpu":
            return host.clone()
        return host.pin_memory().to(self.device, non_blocking=True)

    def _put(self, name: str, arr: np.ndarray, rev: int) -> torch.Tensor:
        buf = self._ship(_host_tensor(arr))
        self.bufs[name] = buf
        self.plane_rev[name] = rev
        return buf

    def _scatter(self, name: str, buf: torch.Tensor, arr: np.ndarray,
                 rows: np.ndarray, rev: int) -> torch.Tensor:
        idx = self._ship(torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64)))
        vals = self._ship(_host_tensor(arr[rows]))
        buf.index_copy_(0, idx, vals)
        self.plane_rev[name] = rev
        return buf

    def _resident(self, name: str, arr: np.ndarray) -> Optional[torch.Tensor]:
        """The resident buffer of ``name`` where its shape and dtype can
        hold ``arr``."""
        buf = self.bufs.get(name)
        if buf is None or tuple(buf.shape) != arr.shape:
            return None
        if buf.dtype != _host_tensor(arr[:0]).dtype:
            return None
        return buf

    def _apply(self, name: str, arr: np.ndarray, delta, rev: int) -> torch.Tensor:
        """Bring plane ``name`` to revision ``rev`` (content ``arr``)."""
        buf = self._resident(name, arr)
        if buf is not None and self.plane_rev.get(name) == rev:
            return buf  # already staged this revision (prestage)
        if (
            delta is not None
            and buf is not None
            and self.plane_rev.get(name) == delta.base_rev
        ):
            if name not in delta.planes:
                self.plane_rev[name] = rev
                return buf  # byte-identical to the previous revision
            rows = delta.planes[name]
            if rows is not None:
                if rows.size:
                    return self._scatter(name, buf, arr, rows, rev)
                self.plane_rev[name] = rev  # zero-row delta — nothing moved
                return buf
        return self._put(name, arr, rev)

    def prestage(self, planes: Dict[str, np.ndarray], delta_rows, rev: int) -> None:
        """Start staging the dynamic node planes (called before ORDER).
        ``delta_rows`` is the dirty-node row index array — copied in
        with ``index_copy_`` when the resident buffers are at
        ``rev - 1``."""
        for name in PRESTAGE_PLANES:
            arr = planes.get(name)
            if arr is None:
                continue
            buf = self._resident(name, arr)
            if buf is not None and self.plane_rev.get(name) == rev - 1:
                if delta_rows is not None and delta_rows.size:
                    self._scatter(name, buf, arr, delta_rows, rev)
                self.plane_rev[name] = rev
            else:
                self._put(name, arr, rev)

    def stage(self, snap) -> Dict[str, torch.Tensor]:
        """Bring every staged plane to ``snap.rev``; returns the device
        plane dict to attach as ``snap.device_planes``."""
        delta = snap.delta
        if delta is None:
            # cold / wholesale pack — any prestaged revision stamps are
            # meaningless, restage everything
            self.bufs.clear()
            self.plane_rev.clear()
        out = {}
        for name in STAGED_PLANES:
            arr = getattr(snap, name)
            if arr is None:
                continue
            out[name] = self._apply(name, arr, delta, snap.rev)
        return out


_stagers: Dict[str, DeviceStager] = {}


def get_stager(cache_key: str, device) -> DeviceStager:
    """Process-level stager registry, one per PackCache and device,
    bounded."""
    key = f"{cache_key}@{torch.device(device)}"
    st = _stagers.get(key)
    if st is None:
        if len(_stagers) >= 8:  # caches come and go in tests — bound memory
            _stagers.pop(next(iter(_stagers)))
        st = _stagers[key] = DeviceStager(cache_key, device)
    return st
