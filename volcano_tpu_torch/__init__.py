"""PyTorch + CUDA port of volcano-tpu: the allocate scheduling cycle and
the device compute core.

A scheduling cycle runs as in the JAX package: a ``cache.SchedulerCache``
fed with cluster objects, ``framework.open_session`` with the plugins of
``plugins``, the ``gpu-allocate`` action (``actions/gpu_allocate.py``:
ORDER, pack, the session kernel, APPLY) or the host ``allocate``, and
``framework.close_session``; its binds equal the JAX package's pair for
pair.  The allocate session and the preempt pass run on an NVIDIA GPU
through hand-written CUDA kernels (``csrc/session_kernel.cu``,
``csrc/preempt_kernel.cu``), held bit for bit against the JAX package's
kernels.  A kernel that fails raises; nothing runs in its place
(``ops/dispatch.py``, with its breakers and fault points in ``faults``
and ``metrics``).  The package imports no JAX and nothing of
``volcano_tpu``; it keeps its own copies of the modules it needs.

Entry points: ``actions.gpu_allocate.GpuAllocateAction`` for a cycle,
``ops.executor.execute_allocate`` and ``execute_preempt`` for a packed
session, and ``python -m volcano_tpu_torch.cmd.compute_plane`` for the
compute-plane sidecar that serves both kernels to a scheduler process
over the reference's wire (``serving/compute_plane.py``); a scheduler's
HTTP port is ``serving.ServingServer``.  The deployed binaries are
``python -m volcano_tpu_torch.cmd.apiserver`` (the API store served over
the reference's VBUS wire, ``bus/``) and ``python -m
volcano_tpu_torch.cmd.scheduler`` (the scheduler daemon, on an
in-process store or on ``--bus tcp://host:port``, with ConfigMap-lock
leader election, ``serving/leader.py``).  They run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
