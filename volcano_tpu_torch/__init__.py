"""PyTorch + CUDA port of volcano-tpu's device compute core.

The allocate session and the preempt pass run on an NVIDIA GPU through
hand-written CUDA kernels (``csrc/session_kernel.cu``,
``csrc/preempt_kernel.cu``), held bit for bit against the JAX package's
kernels.  A kernel that fails raises; nothing runs in its place
(``ops/dispatch.py``, with its breakers and fault points in ``faults``
and ``metrics``).  The package imports no JAX and nothing of ``volcano_tpu``; it
keeps its own copies of the numpy-only modules it needs.

Entry points: ``volcano_tpu_torch.ops.executor.execute_allocate`` and
``execute_preempt``.  They run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
