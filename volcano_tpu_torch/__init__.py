"""PyTorch + CUDA port of volcano-tpu's device compute core.

The allocate session runs on an NVIDIA GPU through a hand-written CUDA
greedy-scan kernel (``csrc/session_kernel.cu``), held bit for bit
against the JAX package's kernels.  The package imports no JAX and
nothing of ``volcano_tpu``; it keeps its own copies of the numpy-only
modules it needs.

Entry point: ``volcano_tpu_torch.ops.executor.execute_allocate``.  It
runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
