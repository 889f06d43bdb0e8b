"""Device session kernels and snapshot packing, in PyTorch and CUDA.

  packing        PackedSnapshot and its npz persistence (numpy)
  synthetic      BASELINE-config session generators (numpy)
  kernels        the PyTorch specification; the ``torch-scan`` executor
  session_kernel the CUDA greedy-scan kernel (shared-memory layout and
                 wide instance), its wrapper, plain version and
                 on-device gang fixpoint; the ``cuda`` executor
  preempt_pack   PreemptPacked and ``preempt_dense``, the preempt pass's
                 PyTorch specification; the ``dense`` executor
  preempt_kernel the CUDA preempt kernel, its wrapper, plain version and
                 host packing; the preempt ``cuda`` executor
  blocked        the reference's blocked formulation as torch ops on a
                 device; on no dispatch path (the kernel takes every
                 session), held against the kernel and the JAX package
  dispatch       executor selection, validity gates, circuit breakers
                 and fault points
  executor       ``execute_allocate`` and ``execute_preempt``, the entry
                 points

Importing this package builds and loads nothing: the kernel library is
compiled at the first launch (``ops/_build.py``).
"""
