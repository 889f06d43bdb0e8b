"""Device session kernels and snapshot packing, in PyTorch and CUDA.

  packing        PackedSnapshot and its npz persistence (numpy)
  synthetic      BASELINE-config snapshot generators (numpy)
  kernels        the PyTorch specification; the ``torch-scan`` executor
  session_kernel the CUDA greedy-scan kernel, its wrapper, plain version
                 and on-device gang fixpoint; the ``cuda`` executor
  dispatch       executor selection + validity gate
  executor       ``execute_allocate``, the entry point

Importing this package builds and loads nothing: the kernel library is
compiled at the first launch (``ops/_build.py``).
"""
