"""Project-invariant static analysis of the port — the staticcheck /
`go vet` analogue, a copy of ``volcano_tpu/analysis/`` pointed at
``volcano_tpu_torch/``.

The port copied the JAX package's invariants with its code: "guarded by
``self._mutex``", "no wall-clock/RNG in replay-critical paths",
"version-gated VBUS ops", bounded metric labels.  This package checks
them on the port's own tree:

* :mod:`~volcano_tpu_torch.analysis.lock_discipline` — attributes
  declared ``# guarded-by: <lock>`` may only be touched inside a
  ``with <lock>`` scope (or a function annotated
  ``# requires-lock: <lock>``).
* :mod:`~volcano_tpu_torch.analysis.determinism` — replay-critical
  modules (trace/, faults/, ops/, actions/, cache/) must not reach
  wall-clock, unseeded RNG, or order-escaping ``set`` iteration except
  through the explicit ``# det:`` allowlist.
* :mod:`~volcano_tpu_torch.analysis.serde_drift` — every kind in
  ``bus/protocol.py`` has a serde round-trip exemplar, every bus op is
  version-registered (ops past ``MIN_VERSION`` must carry the old-peer
  fallback), and the README's port VBUS version ladder declares the
  current version and names every registered op (SRD005).
* :mod:`~volcano_tpu_torch.analysis.metric_hygiene` — every
  Counter/Histogram label with a non-literal value declares a
  statically bounded vocabulary (docstring ``label ∈ {...}`` or
  ``# label-vocab:``), and every catalog helper in
  ``metrics/__init__.py`` is observed by some product module.

Left out: the reference's ``jit_safety`` pass checks jitted functions
(tracer branches, concretization inside jit, donated buffers), and the
port has no jit, so the pass has nothing to check.  The reference's
interleaving explorer (``explore.py``), which drives the bus's
replication elector, federation's leases and the store's
``txn_commit``, is not ported yet.

Run ``python -m volcano_tpu_torch.analysis`` (or ``vtctl lint``); a
finding not suppressed in the checked-in ``baseline.json`` fails it.

The runtime half is two engines, installed by the port's tests in a
fixture (no environment variable is read):

* :mod:`~volcano_tpu_torch.analysis.lock_order` — the instrumented-lock
  wrapper that records the cross-thread lock-acquisition graph and
  fails on cycles.
* :mod:`~volcano_tpu_torch.analysis.race` — the happens-before race
  detector: vector clocks over the same lock proxies plus thread/queue/
  event sync edges, with every ``# guarded-by:``-declared attribute
  wrapped in a tracking descriptor.
"""

from volcano_tpu_torch.analysis.core import (  # noqa: F401 — public surface
    Baseline,
    Finding,
    SourceFile,
    iter_source_files,
    run_passes,
)

PASSES = ("lock", "det", "serde", "mtr")
