"""Flag helpers shared by the port's entry points.

Of ``volcano_tpu/cmd/daemon.py`` only ``apply_faults``: the daemon
classes and ``serve_forever`` are not present in the port yet.
"""

from __future__ import annotations

from volcano_tpu_torch import faults


def apply_faults(spec: str) -> None:
    """``--faults`` → the process-global fault plane (a parse error is
    a clean exit: a typo'd schedule must not run a different chaos
    plan).  An empty flag leaves VTPU_FAULTS env resolution intact."""
    if not spec:
        return
    try:
        faults.configure(spec)
    except ValueError as e:
        raise SystemExit(f"--faults: {e}") from e
