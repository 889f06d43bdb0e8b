"""Deterministic re-execution of recorded cycles.

The port of ``volcano_tpu/trace/replay.py`` over the port's executors.
``verify()`` loads a captured PackedSnapshot from the journal, re-runs
it through a chosen executor, and diffs the resulting assignment
against the recorded one.  All executors share one exact semantics
(ops/dispatch.py module docstring), so any diff is a real regression —
a kernel change that moved bindings, a nondeterministic tie-break, or a
corrupted capture.

Executors (the caller chooses; the executor recorded in the journal —
the port's or the JAX package's ``pallas``/``xla-scan``/``jax`` — is
only a label):

  * ``cuda``       — the CUDA session kernel (ops/session_kernel.
                     run_packed_cuda).  A loaded snapshot carries no
                     staged planes, so the session takes one full put.
  * ``torch-scan`` — the PyTorch specification (ops/kernels.run_packed).
  * ``blocked``    — the blocked formulation (ops/blocked.py).
  * ``sharded``    — the node-sharded blocked formulation
                     (ops/sharded.py): one shard on each visible GPU,
                     or one shard on ``device`` where the caller names
                     one.
  * ``native``     — the C++ host baseline (volcano_tpu_torch.native),
                     default weights only; a failed build raises.
  * ``auto``       — whatever ops/dispatch.select_executor picks for
                     ``device``.

Every executor but ``native`` and ``sharded`` runs on ``device``: the
card unless the caller names another.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

EXECUTORS = ("cuda", "torch-scan", "blocked", "sharded", "native", "auto")


@dataclass
class ReplayResult:
    cycle: int
    executor: str
    recorded_executor: str
    n_tasks: int
    n_placed_recorded: int
    n_placed_replayed: int
    n_diffs: int
    #: (task index, recorded node index, replayed node index) per mismatch
    diffs: List[Tuple[int, int, int]] = field(default_factory=list)

    @property
    def match(self) -> bool:
        return self.n_diffs == 0

    def summary(self) -> str:
        verdict = "IDENTICAL" if self.match else f"{self.n_diffs} DIFFS"
        return (
            f"cycle {self.cycle}: recorded[{self.recorded_executor}] vs "
            f"replayed[{self.executor}] over {self.n_tasks} tasks "
            f"({self.n_placed_recorded}/{self.n_placed_replayed} placed): "
            f"{verdict}"
        )


def run_snapshot(snap, executor: str = "cuda", weights=None, gang_rounds: int = 3,
                 device=None):
    """PackedSnapshot → assignment[T] through the named executor."""
    from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS

    weights = weights or DEFAULT_WEIGHTS
    if executor == "native":
        from volcano_tpu_torch import native

        if weights != DEFAULT_WEIGHTS:
            # silently dropping the recorded weights would turn every
            # diff into a spurious "kernel regression" verdict
            raise RuntimeError(
                "native executor scores with DEFAULT_WEIGHTS only; this "
                "capture recorded non-default weights — replay it with "
                "the cuda/torch-scan/blocked executor instead"
            )
        return native.baseline_allocate(snap, gang_rounds=gang_rounds)
    if executor == "cuda":
        from volcano_tpu_torch.ops.session_kernel import run_packed_cuda

        return run_packed_cuda(snap, weights=weights, gang_rounds=gang_rounds, device=device)
    if executor == "torch-scan":
        from volcano_tpu_torch.ops.kernels import run_packed

        return run_packed(snap, weights=weights, gang_rounds=gang_rounds, device=device)
    if executor == "blocked":
        from volcano_tpu_torch.ops.blocked import run_packed_blocked

        return run_packed_blocked(snap, weights=weights, gang_rounds=gang_rounds,
                                  device=device)
    if executor == "sharded":
        from volcano_tpu_torch.ops.sharded import run_packed_sharded

        return run_packed_sharded(snap, devices=None if device is None else [device],
                                  weights=weights, gang_rounds=gang_rounds)
    if executor == "auto":
        from volcano_tpu_torch.ops.dispatch import run_packed_auto

        return run_packed_auto(snap, weights=weights, gang_rounds=gang_rounds, device=device)
    raise ValueError(f"unknown executor {executor!r}; expected one of {EXECUTORS}")


def _as_journal(journal):
    from volcano_tpu_torch.trace.journal import Journal

    if isinstance(journal, str):
        return Journal(journal)
    return journal


def replay(
    journal, cycle: Optional[int] = None, executor: str = "cuda", device=None,
) -> ReplayResult:
    """Re-run a recorded cycle's snapshot and diff against its recorded
    assignment.  ``journal`` is a Journal or a directory path; ``cycle``
    defaults to the newest cycle with a snapshot."""
    journal = _as_journal(journal)
    if cycle is None:
        snaps = journal.snapshot_cycles()
        if not snaps:
            raise FileNotFoundError(
                f"no snapshot captures in journal {journal.root!r} "
                "(was the recorder's snapshot_every knob set?)"
            )
        cycle = snaps[-1]
    snap, extras = journal.read_snapshot(cycle)
    recorded = np.asarray(extras["assignment"], dtype=np.int64)
    # re-run with the kernel parameters the capture recorded (older
    # journals without them fall back to the defaults)
    weights = None
    if "weights" in extras:
        from volcano_tpu_torch.ops.kernels import ScoreWeights

        lanes = [float(v) for v in np.asarray(extras["weights"]).ravel()]
        if len(lanes) == len(ScoreWeights._fields):
            weights = ScoreWeights(*lanes[:-1], lr_int_exact=bool(lanes[-1]))
        else:
            # a diff produced under substituted weights is NOT a kernel
            # regression — without this warning it would read as one
            warnings.warn(
                f"journal cycle {cycle}: recorded {len(lanes)} weight "
                f"lanes but ScoreWeights now has "
                f"{len(ScoreWeights._fields)} fields; replaying with "
                "DEFAULT_WEIGHTS — binding diffs may reflect the weight "
                "substitution, not a kernel regression",
                RuntimeWarning,
                stacklevel=2,
            )
    gang_rounds = int(extras.get("gang_rounds", 3))
    replayed = np.asarray(
        run_snapshot(
            snap, executor=executor, weights=weights, gang_rounds=gang_rounds,
            device=device,
        ),
        dtype=np.int64,
    )

    n = snap.n_tasks
    rec_n, rep_n = recorded[:n], replayed[:n]
    mismatch = np.nonzero(rec_n != rep_n)[0]
    return ReplayResult(
        cycle=cycle,
        executor=executor,
        recorded_executor=extras.get("executor", ""),
        n_tasks=n,
        n_placed_recorded=int((rec_n >= 0).sum()),
        n_placed_replayed=int((rep_n >= 0).sum()),
        n_diffs=len(mismatch),
        diffs=[(int(i), int(rec_n[i]), int(rep_n[i])) for i in mismatch],
    )


def verify(
    journal, cycle: Optional[int] = None, executor: str = "cuda", device=None,
) -> ReplayResult:
    """The first-class ``identical_bindings`` check: replay and return the
    diff result (``result.match`` is the old boolean)."""
    return replay(journal, cycle=cycle, executor=executor, device=device)
