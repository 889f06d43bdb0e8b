"""Incremental-session plane — cycle-persistent scheduling state.

A copy of ``volcano_tpu/incremental/__init__.py``.  Micro-cycles would
otherwise pay O(total resident jobs) per wake: a full snapshot, a full
plugin-open sweep (proportion/DRF recompute every queue's share from
every JobInfo) and a full job-updater pass, even when only a handful of
jobs have schedulable work.  This package makes a micro-cycle's cost
proportional to schedulable work, not residency:

* :mod:`shares` — ``ShareLedger``: per-queue / per-namespace
  allocated+request totals maintained incrementally by the cache's
  mutation choke point (``SchedulerCache._mark_job``), so
  ``proportion``/``drf`` can seed their session-open state from the
  ledger instead of sweeping every job.
* :mod:`subgraph` — restricted-subgraph session construction: a
  micro-cycle opens over only the jobs with schedulable work plus the
  ledger's share seed (``Scheduler(restricted_sessions=True)``), with a
  shadow full-session cross-check (sampled by ``shadow_every``) where
  any binding divergence fails, and a planted divergence proving the
  checker catches a broken ledger.
"""

from volcano_tpu_torch.incremental.shares import (  # noqa: F401
    QueueShare,
    ShareLedger,
    ShareSeed,
)

# NOTE: :mod:`subgraph` is deliberately NOT imported here.  The cache
# imports ``shares`` (which triggers this package __init__), while
# ``subgraph`` imports the framework — which imports the cache package.
# Importing subgraph at package level would close that cycle.  Consumers
# (scheduler, tests) import ``volcano_tpu_torch.incremental.subgraph``
# directly.
