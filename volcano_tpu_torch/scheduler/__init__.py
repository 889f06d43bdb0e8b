"""Scheduler helpers (reference: pkg/scheduler/util).

A copy of ``volcano_tpu/scheduler/__init__.py``.
"""
