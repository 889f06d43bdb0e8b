"""Scheduler policy configuration.

A copy of the dataclasses of ``volcano_tpu/conf/__init__.py``.

Reference: pkg/scheduler/conf/scheduler_conf.go (schema),
pkg/scheduler/plugins/defaults.go (per-plugin flag defaults),
pkg/scheduler/util.go:31-42 (default configuration).

The policy's objects (a tier of plugin options, per-action arguments)
that ``open_session`` takes; the YAML loader and the default policy
document are not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from volcano_tpu_torch.framework.arguments import Arguments


@dataclass
class PluginOption:
    """One plugin entry in a tier (scheduler_conf.go:31-58).

    Flags default to enabled, mirroring applyPluginConfDefaults
    (plugins/defaults.go:22-55); YAML may disable any of them.
    """

    name: str = ""
    enabled_job_order: bool = True
    enabled_namespace_order: bool = True
    enabled_job_ready: bool = True
    enabled_job_pipelined: bool = True
    enabled_task_order: bool = True
    enabled_preemptable: bool = True
    enabled_reclaimable: bool = True
    enabled_queue_order: bool = True
    enabled_predicate: bool = True
    enabled_node_order: bool = True
    arguments: Arguments = field(default_factory=Arguments)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class Configuration:
    """Per-action arguments (scheduler_conf.go:60-68)."""

    name: str = ""
    arguments: Arguments = field(default_factory=Arguments)
