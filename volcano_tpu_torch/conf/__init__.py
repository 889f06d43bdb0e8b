"""Scheduler policy configuration.

A copy of ``volcano_tpu/conf/__init__.py``, except that the default
policy names the port's device action (``gpu-allocate`` where the
reference's names the host ``allocate``): the loop runs the session
kernel unless a policy asks for the host.

Reference: pkg/scheduler/conf/scheduler_conf.go (schema),
pkg/scheduler/plugins/defaults.go (per-plugin flag defaults),
pkg/scheduler/util.go:31-42 (default configuration).

The policy is a small YAML document the scheduler loop reloads when it
changes (``scheduler/scheduler.py``):

    actions: "enqueue, gpu-allocate, backfill"
    tiers:
    - plugins:
      - name: priority
      - name: gang
    - plugins:
      - name: drf
      - name: proportion
        arguments:
          some.key: "value"
    configurations:
    - name: enqueue
      arguments:
        overcommit-factor: "1.5"
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

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


@dataclass
class SchedulerConf:
    actions: List[str] = field(default_factory=list)
    tiers: List[Tier] = field(default_factory=list)
    configurations: List[Configuration] = field(default_factory=list)


_FLAG_KEYS = {
    "enableJobOrder": "enabled_job_order",
    "enableNamespaceOrder": "enabled_namespace_order",
    "enableJobReady": "enabled_job_ready",
    "enableJobPipelined": "enabled_job_pipelined",
    "enableTaskOrder": "enabled_task_order",
    "enablePreemptable": "enabled_preemptable",
    "enableReclaimable": "enabled_reclaimable",
    "enableQueueOrder": "enabled_queue_order",
    "enablePredicate": "enabled_predicate",
    "enableNodeOrder": "enabled_node_order",
}


DEFAULT_SCHEDULER_CONF = """
actions: "enqueue, gpu-allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


def load_scheduler_conf(text: str) -> SchedulerConf:
    """Parse the YAML policy document (scheduler.go:89-106, util.go:44-81)."""
    import yaml

    raw = yaml.safe_load(text) or {}
    conf = SchedulerConf()

    actions = raw.get("actions", "")
    conf.actions = [a.strip() for a in actions.split(",") if a.strip()]

    for tier_raw in raw.get("tiers") or []:
        tier = Tier()
        for p in tier_raw.get("plugins") or []:
            opt = PluginOption(name=p.get("name", ""))
            for yaml_key, attr in _FLAG_KEYS.items():
                if yaml_key in p:
                    setattr(opt, attr, bool(p[yaml_key]))
            opt.arguments = Arguments(
                {str(k): str(v) for k, v in (p.get("arguments") or {}).items()}
            )
            tier.plugins.append(opt)
        conf.tiers.append(tier)

    for c in raw.get("configurations") or []:
        conf.configurations.append(
            Configuration(
                name=c.get("name", ""),
                arguments=Arguments(
                    {str(k): str(v) for k, v in (c.get("arguments") or {}).items()}
                ),
            )
        )

    return conf


def default_scheduler_conf() -> SchedulerConf:
    return load_scheduler_conf(DEFAULT_SCHEDULER_CONF)


def get_action_arguments(
    configurations: List[Configuration], action_name: str
) -> Optional[Arguments]:
    """Find an action's argument block (framework/arguments.go GetArgOfActionFromConf)."""
    for c in configurations:
        if c.name == action_name:
            return c.arguments
    return None
