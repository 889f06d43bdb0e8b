"""Scheduler framework: session lifecycle, plugin/action registries,
statement transactions.

A copy of ``volcano_tpu/framework/__init__.py``.

Reference: pkg/scheduler/framework.
"""

from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.events import Event, EventHandler
from volcano_tpu_torch.framework.framework import open_session, close_session
from volcano_tpu_torch.framework.interface import (
    Action,
    Plugin,
    PluginBuilder,
    get_action,
    get_plugin_builder,
    register_action,
    register_plugin_builder,
)
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.framework.statement import Statement

__all__ = [
    "Arguments",
    "Event",
    "EventHandler",
    "open_session",
    "close_session",
    "Action",
    "Plugin",
    "PluginBuilder",
    "get_action",
    "get_plugin_builder",
    "register_action",
    "register_plugin_builder",
    "Session",
    "Statement",
]
