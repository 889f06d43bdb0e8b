"""Action/Plugin interfaces and their registries.

A copy of ``volcano_tpu/framework/interface.py``.

Reference: pkg/scheduler/framework/interface.go:20-41 (interfaces),
pkg/scheduler/framework/plugins.go:30-66 (registries).
"""

from __future__ import annotations

import abc
import threading
from typing import Callable, Dict, Optional, TYPE_CHECKING

from volcano_tpu_torch.framework.arguments import Arguments

if TYPE_CHECKING:
    from volcano_tpu_torch.framework.session import Session


class Action(abc.ABC):
    """One pass of the scheduling cycle (interface.go:20-32)."""

    @abc.abstractmethod
    def name(self) -> str: ...

    def initialize(self) -> None:
        pass

    @abc.abstractmethod
    def execute(self, ssn: "Session") -> None: ...

    def un_initialize(self) -> None:
        pass


class Plugin(abc.ABC):
    """Policy provider registering callbacks on session open (interface.go:35-41)."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def on_session_open(self, ssn: "Session") -> None: ...

    def on_session_close(self, ssn: "Session") -> None:
        pass


PluginBuilder = Callable[[Arguments], Plugin]

_plugin_mutex = threading.Lock()
_plugin_builders: Dict[str, PluginBuilder] = {}
_action_map: Dict[str, Action] = {}


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    """plugins.go:30-37."""
    with _plugin_mutex:
        _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[PluginBuilder]:
    with _plugin_mutex:
        return _plugin_builders.get(name)


def register_action(action: Action) -> None:
    """plugins.go:58-66."""
    with _plugin_mutex:
        _action_map[action.name()] = action


def get_action(name: str) -> Optional[Action]:
    with _plugin_mutex:
        return _action_map.get(name)
