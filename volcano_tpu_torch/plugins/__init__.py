"""Plugin registry — mirrors pkg/scheduler/plugins/factory.go:33-46.

A copy of ``volcano_tpu/plugins/__init__.py``.
"""

from volcano_tpu_torch.framework.interface import register_plugin_builder

from volcano_tpu_torch.plugins import (
    binpack,
    conformance,
    drf,
    gang,
    nodeorder,
    predicates,
    priority,
    proportion,
)


def register_all() -> None:
    register_plugin_builder(binpack.PLUGIN_NAME, binpack.new)
    register_plugin_builder(conformance.PLUGIN_NAME, conformance.new)
    register_plugin_builder(drf.PLUGIN_NAME, drf.new)
    register_plugin_builder(gang.PLUGIN_NAME, gang.new)
    register_plugin_builder(nodeorder.PLUGIN_NAME, nodeorder.new)
    register_plugin_builder(predicates.PLUGIN_NAME, predicates.new)
    register_plugin_builder(priority.PLUGIN_NAME, priority.new)
    register_plugin_builder(proportion.PLUGIN_NAME, proportion.new)


register_all()
