"""API definitions (reference: pkg/apis/{batch,bus,scheduling} + core k8s types).

A copy of ``volcano_tpu/apis/__init__.py``.

Self-contained typed object model: core Kubernetes objects (Pod, Node, ...),
the batch Job CRD with lifecycle policies, scheduling PodGroup/Queue, and the
bus Command channel.  Everything is a plain dataclass with ``to_dict`` /
``from_dict`` so objects round-trip through YAML/JSON for the CLI and the
in-memory API server.
"""
