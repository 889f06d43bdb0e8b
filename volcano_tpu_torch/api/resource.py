"""Resource vector arithmetic — the scheduler's unit of account.

A copy of ``volcano_tpu/api/resource.py`` with ``utils/asserts.py``'s
``assertf`` inlined; the same float64 operations in the same order.

Reference: pkg/scheduler/api/resource_info.go.  Host-side this is exact
float64 math identical to the reference; on device the same quantities are
packed as int32 lanes (cpu milli / memory bytes-quantized / scalar milli) by
volcano_tpu_torch/ops/packing.py, where the tolerance thresholds below become integer
comparisons.
"""

from __future__ import annotations

import os
import traceback
from typing import Dict, Iterable, Optional

from volcano_tpu_torch.apis import quantity
from volcano_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Tolerance floors (resource_info.go:70-72): quantities below these are
# treated as zero by IsEmpty/IsZero and as equal by LessEqual.
MIN_MILLI_CPU = 10.0
MIN_MILLI_SCALAR = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"

# ---- env-gated runtime assertions (pkg/scheduler/util/assert) ----
# ``assertf`` logs the violation (with stack) and continues by default;
# VOLCANO_TPU_PANIC_ON_UNEXPECTED=1 turns violations fatal for tests/CI.

ENV_PANIC = "VOLCANO_TPU_PANIC_ON_UNEXPECTED"


def panic_on_unexpected() -> bool:
    return os.environ.get(ENV_PANIC, "").lower() in ("1", "true", "yes")


def assertf(condition: bool, msg: str, *args) -> None:
    """Log-and-continue assertion; fatal when the panic env var is set."""
    if condition:
        return
    rendered = msg % args if args else msg
    if panic_on_unexpected():
        raise AssertionError(rendered)
    log.error("assertion failed: %s\n%s", rendered, "".join(traceback.format_stack(limit=6)))


class Resource:
    """Dense resource vector: milli_cpu + memory + scalar map.

    ``max_task_num`` mirrors the reference's MaxTaskNum: carried for the
    pod-count predicate only, never part of arithmetic
    (resource_info.go:37-39).

    ``readonly`` is the freeze guard for shared-aliased instances
    (TaskInfo resreq/init_resreq are shared across clones, job_info.py):
    once :meth:`freeze` is called, the in-place mutators raise under
    ``__debug__`` so a violation of the documented immutability invariant
    fails loudly instead of silently skewing every snapshot sharing the
    object.  ``clone()`` always yields a mutable copy.
    """

    __slots__ = ("milli_cpu", "memory", "scalars", "max_task_num", "readonly")

    def __init__(
        self,
        milli_cpu: float = 0.0,
        memory: float = 0.0,
        scalars: Optional[Dict[str, float]] = None,
        max_task_num: int = 0,
    ):
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.scalars: Dict[str, float] = dict(scalars) if scalars else {}
        self.max_task_num = max_task_num
        self.readonly = False

    def freeze(self) -> "Resource":
        """Mark shared-immutable; chainable."""
        self.readonly = True
        return self

    def _raise_frozen(self) -> None:
        raise AssertionError(
            "in-place mutation of a frozen (shared-aliased) Resource; "
            "clone() first or REPLACE the owning attribute"
        )

    # ---- constructors ----

    @classmethod
    def from_resource_list(cls, rl: Dict[str, object]) -> "Resource":
        """Build from a k8s ResourceList (resource_info.go:74-93).

        cpu → milli, memory → bytes, pods → max_task_num, scalars → milli.
        """
        r = cls()
        for name, q in (rl or {}).items():
            if name == CPU:
                r.milli_cpu += quantity.milli_value(q)
            elif name == MEMORY:
                r.memory += quantity.int_value(q)
            elif name == PODS:
                r.max_task_num += int(quantity.int_value(q))
            else:
                r.scalars[name] = r.scalars.get(name, 0.0) + quantity.milli_value(q)
        return r

    def clone(self) -> "Resource":
        # __new__ bypass: clone is on the per-task hot path (two clones
        # per placement via TaskInfo.clone) and __init__'s defensive
        # float()/dict() coercions double its cost on already-valid state.
        r = Resource.__new__(Resource)
        r.milli_cpu = self.milli_cpu
        r.memory = self.memory
        r.scalars = dict(self.scalars)
        r.max_task_num = self.max_task_num
        r.readonly = False  # a copy is always mutable
        return r

    # ---- predicates ----

    def is_empty(self) -> bool:
        """All dimensions below the tolerance floor (resource_info.go:96-108)."""
        if not (self.milli_cpu < MIN_MILLI_CPU and self.memory < MIN_MEMORY):
            return False
        return all(v < MIN_MILLI_SCALAR for v in self.scalars.values())

    def is_zero(self, name: str) -> bool:
        if name == CPU:
            return self.milli_cpu < MIN_MILLI_CPU
        if name == MEMORY:
            return self.memory < MIN_MEMORY
        if name not in self.scalars:
            return True
        return self.scalars[name] < MIN_MILLI_SCALAR

    # ---- arithmetic (mutating, chainable — mirrors the Go API) ----

    def add(self, rr: "Resource") -> "Resource":
        if __debug__ and self.readonly:
            self._raise_frozen()
        self.milli_cpu += rr.milli_cpu
        self.memory += rr.memory
        for name, v in rr.scalars.items():
            self.scalars[name] = self.scalars.get(name, 0.0) + v
        return self

    def sub(self, rr: "Resource") -> "Resource":
        """Subtract; asserts sufficiency like the reference
        (resource_info.go:146 via pkg/scheduler/util/assert — log and
        continue by default, fatal under VOLCANO_TPU_PANIC_ON_UNEXPECTED)."""
        assertf(
            rr.less_equal(self),
            "resource is not sufficient to do operation: <%s> sub <%s>",
            self, rr,
        )
        return self.sub_unchecked(rr)

    def sub_unchecked(self, rr: "Resource") -> "Resource":
        """Subtract allowing negative lanes.

        The reference's Sub assert is env-gated and non-fatal by default
        (pkg/scheduler/util/assert); accounting paths (FutureIdle, node
        remove) rely on that leniency, so they use this variant.
        """
        if __debug__ and self.readonly:
            self._raise_frozen()
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        for name, v in rr.scalars.items():
            self.scalars[name] = self.scalars.get(name, 0.0) - v
        return self

    def multi(self, ratio: float) -> "Resource":
        if __debug__ and self.readonly:
            self._raise_frozen()
        self.milli_cpu *= ratio
        self.memory *= ratio
        for name in self.scalars:
            self.scalars[name] *= ratio
        return self

    def set_max(self, rr: "Resource") -> "Resource":
        """Elementwise max in place (resource_info.go:162-187)."""
        if __debug__ and self.readonly:
            self._raise_frozen()
        self.milli_cpu = max(self.milli_cpu, rr.milli_cpu)
        self.memory = max(self.memory, rr.memory)
        for name, v in rr.scalars.items():
            self.scalars[name] = max(self.scalars.get(name, 0.0), v)
        return self

    def fit_delta(self, rr: "Resource") -> "Resource":
        """Available minus requested, with tolerance margins; negative lanes
        mark insufficient resources (resource_info.go:193-213)."""
        if __debug__ and self.readonly:
            self._raise_frozen()
        if rr.milli_cpu > 0:
            self.milli_cpu -= rr.milli_cpu + MIN_MILLI_CPU
        if rr.memory > 0:
            self.memory -= rr.memory + MIN_MEMORY
        for name, v in rr.scalars.items():
            if v > 0:
                self.scalars[name] = self.scalars.get(name, 0.0) - (v + MIN_MILLI_SCALAR)
        return self

    # ---- comparisons ----

    def less(self, rr: "Resource") -> bool:
        """Strictly less on every dimension (resource_info.go:226-264)."""
        if not self.milli_cpu < rr.milli_cpu:
            return False
        if not self.memory < rr.memory:
            return False
        if not self.scalars:
            # Without scalars on the left, right must have meaningful scalars.
            return all(v > MIN_MILLI_SCALAR for v in rr.scalars.values()) if rr.scalars else True
        if not rr.scalars:
            return False
        return all(v < rr.scalars.get(name, 0.0) for name, v in self.scalars.items())

    def less_equal(self, rr: "Resource") -> bool:
        """Less-or-within-tolerance on every dimension (resource_info.go:292-326)."""

        def le(l: float, r: float, diff: float) -> bool:
            return l < r or abs(l - r) < diff

        if not le(self.milli_cpu, rr.milli_cpu, MIN_MILLI_CPU):
            return False
        if not le(self.memory, rr.memory, MIN_MEMORY):
            return False
        for name, v in self.scalars.items():
            if v <= MIN_MILLI_SCALAR:
                continue
            if not le(v, rr.scalars.get(name, 0.0) if rr.scalars else 0.0, MIN_MILLI_SCALAR):
                return False
        return True

    def less_equal_strict(self, rr: "Resource") -> bool:
        """Exact <= on every dimension (resource_info.go:267-289)."""
        if self.milli_cpu > rr.milli_cpu or self.memory > rr.memory:
            return False
        return all(v <= rr.scalars.get(name, 0.0) for name, v in self.scalars.items())

    def diff(self, rr: "Resource"):
        """Return (increased, decreased) vs ``rr`` (resource_info.go:329-361)."""
        inc, dec = Resource(), Resource()
        if self.milli_cpu > rr.milli_cpu:
            inc.milli_cpu = self.milli_cpu - rr.milli_cpu
        else:
            dec.milli_cpu = rr.milli_cpu - self.milli_cpu
        if self.memory > rr.memory:
            inc.memory = self.memory - rr.memory
        else:
            dec.memory = rr.memory - self.memory
        for name, v in self.scalars.items():
            rv = rr.scalars.get(name, 0.0)
            if v > rv:
                inc.scalars[name] = v - rv
            else:
                dec.scalars[name] = rv - v
        return inc, dec

    # ---- access ----

    def get(self, name: str) -> float:
        if name == CPU:
            return self.milli_cpu
        if name == MEMORY:
            return self.memory
        return self.scalars.get(name, 0.0)

    def set_scalar(self, name: str, value: float) -> None:
        if __debug__ and self.readonly:
            self._raise_frozen()
        self.scalars[name] = value

    def resource_names(self) -> Iterable[str]:
        return [CPU, MEMORY, *self.scalars.keys()]

    # ---- misc ----

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Resource)
            and self.milli_cpu == other.milli_cpu
            and self.memory == other.memory
            and {k: v for k, v in self.scalars.items() if v}
            == {k: v for k, v in other.scalars.items() if v}
        )

    def __repr__(self) -> str:
        s = f"cpu {self.milli_cpu:.2f}, memory {self.memory:.2f}"
        for name, v in self.scalars.items():
            s += f", {name} {v:.2f}"
        return s


def empty_resource() -> Resource:
    return Resource()


def min_resource(l: Resource, r: Resource) -> Resource:
    """Elementwise min (reference: pkg/scheduler/plugins/util helpers.Min)."""
    out = Resource(min(l.milli_cpu, r.milli_cpu), min(l.memory, r.memory))
    for name in set(l.scalars) | set(r.scalars):
        out.scalars[name] = min(l.scalars.get(name, 0.0), r.scalars.get(name, 0.0))
    return out


def share(l: float, r: float) -> float:
    """allocated/total with the reference's zero conventions
    (pkg/scheduler/plugins/util/helpers — Share)."""
    if r == 0:
        return 1.0 if l > 0 else 0.0
    return l / r
