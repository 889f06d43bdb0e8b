"""Deterministic, seedable fault-injection plane.

A copy of ``volcano_tpu/faults/plane.py`` for the port: the same spec
grammar, the same per-point decision streams, the same counts.

Every recovery seam carries a *named injection point*
(``device.lowering``, ``device.slow``, ``device.nan``, ...).  A point is
evaluated with ``plane.should(point)``; when the active
:class:`FaultPlane` says it fires, the call site raises / drops / delays
exactly the way the real fault would — through the SAME code path
production takes.  Each point draws from its own ``random.Random``
seeded by ``seed ^ crc32(point)``, so the n-th evaluation of a point
fires identically however evaluations of other points interleave.

Disabled is the default and costs one attribute access: module state
holds a :class:`NullFaultPlane` whose ``enabled`` is False, and hot
paths guard with ``if fp.enabled and fp.should(...)``.

Spec grammar (``VTPU_FAULTS=<spec>``)::

    seed=42;device.lowering=1:count=3;device.slow=1:ms=50:after=3

semicolon-separated clauses; ``seed=<int>`` seeds the streams (default
0); every other clause is ``<point>=<probability>`` with optional
``:key=value`` modifiers:

    count=N   fire at most N times, then never again
    after=N   the first N evaluations never fire
    ms=F      payload for delay/slow points (milliseconds)

Every firing counts in ``volcano_faults_injected_total{point}``
(volcano_tpu_torch/metrics/__init__.py).  The JAX package also journals each
firing in its trace recorder; the port has no trace recorder yet.
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics, trace


class FaultRule:
    """One parsed clause: fire with ``probability`` at ``point``."""

    __slots__ = ("point", "probability", "count", "after", "ms")

    def __init__(
        self,
        point: str,
        probability: float,
        count: Optional[int] = None,
        after: int = 0,
        ms: float = 0.0,
    ):
        if not (0.0 <= probability <= 1.0):
            raise ValueError(
                f"fault probability for {point!r} must be in [0, 1], "
                f"got {probability}"
            )
        if count is not None and count < 0:
            raise ValueError(f"fault count for {point!r} must be >= 0")
        if after < 0:
            raise ValueError(f"fault after for {point!r} must be >= 0")
        self.point = point
        self.probability = probability
        self.count = count
        self.after = after
        self.ms = ms

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultRule) and (
            (self.point, self.probability, self.count, self.after, self.ms)
            == (other.point, other.probability, other.count, other.after,
                other.ms)
        )

    def __repr__(self) -> str:  # debugging aid
        return f"FaultRule({self.format()!r})"

    def format(self) -> str:
        """The spec clause this rule round-trips to."""
        out = f"{self.point}={self.probability:g}"
        if self.count is not None:
            out += f":count={self.count}"
        if self.after:
            out += f":after={self.after}"
        if self.ms:
            out += f":ms={self.ms:g}"
        return out


class FaultSpec:
    """Parsed ``VTPU_FAULTS`` value: a seed plus per-point rules."""

    def __init__(self, seed: int = 0, rules: Optional[List[FaultRule]] = None):
        self.seed = seed
        self.rules: Dict[str, FaultRule] = {}
        for rule in rules or []:
            if rule.point in self.rules:
                raise ValueError(f"duplicate fault point {rule.point!r}")
            self.rules[rule.point] = rule

    def format(self) -> str:
        parts = [f"seed={self.seed}"]
        parts.extend(r.format() for r in self.rules.values())
        return ";".join(parts)

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultSpec) and (
            self.seed == other.seed and self.rules == other.rules
        )


def parse_faults(spec: str) -> FaultSpec:
    """``"seed=42;bus.disconnect=0.05:count=2"`` → :class:`FaultSpec`.
    Raises ``ValueError`` on malformed clauses — a daemon started with a
    typo'd schedule must fail loudly, not run a different chaos plan."""
    seed = 0
    rules: List[FaultRule] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        head, _, mods = clause.partition(":")
        if "=" not in head:
            raise ValueError(f"malformed fault clause {clause!r}")
        point, _, value = head.partition("=")
        point = point.strip()
        if point == "seed":
            if mods:
                # 'seed=42:count=2' (or a ':'-for-';' typo gluing a
                # whole clause on) must not silently run a different
                # chaos plan
                raise ValueError(
                    f"seed clause takes no modifiers: {clause!r}"
                )
            seed = int(value)
            continue
        kwargs = {"count": None, "after": 0, "ms": 0.0}
        if mods:
            for mod in mods.split(":"):
                if "=" not in mod:
                    raise ValueError(f"malformed fault modifier {mod!r}")
                k, _, v = mod.partition("=")
                k = k.strip()
                if k == "count":
                    kwargs["count"] = int(v)
                elif k == "after":
                    kwargs["after"] = int(v)
                elif k == "ms":
                    kwargs["ms"] = float(v)
                else:
                    raise ValueError(f"unknown fault modifier {k!r}")
        rules.append(FaultRule(point, float(value), **kwargs))
    return FaultSpec(seed=seed, rules=rules)


class NullFaultPlane:
    """Disabled default — every method a constant, no per-call state."""

    enabled = False

    def should(self, point: str) -> bool:
        return False

    def param_ms(self, point: str) -> float:
        return 0.0

    def fired(self) -> Dict[str, int]:
        return {}


class _PointState:
    __slots__ = ("rng", "evals", "fires")

    def __init__(self, rng):
        self.rng = rng
        self.evals = 0
        self.fires = 0


class FaultPlane:
    """Active plane: deterministic per-point decision streams.

    Thread-safe — seams are evaluated from reader/writer/effect threads.
    The per-point lock serializes the (counter, rng) advance so the n-th
    evaluation of a point is the same decision in every run with the
    same seed; cross-point interleaving cannot perturb it because the
    streams are independent."""

    enabled = True

    def __init__(self, spec: FaultSpec):
        import random

        self.spec = spec
        self._lock = threading.Lock()
        # populated under the lock: a plane installed by configure()
        # while another thread's get_plane() already returned it (the
        # fast path reads _plane unlocked) must publish the dict through
        # the same lock should() reads it under — unsynchronized
        # construction was the first real race the happens-before
        # detector caught
        with self._lock:
            self._points: Dict[str, _PointState] = {}  # guarded-by: self._lock
            for point in spec.rules:
                # crc32 keeps the per-point seed stable across runs and
                # Python processes (hash() is salted per-process)
                derived = spec.seed ^ zlib.crc32(point.encode())
                self._points[point] = _PointState(random.Random(derived))

    def should(self, point: str) -> bool:
        """Evaluate ``point``; True = the seam must inject its fault.
        Each firing counts in ``volcano_faults_injected_total``."""
        rule = self.spec.rules.get(point)
        if rule is None:
            return False
        with self._lock:
            st = self._points[point]
            st.evals += 1
            # the draw advances the stream on EVERY evaluation — a
            # count/after-suppressed evaluation must consume its sample,
            # or exhausting one rule would shift later decisions
            draw = st.rng.random()
            if st.evals <= rule.after:
                return False
            if rule.count is not None and st.fires >= rule.count:
                return False
            fire = draw < rule.probability
            if fire:
                st.fires += 1
                n = st.fires
        if fire:
            metrics.register_fault_injected(point)
            rec = trace.get_recorder()
            if rec.enabled:
                rec.event("fault:" + point, "fault", n=n)
        return fire

    def param_ms(self, point: str) -> float:
        rule = self.spec.rules.get(point)
        return rule.ms if rule is not None else 0.0

    def fired(self) -> Dict[str, int]:
        """point → times fired so far (chaos-run accounting)."""
        with self._lock:
            return {p: st.fires for p, st in self._points.items() if st.fires}


_NULL = NullFaultPlane()
_plane = None  # resolved lazily from VTPU_FAULTS on first get_plane()
_plane_lock = threading.Lock()


def configure(spec: Optional[str]) -> None:
    """Install a fault plane from a spec string; ``None``/empty
    explicitly disables (including a VTPU_FAULTS env setting)."""
    global _plane
    with _plane_lock:
        _plane = FaultPlane(parse_faults(spec)) if spec else _NULL


def get_plane():
    """The active plane (Null by default).  The first call resolves
    ``VTPU_FAULTS`` from the environment."""
    global _plane
    if _plane is None:
        with _plane_lock:
            if _plane is None:
                env = os.environ.get("VTPU_FAULTS", "")
                _plane = FaultPlane(parse_faults(env)) if env else _NULL
    return _plane
