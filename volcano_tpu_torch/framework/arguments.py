"""Typed getters over a string→string argument map.

A copy of ``volcano_tpu/framework/arguments.py``.

Reference: pkg/scheduler/framework/arguments.go:28-97.
"""

from __future__ import annotations

from typing import Dict, List


class Arguments(Dict[str, str]):
    """Plugin/action arguments: a plain string map with typed accessors.

    Getters leave the target untouched on missing/invalid values, mirroring
    the reference's pointer-mutation style but returning the value instead.
    """

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key)
        if v is None or v == "":
            return default
        try:
            return int(str(v).strip())
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        v = self.get(key)
        if v is None or v == "":
            return default
        try:
            return float(str(v).strip())
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool) -> bool:
        v = self.get(key)
        if v is None or v == "":
            return default
        s = str(v).strip().lower()
        if s in ("1", "t", "true", "yes", "y"):
            return True
        if s in ("0", "f", "false", "no", "n"):
            return False
        return default

    def get_list(self, key: str) -> List[str]:
        v = self.get(key)
        if not v:
            return []
        return [item.strip() for item in str(v).split(",") if item.strip()]
