"""Protocol-frontend family table: the names of the reference's
``policy/compiler/frontends`` registry, with the same values.

The loader keys its per-identity family fingerprints by these names
(``runtime/loader._identity_family_tuples``), so the port's
``PolicyDelta`` equals the reference's only when the name sets are
equal. The frontends themselves — lowering an ``l7proto`` rule onto the
``l7g`` banked automaton — arrive with the frontends slice (queue 1,
Q5); compiling such a rule raises ``NotImplementedError`` in
``engine/compiled.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

#: family ids the 3-bit provenance-word field can carry
MAX_FAMILY = 7

#: the reference's registered frontends: (l7proto, family id, family
#: name) — cassandra.py, memcached.py, r2d2.py
_FRONTENDS: Tuple[Tuple[str, int, str], ...] = (
    ("cassandra", 5, "cassandra"),
    ("memcache", 6, "memcache"),
    ("r2d2", 7, "r2d2"),
)

#: the registered frontend protos
PROTOS: Tuple[str, ...] = tuple(name for name, _, _ in _FRONTENDS)


def family_of(proto: str) -> int:
    """Engine family id of a frontend ``l7proto`` (0 = not a
    frontend — the record stays on the generic pair path)."""
    for name, family, _ in _FRONTENDS:
        if name == proto:
            return family
    return 0


def family_name_of(proto: str) -> Optional[str]:
    for name, _, family_name in _FRONTENDS:
        if name == proto:
            return family_name
    return None


def family_names() -> Dict[int, str]:
    """family id → memo/delta family name, every registered
    frontend."""
    return {family: family_name for _, family, family_name in _FRONTENDS}
