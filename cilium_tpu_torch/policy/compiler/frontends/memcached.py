"""Memcached frontend: command-class + key predicates.

The proxylib parser (``proxylib/memcached.py``) frames both public
wire protocols (text and 24-byte-header binary) and emits one record
per touched key: ``{"cmd": ..., "key": ...}`` with binary opcodes
mapped onto the text command names, so one rule set covers both
framings. This frontend lowers command-class and key predicates onto
the ``l7g`` banked automaton; validation pins rule commands to the
parser-emittable universe (text commands plus the binary-only
``noop``/``op0x..`` degradations) so a rule for ``cmd: getx`` fails
at compile time.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

from cilium_tpu_torch.policy.api.l7 import SanitizeError
from cilium_tpu_torch.policy.compiler.frontends import (
    FrontendSpec,
    ProtocolFrontend,
    register_frontend,
)

#: the parser-emittable command classes (text grammar + binary-opcode
#: degradations — proxylib/memcached.py tables)
COMMANDS = frozenset({
    "set", "add", "replace", "append", "prepend", "cas",          # storage
    "get", "gets", "gat", "gats",                                 # retrieval
    "delete", "incr", "decr", "touch",                            # single-key
    "stats", "flush_all", "version", "verbosity", "quit", "noop", # admin
})
_OPCODE_RE = re.compile(r"^op0x[0-9a-f]{1,2}$")


class MemcachedFrontend(ProtocolFrontend):
    spec = FrontendSpec(
        name="memcache",
        family=6,                  # L7Type.MEMCACHE
        family_name="memcache",
        fields=("cmd", "key"),
        scan_field="key",
        doc="memcached text+binary protocols: command class + key",
    )

    def validate_rule(self, pairs: Sequence[Tuple[str, str]]) -> None:
        super().validate_rule(pairs)
        for k, v in pairs:
            if k == "cmd" and v and v not in COMMANDS \
                    and not _OPCODE_RE.match(v):
                raise SanitizeError(
                    f"l7proto 'memcache': cmd {v!r} is not a parser-"
                    f"emittable command ({sorted(COMMANDS)} or "
                    f"'op0x..')")


register_frontend(MemcachedFrontend())
