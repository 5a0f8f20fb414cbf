"""Cassandra CQL frontend: query-action/table + opcode predicates.

The proxylib parser (``proxylib/cassandra.py``) frames CQL native-
protocol requests and emits records ``{"query_action": ...,
"query_table": ...}`` — QUERY/PREPARE bodies parse to a lowercase
action + keyspace-qualified table, EXECUTE/BATCH degrade to
opcode-name records (``query_action: execute|batch|op0x..``), and
handshake opcodes never reach policy. This frontend lowers those
predicates onto the ``l7g`` banked automaton; validation rejects
rules the parser could never satisfy (uppercase actions, unknown
action names) so typos fail at compile time.
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

#: actions the parser's query grammar can emit (plus opcode-name
#: records for prepared-statement traffic)
ACTIONS = ("select", "insert", "update", "delete", "use", "create",
           "drop", "alter", "truncate", "execute", "batch")
_OPCODE_RE = re.compile(r"^op0x[0-9a-f]{1,2}$")


class CassandraFrontend(ProtocolFrontend):
    spec = FrontendSpec(
        name="cassandra",
        family=5,                  # L7Type.CASSANDRA
        family_name="cassandra",
        fields=("query_action", "query_table"),
        scan_field="query_table",
        doc="CQL native protocol: query action/table + opcode records",
    )

    def validate_rule(self, pairs: Sequence[Tuple[str, str]]) -> None:
        super().validate_rule(pairs)
        for k, v in pairs:
            if not v:
                continue          # presence-only constraint
            if k == "query_action" and v not in ACTIONS \
                    and not _OPCODE_RE.match(v):
                raise SanitizeError(
                    f"l7proto 'cassandra': query_action {v!r} is not "
                    f"a parser-emittable action ({ACTIONS} or "
                    f"'op0x..') — actions are lowercase")
            if k == "query_table" and v != v.lower():
                raise SanitizeError(
                    f"l7proto 'cassandra': query_table {v!r} — the "
                    f"parser lowercases table names; write it "
                    f"lowercase or the rule can never match")


register_frontend(CassandraFrontend())
