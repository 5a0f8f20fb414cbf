"""r2d2 frontend — the didactic template for writing one.

This file is the whole recipe for putting a proxylib protocol on the
verdict path:

1. **Declare the spec.** The ``name`` must match the proxylib
   ``register_parser`` name (one registry), the ``family`` is a fresh
   L7Type lane (> GENERIC, ≤ 7), and ``fields`` is the closed set of rule keys the
   parser's records can carry — the r2d2 parser emits
   ``{"cmd": ..., "file": ...}``, so those are the only legal rule
   keys and a typo like ``flie:`` fails at compile time instead of
   compiling to a rule nothing matches.

2. **Validate values where the protocol pins them.** r2d2 commands
   are a closed set; a rule for ``cmd: RAED`` could never match a
   parsed record, so reject it loudly. Validation may only *reject* —
   never rewrite a value, or the engine would drift from the CPU
   oracle's exact-match semantics.

3. **Register at import time.** The package imports this module, so
   compiling any policy sees the frontend; the default
   ``lower_rule`` (an exact pattern over the scan field, interned
   pairs for the other fields) is already bit-equal to the oracle,
   so most frontends — this one included — override nothing else.

That's it: banks, rule-signature groups, the fused dispatch lane, the
attribution decode, memo invalidation, and the proxylib routing all
come from the shared machinery keyed off the spec.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from cilium_tpu_torch.policy.api.l7 import SanitizeError
from cilium_tpu_torch.policy.compiler.frontends import (
    FrontendSpec,
    ProtocolFrontend,
    register_frontend,
)

#: the toy protocol's closed command set (proxylib/r2d2.py framing)
COMMANDS = ("READ", "WRITE", "HALT", "RESET")


class R2D2Frontend(ProtocolFrontend):
    spec = FrontendSpec(
        name="r2d2",
        family=7,                  # L7Type.R2D2
        family_name="r2d2",
        fields=("cmd", "file"),
        scan_field="file",
        doc="CRLF line protocol: READ/WRITE <file>, HALT, RESET",
    )

    def validate_rule(self, pairs: Sequence[Tuple[str, str]]) -> None:
        super().validate_rule(pairs)
        for k, v in pairs:
            if k == "cmd" and v and v not in COMMANDS:
                raise SanitizeError(
                    f"l7proto 'r2d2': cmd {v!r} is not one of "
                    f"{COMMANDS} — the parser can never emit it")


register_frontend(R2D2Frontend())
