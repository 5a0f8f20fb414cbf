"""toFQDNs ``matchPattern`` glob → anchored regex.

Reference semantics (``pkg/fqdn/matchpattern/matchpattern.go``, unverified
path per SURVEY.md): DNS names and patterns are lowercased and normalized
to end with a trailing dot; ``*`` matches zero or more DNS-valid
characters ``[-a-zA-Z0-9_]`` (it does NOT cross label boundaries — no
dots); the lone pattern ``"*"`` is special-cased to match every valid
FQDN; literal dots match only dots; the result is a fully anchored,
case-normalized regex.
"""

from __future__ import annotations

import re

#: The character group a ``*`` expands to (no ``.`` — label-local).
ALLOWED_CHARS_GROUP = "[-a-zA-Z0-9_]"

#: Regex source for the lone ``"*"`` pattern: any valid FQDN
#: (one or more labels, each ending in a dot), or the root ".".
MATCH_ALL_SRC = "(^(" + ALLOWED_CHARS_GROUP + "+[.])+$)|(^[.]$)"

_VALID_PATTERN_RE = re.compile(r"^[-a-zA-Z0-9_.*]+$")
_VALID_NAME_RE = re.compile(r"^[-a-zA-Z0-9_.]+$|^[.]$")


class InvalidPatternError(ValueError):
    pass


def sanitize(pattern: str) -> str:
    """Lowercase + ensure a trailing dot (FQDN canonical form)."""
    p = pattern.strip().lower()
    if p == "*":
        return p
    if not p.endswith("."):
        p += "."
    return p


def sanitize_name(name: str) -> str:
    n = name.strip().lower()
    if not n.endswith("."):
        n += "."
    return n


def validate(pattern: str) -> str:
    p = pattern.strip().lower()
    if not p or not _VALID_PATTERN_RE.match(p):
        raise InvalidPatternError(f"invalid matchPattern {pattern!r}")
    return sanitize(p)


def validate_name(name: str) -> str:
    n = name.strip().lower()
    if not n or not _VALID_NAME_RE.match(n):
        raise InvalidPatternError(f"invalid matchName {name!r}")
    return sanitize_name(n)


def to_regex(pattern: str) -> str:
    """Compile a (validated) matchPattern to an anchored regex source.

    The regex is over the *sanitized* input (lowercased, trailing dot) —
    callers must sanitize names with :func:`sanitize_name` before
    matching.
    """
    p = validate(pattern)
    if p == "*":
        return MATCH_ALL_SRC
    out = ["^"]
    for ch in p:
        if ch == "*":
            out.append(ALLOWED_CHARS_GROUP + "*")
        elif ch == ".":
            out.append("[.]")
        else:
            out.append(re.escape(ch))
    out.append("$")
    return "".join(out)


def name_to_regex(name: str) -> str:
    """Exact matchName → anchored regex (case/trailing-dot normalized)."""
    n = validate_name(name)
    return "^" + "".join("[.]" if c == "." else re.escape(c) for c in n) + "$"
