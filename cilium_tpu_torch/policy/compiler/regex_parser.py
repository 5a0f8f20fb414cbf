"""RE2-subset regex parser → AST over a byte alphabet.

The reference evaluates HTTP rule regexes with RE2 inside Envoy
(SURVEY.md §2.2: "HTTP semantics == RE2 semantics, no backrefs — safe to
compile to finite automata"). This parser accepts the finite-automaton
subset shared by RE2 and Python ``re`` so the compiled automata can be
differentially tested against a Python ``re`` oracle:

* literals, ``.`` (any byte except ``\\n``), escapes (``\\d \\w \\s`` and
  complements, ``\\xHH``, control escapes, escaped punctuation)
* character classes ``[a-z0-9]`` / ``[^...]`` with ranges and escapes
* grouping ``(...)`` / ``(?:...)``; alternation ``|``
* quantifiers ``* + ?`` and ``{m} {m,} {m,n}`` (expansion capped);
  non-greedy suffixes are accepted (greediness is irrelevant to automaton
  acceptance)
* anchors ``^`` / ``$`` only at expression boundaries (the engine matches
  **fully anchored**, so boundary anchors are no-ops; interior anchors are
  rejected as unsupported)

Unsupported (rejected, like RE2): backreferences, lookaround. Unicode
classes are not needed — all matched fields are byte strings (paths,
hosts, DNS names).

The AST is over **byte sets** represented as 256-bit ints (bit i set ⇔
byte i in the set).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

FULL_MASK = (1 << 256) - 1
NEWLINE_MASK = FULL_MASK & ~(1 << 0x0A)  # '.' excludes \n (re default)


class RegexError(ValueError):
    pass


# ---------------------------------------------------------------- AST ----
@dataclasses.dataclass(frozen=True)
class Empty:
    """Matches the empty string."""


@dataclasses.dataclass(frozen=True)
class Lit:
    mask: int  # 256-bit byte-set


@dataclasses.dataclass(frozen=True)
class Concat:
    parts: Tuple["Node", ...]


@dataclasses.dataclass(frozen=True)
class Alt:
    options: Tuple["Node", ...]


@dataclasses.dataclass(frozen=True)
class Star:
    node: "Node"


@dataclasses.dataclass(frozen=True)
class Plus:
    node: "Node"


@dataclasses.dataclass(frozen=True)
class Opt:
    node: "Node"


@dataclasses.dataclass(frozen=True)
class Repeat:
    node: "Node"
    lo: int
    hi: int  # -1 = unbounded


Node = Union[Empty, Lit, Concat, Alt, Star, Plus, Opt, Repeat]


def _mask_of(chars: str) -> int:
    m = 0
    for c in chars:
        m |= 1 << ord(c)
    return m


_DIGIT = _mask_of("0123456789")
_WORD = _DIGIT | _mask_of("abcdefghijklmnopqrstuvwxyz"
                          "ABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_SPACE = _mask_of(" \t\n\r\f\v")

_CLASS_ESCAPES = {
    "d": _DIGIT,
    "D": FULL_MASK & ~_DIGIT,
    "w": _WORD,
    "W": FULL_MASK & ~_WORD,
    "s": _SPACE,
    "S": FULL_MASK & ~_SPACE,
}

_CHAR_ESCAPES = {
    "n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B,
    "a": 0x07, "0": 0x00,
}


def case_fold_mask(mask: int) -> int:
    """Add the opposite-case byte for every cased letter in the set."""
    out = mask
    for b in range(ord("a"), ord("z") + 1):
        if mask >> b & 1:
            out |= 1 << (b - 32)
    for b in range(ord("A"), ord("Z") + 1):
        if mask >> b & 1:
            out |= 1 << (b + 32)
    return out


class _Parser:
    def __init__(self, src: str, max_quantifier: int = 64,
                 case_insensitive: bool = False):
        self.src = src
        self.i = 0
        self.n = len(src)
        self.max_q = max_quantifier
        self.fold = case_insensitive

    # -- helpers --
    def peek(self) -> str:
        return self.src[self.i] if self.i < self.n else ""

    def next(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    def error(self, msg: str) -> RegexError:
        return RegexError(f"{msg} at {self.i} in {self.src!r}")

    def _lit(self, mask: int) -> Lit:
        if self.fold:
            mask = case_fold_mask(mask)
        return Lit(mask & FULL_MASK)

    # -- grammar --
    def parse_alt(self) -> Node:
        options = [self.parse_concat()]
        while self.peek() == "|":
            self.next()
            options.append(self.parse_concat())
        if len(options) == 1:
            return options[0]
        return Alt(tuple(options))

    def parse_concat(self) -> Node:
        parts: List[Node] = []
        while True:
            c = self.peek()
            if c == "" or c in "|)":
                break
            parts.append(self.parse_repeat())
        parts = [p for p in parts if not isinstance(p, Empty)]
        if not parts:
            return Empty()
        if len(parts) == 1:
            return parts[0]
        return Concat(tuple(parts))

    def parse_repeat(self) -> Node:
        atom = self.parse_atom()
        c = self.peek()
        if c == "*":
            self.next()
            atom = Star(atom)
        elif c == "+":
            self.next()
            atom = Plus(atom)
        elif c == "?":
            self.next()
            atom = Opt(atom)
        elif c == "{":
            save = self.i
            rep = self._try_parse_braces()
            if rep is None:
                self.i = save
                return atom
            lo, hi = rep
            if not isinstance(atom, Empty):
                atom = Repeat(atom, lo, hi)
        else:
            return atom
        # one lazy '?' suffix is acceptance-equivalent; possessive '+'
        # and stacked quantifiers ("a**", "a*+", "a*{2}") are rejected,
        # matching RE2 / Python re ("multiple repeat").
        if self.peek() == "?":
            self.next()
        nxt = self.peek()
        if nxt and nxt in "*+?":
            raise self.error("multiple/possessive quantifier unsupported")
        if nxt == "{":
            save = self.i
            if self._try_parse_braces() is not None:
                raise self.error("multiple quantifier unsupported")
            self.i = save
        return atom

    def _try_parse_braces(self):
        assert self.next() == "{"
        digits = ""
        while self.peek().isdigit():
            digits += self.next()
        if not digits:
            return None
        lo = int(digits)
        hi = lo
        if self.peek() == ",":
            self.next()
            digits2 = ""
            while self.peek().isdigit():
                digits2 += self.next()
            hi = int(digits2) if digits2 else -1
        if self.peek() != "}":
            return None
        self.next()
        cap = self.max_q
        if lo > cap or (hi != -1 and hi > cap):
            raise self.error(f"quantifier exceeds cap {cap}")
        if hi != -1 and hi < lo:
            raise self.error("bad quantifier range")
        return lo, hi

    def parse_atom(self) -> Node:
        c = self.peek()
        if c == "(":
            group_start = self.i
            self.next()
            if self.peek() == "?":
                self.next()
                nxt = self.peek()
                if nxt == ":":
                    self.next()
                elif nxt in "=!<":
                    raise self.error("lookaround unsupported")
                elif nxt == "P":
                    # (?P<name>...) named group — strip the name
                    self.next()
                    if self.next() != "<":
                        raise self.error("bad named group")
                    while self.peek() not in (">", ""):
                        self.next()
                    if self.next() != ">":
                        raise self.error("bad named group")
                elif nxt == "i":
                    # (?i) global flag group — Python re / RE2 only allow
                    # it at the start of the pattern
                    self.next()
                    if self.next() != ")":
                        raise self.error("only (?i) flag group supported")
                    if group_start != 0:
                        raise self.error("(?i) only allowed at pattern start")
                    self.fold = True
                    return Empty()
                else:
                    raise self.error(f"unsupported group (?{nxt}")
            node = self.parse_alt()
            if self.next() != ")":
                raise self.error("missing )")
            return node
        if c == "[":
            return self.parse_class()
        if c == ".":
            self.next()
            return Lit(NEWLINE_MASK)
        if c == "^":
            if self.i != 0 and self.src[self.i - 1] not in "(|":
                raise self.error("interior ^ unsupported")
            self.next()
            return Empty()
        if c == "$":
            if self.i + 1 < self.n and self.src[self.i + 1] not in ")|":
                raise self.error("interior $ unsupported")
            self.next()
            return Empty()
        if c == "\\":
            return self.parse_escape()
        if c in "*+?{":
            # bare '{' with no preceding atom is a literal in re;
            # '*'/'+'/'?' are errors
            if c == "{":
                self.next()
                return self._lit(1 << ord("{"))
            raise self.error(f"nothing to repeat: {c!r}")
        if c in ")|":
            return Empty()
        self.next()
        if ord(c) > 127:
            # byte-level semantics: non-ASCII literals match their UTF-8
            # byte sequence (inputs are matched as UTF-8 bytes)
            return Concat(tuple(Lit(1 << b) for b in c.encode("utf-8")))
        return self._lit(1 << ord(c))

    def parse_escape(self) -> Node:
        assert self.next() == "\\"
        c = self.next()
        if c == "":
            raise self.error("trailing backslash")
        if c in _CLASS_ESCAPES:
            return self._lit(_CLASS_ESCAPES[c])
        if c in _CHAR_ESCAPES:
            return self._lit(1 << _CHAR_ESCAPES[c])
        if c == "x":
            h = self.next() + self.next()
            try:
                return self._lit(1 << int(h, 16))
            except ValueError:
                raise self.error(f"bad \\x{h}")
        if c == "b" or c.isdigit() and c != "0":
            raise self.error(f"backreference/boundary \\{c} unsupported")
        if c.isalpha():
            raise self.error(f"unsupported escape \\{c}")
        return self._lit(1 << ord(c))

    def _class_escape_mask(self) -> Tuple[int, bool]:
        """Escape inside a class. Returns (mask, is_single_char)."""
        assert self.next() == "\\"
        c = self.next()
        if c == "":
            raise self.error("trailing backslash in class")
        if c in _CLASS_ESCAPES:
            return _CLASS_ESCAPES[c], False
        if c in _CHAR_ESCAPES:
            return 1 << _CHAR_ESCAPES[c], True
        if c == "x":
            h = self.next() + self.next()
            try:
                return 1 << int(h, 16), True
            except ValueError:
                raise self.error(f"bad \\x{h}")
        if c.isalpha():
            raise self.error(f"unsupported class escape \\{c}")
        return 1 << ord(c), True

    def parse_class(self) -> Node:
        assert self.next() == "["
        negate = False
        if self.peek() == "^":
            negate = True
            self.next()
        mask = 0
        first = True
        while True:
            c = self.peek()
            if c == "":
                raise self.error("unterminated class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            if c == "\\":
                m, single = self._class_escape_mask()
                lo_byte = m.bit_length() - 1 if single else None
            else:
                self.next()
                if ord(c) > 127:
                    raise self.error("non-ASCII in character class")
                m = 1 << ord(c)
                lo_byte = ord(c)
            # range?
            if (lo_byte is not None and self.peek() == "-"
                    and self.i + 1 < self.n and self.src[self.i + 1] != "]"):
                self.next()  # '-'
                c2 = self.peek()
                if c2 == "\\":
                    m2, single2 = self._class_escape_mask()
                    if not single2:
                        raise self.error("bad class range")
                    hi_byte = m2.bit_length() - 1
                else:
                    self.next()
                    hi_byte = ord(c2)
                if hi_byte < lo_byte:
                    raise self.error("reversed class range")
                m = 0
                for b in range(lo_byte, hi_byte + 1):
                    m |= 1 << b
            mask |= m
        if negate:
            mask = FULL_MASK & ~mask
        return self._lit(mask)


def parse(pattern: str, max_quantifier: int = 64,
          case_insensitive: bool = False) -> Node:
    """Parse ``pattern`` into an AST; raises :class:`RegexError`."""
    p = _Parser(pattern, max_quantifier=max_quantifier,
                case_insensitive=case_insensitive)
    node = p.parse_alt()
    if p.i != p.n:
        raise p.error("unbalanced )")
    return node
