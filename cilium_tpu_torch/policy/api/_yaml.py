"""A reader of the YAML subset that CiliumNetworkPolicy files use.

The port's counterpart of ``yaml.safe_load_all`` for the CNP loader
(``policy/api/cnp.py``): the machine with the card has no ``pyyaml``.
It reads

* documents: an implicit first one, and one per ``---`` line (an
  explicit document with no content is ``None``, as PyYAML gives it);
* block mappings and sequences, sequences under a key at the key's
  own indentation included, and compact nesting (``- key: value``);
* flow mappings and sequences (``{a: 1, b: [x, y]}``), nested and over
  several lines;
* plain, single-quoted and double-quoted scalars on one line;
* comments.

Plain scalars resolve as PyYAML's SafeLoader resolves them (YAML 1.1):
``yes``/``no``/``on``/``off``/``true``/``false`` in their three cases
are booleans, ``~``/``null`` and the empty value are ``None``, ints take
signs, underscores, ``0b``, ``0x``, a leading ``0`` (octal) and base-60
(``1:30``), floats take ``.inf``/``.nan`` and exponents. Quoted scalars
stay strings (``port: "22"``).

Anything outside the subset raises ``ValueError`` naming the line:
anchors, aliases, tags, block scalars (``|``, ``>``), complex keys,
directives, ``...``, merge keys, timestamps, tabs in indentation, and
scalars folded over several lines. It never guesses.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
#: double-quoted escapes (PyYAML's ``ESCAPE_REPLACEMENTS``/``_CODES``)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09",
            "n": "\x0a", "v": "\x0b", "f": "\x0c", "r": "\x0d", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
#: characters a plain scalar may not start with
_NEVER_PLAIN = "&*!|>%@`"
_FLOW_INDICATORS = ",[]{}"
#: what PyYAML takes as a line break besides CR and LF
_OTHER_BREAKS = ("\x85", "\u2028", "\u2029")


def safe_load_all(text: str) -> List[Any]:
    """Every document of ``text``, as ``yaml.safe_load_all`` gives them
    for the subset; ``ValueError`` outside it."""
    if text.startswith("\ufeff"):
        text = text[1:]
    for ch in _OTHER_BREAKS:
        if ch in text:
            raise ValueError(f"line break {ch!r} is outside the subset")
    lines = re.split(r"\r\n|\r|\n", text)
    docs: List[Tuple[int, int, bool]] = []
    lo, explicit = 0, False
    for i, line in enumerate(lines):
        if line.startswith("%"):
            raise ValueError(f"line {i + 1}: directives are outside the "
                             f"subset")
        if re.match(r"^\.\.\.(\s|$)", line):
            raise ValueError(f"line {i + 1}: '...' is outside the subset")
        if re.match(r"^---(\s|$)", line):
            rest = line[3:].strip()
            if rest and not rest.startswith("#"):
                raise ValueError(f"line {i + 1}: content after '---' is "
                                 f"outside the subset")
            docs.append((lo, i, explicit))
            lo, explicit = i + 1, True
    docs.append((lo, len(lines), explicit))
    out = []
    for lo, hi, explicit in docs:
        p = _Parser(lines, lo, hi)
        if p.skip_blank(lo) >= hi:
            if explicit:
                out.append(None)
            continue
        out.append(p.document())
    return out


def _int(s: str) -> int:
    v = s.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        value, base = 0, 1
        for d in reversed([int(p) for p in v.split(":")]):
            value += d * base
            base *= 60
        return sign * value
    return sign * int(v)


def _float(s: str) -> float:
    v = s.replace("_", "").lower()
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        value, base = 0.0, 1
        for d in reversed([float(p) for p in v.split(":")]):
            value += d * base
            base *= 60
        return sign * value
    return sign * float(v)


def _resolve(s: str, li: int):
    """A plain scalar's value, by SafeLoader's implicit resolvers."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        return _int(s)
    if _FLOAT.match(s):
        return _float(s)
    if _TIMESTAMP.match(s) or s in ("<<", "="):
        raise ValueError(f"line {li + 1}: {s!r} (a timestamp, merge key or "
                         f"value key) is outside the subset")
    return s


def _is_seq_item(line: str, c: int) -> bool:
    return line[c] == "-" and (c + 1 == len(line) or line[c + 1] == " ")


class _Parser:
    """Recursive descent over the lines ``[lo, hi)`` of one document;
    ``self.i`` is the line after the last node parsed."""

    def __init__(self, lines: List[str], lo: int, hi: int):
        self.lines, self.hi, self.i = lines, hi, lo

    # -- lines ------------------------------------------------------------
    def err(self, li: int, msg: str):
        raise ValueError(f"line {li + 1}: {msg}")

    def blank(self, li: int) -> bool:
        s = self.lines[li].lstrip(" ")
        return s == "" or s.startswith("#")

    def skip_blank(self, li: int) -> int:
        while li < self.hi and self.blank(li):
            li += 1
        return li

    def indent(self, li: int) -> int:
        line = self.lines[li]
        n = len(line) - len(line.lstrip(" "))
        if line[n:n + 1] == "\t":
            self.err(li, "a tab in the indentation is outside the subset")
        return n

    def end_of_line(self, li: int, c: int) -> None:
        """The rest of line ``li`` from ``c`` holds nothing but a
        comment; the next node starts on the next line."""
        line = self.lines[li]
        j = c
        while j < len(line) and line[j] == " ":
            j += 1
        if j < len(line) and not (line[j] == "#" and j > c):
            self.err(li, f"unexpected {line[j:]!r}")
        self.i = li + 1

    def next_line(self) -> Tuple[int, int]:
        """(line, indent) of the next line with content, or (hi, -1)."""
        li = self.skip_blank(self.i)
        return (li, self.indent(li)) if li < self.hi else (li, -1)

    # -- block context ----------------------------------------------------
    def document(self):
        li = self.skip_blank(self.i)
        value = self.node(li, self.indent(li))
        li, _ = self.next_line()
        if li < self.hi:
            self.err(li, "unexpected content after the document's root")
        return value

    def node(self, li: int, c: int):
        """The node whose content starts at line ``li``, column ``c``."""
        line = self.lines[li]
        if _is_seq_item(line, c):
            return self.block_seq(li, c)
        if line[c] in "[{":
            value, (li2, c2) = self.flow(li, c)
            self.end_of_line(li2, c2)
            return value
        if self.key_colon(li, c) is not None:
            return self.block_map(li, c)
        return self.inline(li, c)

    def nested(self, li: int, col: int, same_indent_seq: bool):
        """The value of a key (or ``-``) at column ``col`` of line ``li``
        that has nothing after it on its line: the more indented node on
        the next lines, a sequence at the key's own indentation, or
        ``None``."""
        self.i = li + 1
        nli, ind = self.next_line()
        if nli < self.hi and ind > col:
            return self.node(nli, ind)
        if nli < self.hi and ind == col and same_indent_seq \
                and _is_seq_item(self.lines[nli], ind):
            return self.block_seq(nli, ind)
        return None

    def block_seq(self, li: int, col: int) -> list:
        out = []
        while True:
            line = self.lines[li]
            c = col + 1
            while c < len(line) and line[c] == " ":
                c += 1
            if c >= len(line) or line[c] == "#":
                out.append(self.nested(li, col, same_indent_seq=False))
            else:
                out.append(self.node(li, c))
            li, ind = self.next_line()
            if li >= self.hi or ind < col:
                return out
            if ind > col:
                self.err(li, "unexpected indentation (a multi-line scalar "
                             "is outside the subset)")
            if not _is_seq_item(self.lines[li], col):
                return out      # a sequence at its key's indentation ends

    def block_map(self, li: int, col: int) -> dict:
        out = {}
        while True:
            line = self.lines[li]
            colon = self.key_colon(li, col)
            if colon is None:
                self.err(li, f"expected a 'key:' at column {col + 1}")
            key = self.key(li, col, colon)
            c = colon + 1
            while c < len(line) and line[c] == " ":
                c += 1
            if c >= len(line) or line[c] == "#":
                out[key] = self.nested(li, col, same_indent_seq=True)
            else:
                out[key] = self.inline(li, c)
            li, ind = self.next_line()
            if li >= self.hi or ind < col:
                return out
            if ind > col:
                self.err(li, "unexpected indentation (a multi-line scalar "
                             "is outside the subset)")
            if _is_seq_item(self.lines[li], col):
                self.err(li, "a sequence item where a key was expected")

    def key_colon(self, li: int, c: int):
        """Column of the ``:`` that ends a block key starting at ``c``,
        or None when the content is not a key."""
        line = self.lines[li]
        if line[c] in "'\"":
            _, j = self.quoted(li, c)
            while j < len(line) and line[j] == " ":
                j += 1
            ok = j < len(line) and line[j] == ":" and (
                j + 1 == len(line) or line[j + 1] == " ")
            return j if ok else None
        if line[c] == "?" and (c + 1 == len(line) or line[c + 1] == " "):
            self.err(li, "complex keys are outside the subset")
        j = c
        while j < len(line):
            if line[j] == "#" and j > c and line[j - 1] == " ":
                return None
            if line[j] == ":" and (j + 1 == len(line) or line[j + 1] == " "):
                return j
            j += 1
        return None

    def key(self, li: int, c: int, colon: int):
        line = self.lines[li]
        if line[c] in "'\"":
            return self.quoted(li, c)[0]
        if line[c] in "[{":
            self.err(li, "complex keys are outside the subset")
        text = line[c:colon].rstrip(" ")
        if not text:
            self.err(li, "an empty key is outside the subset")
        return self.plain_value(li, text)

    def inline(self, li: int, c: int):
        """A value after ``key: `` (or a scalar node): flow, quoted or
        plain, ending its line."""
        line = self.lines[li]
        if line[c] in "[{":
            value, (li2, c2) = self.flow(li, c)
            self.end_of_line(li2, c2)
            return value
        if _is_seq_item(line, c):
            self.err(li, "a block sequence cannot start after a key")
        if line[c] in "'\"":
            value, j = self.quoted(li, c)
            self.end_of_line(li, j)
            return value
        j = c
        while j < len(line) and not (line[j] == "#" and line[j - 1] == " "):
            if line[j] == ":" and (j + 1 == len(line) or line[j + 1] == " "):
                self.err(li, "a mapping value is not allowed here")
            j += 1
        self.i = li + 1
        return self.plain_value(li, line[c:j].rstrip(" "))

    def plain_value(self, li: int, text: str):
        if "\t" in text:
            self.err(li, "a tab outside quotes is outside the subset")
        ch = text[0]
        if ch in _NEVER_PLAIN:
            self.err(li, f"{ch!r} (an anchor, alias, tag, block scalar or "
                         f"reserved indicator) is outside the subset")
        if ch in "?:-" and (len(text) == 1 or text[1] == " "):
            self.err(li, f"{text!r} is outside the subset")
        if ch in "'\"#" or ch in _FLOW_INDICATORS:
            self.err(li, f"unexpected {text!r}")
        return _resolve(text, li)

    # -- scalars ----------------------------------------------------------
    def quoted(self, li: int, c: int) -> Tuple[str, int]:
        """A quoted scalar at ``c`` → (value, column after the closing
        quote); it must end on its line."""
        line = self.lines[li]
        q, j, out = line[c], c + 1, []
        while True:
            if j >= len(line):
                self.err(li, "a quoted scalar over several lines is outside "
                             "the subset")
            ch = line[j]
            if q == "'":
                if ch == "'":
                    if line[j + 1:j + 2] == "'":
                        out.append("'")
                        j += 2
                        continue
                    return "".join(out), j + 1
                out.append(ch)
                j += 1
                continue
            if ch == '"':
                return "".join(out), j + 1
            if ch != "\\":
                out.append(ch)
                j += 1
                continue
            e = line[j + 1:j + 2]
            if e in _ESCAPES and e:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _HEX_ESCAPES and e:
                n = _HEX_ESCAPES[e]
                digits = line[j + 2:j + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+",
                                                        digits):
                    self.err(li, f"bad escape {line[j:j + 2 + n]!r}")
                out.append(chr(int(digits, 16)))
                j += 2 + n
            else:
                self.err(li, f"escape {line[j:j + 2]!r} is outside the "
                             f"subset")

    # -- flow context -----------------------------------------------------
    def fskip(self, li: int, c: int) -> Tuple[int, int]:
        """Skip spaces, line ends and comments inside a flow
        collection."""
        while li < self.hi:
            line = self.lines[li]
            while c < len(line) and line[c] == " ":
                c += 1
            if c < len(line) and line[c] == "\t":
                self.err(li, "a tab outside quotes is outside the subset")
            if c < len(line) and not (line[c] == "#" and (
                    c == 0 or line[c - 1] == " ")):
                return li, c
            li, c = li + 1, 0
        self.err(self.hi - 1, "an unclosed flow collection")

    def flow(self, li: int, c: int):
        """A flow collection at (``li``, ``c``) → (value, (line, column
        after its closing bracket))."""
        close = "]" if self.lines[li][c] == "[" else "}"
        out: Any = [] if close == "]" else {}
        c += 1
        while True:
            li, c = self.fskip(li, c)
            if self.lines[li][c] == close:
                return out, (li, c + 1)
            if close == "}" and self.lines[li][c] == "?" and \
                    self.lines[li][c + 1:c + 2] in ("", " "):
                self.err(li, "complex keys are outside the subset")
            item, (li, c) = self.fnode(li, c)
            li, c = self.fskip(li, c)
            ch = self.lines[li][c]
            if close == "]":
                if ch == ":":
                    self.err(li, "a mapping inside a flow sequence is "
                                 "outside the subset")
                out.append(item)
            else:
                value = None
                if ch == ":":
                    li, c = self.fskip(li, c + 1)
                    if self.lines[li][c] not in ",}":
                        value, (li, c) = self.fnode(li, c)
                        li, c = self.fskip(li, c)
                if isinstance(item, (list, dict)):
                    self.err(li, "complex keys are outside the subset")
                out[item] = value
            ch = self.lines[li][c]
            if ch == ",":
                c += 1
            elif ch != close:
                self.err(li, f"expected ',' or {close!r}, found {ch!r}")

    def fnode(self, li: int, c: int):
        line = self.lines[li]
        ch = line[c]
        if ch in "[{":
            return self.flow(li, c)
        if ch in "'\"":
            value, j = self.quoted(li, c)
            return value, (li, j)
        j = c
        while j < len(line):
            ch = line[j]
            if ch in _FLOW_INDICATORS:
                break
            if ch == ":" and (j + 1 == len(line)
                              or line[j + 1] in " " + _FLOW_INDICATORS):
                break
            if ch == "#" and line[j - 1] == " ":
                break
            j += 1
        text = line[c:j].rstrip(" ")
        if not text:
            self.err(li, f"an empty flow entry at column {c + 1}")
        value = self.plain_value(li, text)
        if j >= len(line) or line[j] == "#":
            # a plain scalar that ends its line must not go on below
            nli, nc = self.fskip(li + 1, 0)
            if self.lines[nli][nc] not in ",]}:":
                self.err(nli, "a plain scalar over several lines is outside "
                              "the subset")
        return value, (li, j)
