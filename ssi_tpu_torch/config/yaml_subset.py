"""A first-party reader and writer for the YAML that the config system uses.

pyyaml is not a dependency of the port, so this module stands in for the two
calls ``ssi_tpu/config/__init__.py`` makes: ``yaml.load`` with the YAML 1.2
float rule added to ``SafeLoader`` (``load``), and ``yaml.safe_dump(...,
sort_keys=..., allow_unicode=True)`` (``dump``).

Reader: block mappings and sequences (an indentless sequence as a mapping's
value included), comments, plain scalars over several lines, single- and
double-quoted scalars (folded lines, escapes), and flow ``[...]`` / ``{...}``
collections. Plain scalars resolve as ``SafeLoader`` resolves them (YAML 1.1:
null, bool, int with its octal, hex, binary and base-60 forms, float,
timestamp), and ``2e-4`` is a float as under the config loader's extra rule.
Explicit keys (``? key``) read as the writer writes them. Anchors,
aliases, tags, block scalars (``|``, ``>``), collection keys and several
documents in one text raise ``ValueError``.

Writer: the bytes pyyaml's emitter writes for trees of dicts, lists, str,
int, float, bool and None (dates too): block collections, ``{}`` and ``[]``
for empty ones, sequences under a mapping not indented, each scalar in the
style the emitter would choose (plain unless the text would read back as
another type or holds an indicator; single-quoted, else double-quoted), with
long scalars folded at width 80. Its state (column, whether the last
character was whitespace or indentation) follows the emitter's.
"""

from __future__ import annotations

import datetime
import re
from typing import Any

__all__ = ["load", "dump"]

# ----------------------------------------------------------------------------------
# Implicit resolution (pyyaml 6 resolver.py; the YAML 1.2 float rule last)
# ----------------------------------------------------------------------------------

_BOOL_RE = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_MERGE_RE = re.compile(r"^(?:<<)$")
_NULL_RE = re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_VALUE_RE = re.compile(r"^(?:=)$")
# the config loader's YAML 1.2 float rule (ssi_tpu/config/__init__.py _Yaml12Loader)
_FLOAT12_RE = re.compile(r"""^(?:
            [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9_]+(?:[eE][-+][0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""", re.X)

_RESOLVERS: dict[str, list[tuple[str, re.Pattern]]] = {}
for _tag, _regexp, _first in (
    ("bool", _BOOL_RE, "yYnNtTfFoO"),
    ("float", _FLOAT_RE, "-+0123456789."),
    ("int", _INT_RE, "-+0123456789"),
    ("merge", _MERGE_RE, "<"),
    ("null", _NULL_RE, ["~", "n", "N", ""]),
    ("timestamp", _TIMESTAMP_RE, "0123456789"),
    ("value", _VALUE_RE, "="),
):
    for _ch in _first:
        _RESOLVERS.setdefault(_ch, []).append((_tag, _regexp))


def _resolve(value: str, yaml12_floats: bool) -> str:
    """The tag a plain scalar resolves to: the loader adds the YAML 1.2
    float rule (``yaml12_floats``); the dumper's resolver does not."""
    for tag, regexp in _RESOLVERS.get(value[:1], []):
        if regexp.match(value):
            return tag
    if yaml12_floats and value[:1] in "-+0123456789." and value and _FLOAT12_RE.match(value):
        return "float"
    return "str"


_TIMESTAMP_PARTS_RE = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])
        -(?P<month>[0-9][0-9]?)
        -(?P<day>[0-9][0-9]?)
        (?:(?:[Tt]|[ \t]+)
        (?P<hour>[0-9][0-9]?)
        :(?P<minute>[0-9][0-9])
        :(?P<second>[0-9][0-9])
        (?:\.(?P<fraction>[0-9]*))?
        (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
        (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)


def _sexagesimal(value: str, cast) -> Any:
    digits = [cast(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, cast(0)
    for digit in digits:
        out += digit * base
        base *= 60
    return out


def _construct_plain(value: str) -> Any:
    tag = _resolve(value, yaml12_floats=True)
    if tag == "str":
        return value
    if tag == "null":
        return None
    if tag == "bool":
        return value.lower() in ("yes", "true", "on")
    if tag == "int":
        v = value.replace("_", "")
        sign = -1 if v[0] == "-" else +1
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
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if tag == "float":
        v = value.replace("_", "").lower()
        sign = -1 if v[0] == "-" else +1
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if tag == "timestamp":
        values = _TIMESTAMP_PARTS_RE.match(value).groupdict()
        year, month, day = int(values["year"]), int(values["month"]), int(values["day"])
        if not values["hour"]:
            return datetime.date(year, month, day)
        fraction = 0
        if values["fraction"]:
            fraction = int(values["fraction"][:6].ljust(6, "0"))
        tzinfo = None
        if values["tz_sign"]:
            delta = datetime.timedelta(hours=int(values["tz_hour"]), minutes=int(values["tz_minute"] or 0))
            tzinfo = datetime.timezone(-delta if values["tz_sign"] == "-" else delta)
        elif values["tz"]:
            tzinfo = datetime.timezone.utc
        return datetime.datetime(year, month, day, int(values["hour"]), int(values["minute"]),
                                 int(values["second"]), fraction, tzinfo=tzinfo)
    raise ValueError(f"YAML subset: the plain scalar {value!r} resolves to the unsupported tag {tag!r}")


# ----------------------------------------------------------------------------------
# Reader
# ----------------------------------------------------------------------------------

_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0A", "v": "\x0B",
    "f": "\x0C", "r": "\x0D", "e": "\x1B", " ": "\x20", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xA0", "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_FLOW_INDICATORS = ",[]{}"


class _Parser:
    """Recursive descent over the text's lines; the position is (line, column)."""

    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        self.lines = re.split("\r\n|[\r\n\x85\u2028\u2029]", text)  # pyyaml's line breaks
        self.ln = 0
        self.col = 0

    # -- position helpers ---------------------------------------------------------

    def error(self, msg: str) -> ValueError:
        return ValueError(f"YAML subset: {msg} (line {self.ln + 1}, column {self.col + 1})")

    @property
    def line(self) -> str:
        return self.lines[self.ln] if self.ln < len(self.lines) else ""

    def peek(self, k: int = 0) -> str:
        line = self.line
        return line[self.col + k] if self.col + k < len(line) else ""

    def eof(self) -> bool:
        return self.ln >= len(self.lines)

    def skip_spaces(self) -> None:
        line = self.line
        while self.col < len(line) and line[self.col] in " \t":
            self.col += 1

    def at_line_end(self) -> bool:
        """Only spaces, then the end of the line or a comment."""
        self.skip_spaces()
        return self.col >= len(self.line) or self.peek() == "#"

    def next_line(self) -> None:
        self.ln += 1
        self.col = 0

    def skip_to_content(self) -> bool:
        """Move to the next character that is neither whitespace nor comment."""
        while not self.eof():
            if self.at_line_end():
                self.next_line()
                continue
            return True
        return False

    def end_of_node_line(self) -> None:
        if not self.at_line_end():
            raise self.error(f"unexpected text after a value: {self.line[self.col:]!r}")

    def at_seq_dash(self) -> bool:
        return self.peek() == "-" and self.peek(1) in ("", " ", "\t")

    def leading_spaces(self, ln: int) -> int:
        line = self.lines[ln]
        return len(line) - len(line.lstrip(" "))

    # -- block structure ------------------------------------------------------------

    def document(self) -> Any:
        if not self.skip_to_content():
            return None
        if self.col == 0 and self.line.startswith("---") and self.line[3:4] in ("", " ", "\t"):
            self.col = 3
            if self.at_line_end():
                self.next_line()
                if not self.skip_to_content():
                    return None
        node = self.block_node_here(self.col, -1)
        while self.skip_to_content():
            if self.col == 0 and self.line.rstrip() == "...":
                self.next_line()
                continue
            raise self.error("more than one node or document")
        return node

    def block_node_here(self, c: int, n: int) -> Any:
        """The node that starts at column ``c`` of the current line, inside a
        block collection indented ``n`` (continuation lines need more)."""
        if self.at_seq_dash():
            return self.block_sequence(c)
        if self.at_mapping_key():
            return self.block_mapping(c)
        node = self.flow_or_scalar(n)
        self.end_of_node_line()
        return node

    def value_after_indicator(self, n: int, *, compact: bool) -> Any:
        """The node after a mapping's ':' or a sequence's '-' at indent ``n``;
        ``compact``: a block collection may start on the indicator's line (a
        sequence entry, an explicit key or its value)."""
        if self.at_line_end():
            self.next_line()
            if not self.skip_to_content():
                return None
            if self.col > n:
                return self.block_node_here(self.col, n)
            if self.col == n and not compact and self.at_seq_dash():
                return self.block_sequence(n)  # a sequence under a mapping, not indented
            return None
        if compact:
            return self.block_node_here(self.col, n)
        node = self.flow_or_scalar(n)
        self.end_of_node_line()
        return node

    def block_sequence(self, c: int) -> list:
        items = []
        while True:
            self.col += 1
            items.append(self.value_after_indicator(c, compact=True))
            if not self.skip_to_content() or self.col < c:
                return items
            if self.col > c or not self.at_seq_dash():
                if self.col == c:
                    return items  # an indentless sequence ends at its mapping's next key
                raise self.error("bad indentation of a sequence entry")

    def block_mapping(self, c: int) -> dict:
        out: dict = {}
        while True:
            key, explicit = self.mapping_key()
            out[key] = self.value_after_indicator(c, compact=explicit)
            if not self.skip_to_content() or self.col < c:
                return out
            if self.col > c:
                raise self.error("bad indentation of a mapping entry")
            if self.at_seq_dash():
                return out  # an indentless sequence's parent goes on (its caller decides)
            if not self.at_mapping_key():
                raise self.error("expected a mapping key")

    def at_mapping_key(self) -> bool:
        line, i = self.line, self.col
        ch = line[i:i + 1]
        if ch in ("'", '"'):
            save = (self.ln, self.col)
            try:
                self.quoted_scalar()
            except ValueError:
                return False
            finally:
                same_line = self.ln == save[0]
                after = self.col
                self.ln, self.col = save
            if not same_line:
                return False
            j = after
            while j < len(line) and line[j] in " \t":
                j += 1
            return j < len(line) and line[j] == ":" and line[j + 1:j + 2] in ("", " ", "\t")
        if ch == "?" and line[i + 1:i + 2] in ("", " ", "\t"):
            return True  # an explicit key ('? key' then ': value'), as the writer emits for long keys
        if ch in ("[", "{", "&", "*", "!", "|", ">"):
            return False
        for j in range(i, len(line)):
            if line[j] == ":" and line[j + 1:j + 2] in ("", " ", "\t"):
                return True
            if line[j] == "#" and j > i and line[j - 1] in " \t":
                return False
        return False

    def mapping_key(self) -> Any:
        if self.peek() == "?" and self.peek(1) in ("", " ", "\t"):
            c = self.col
            self.col += 1
            key = self.value_after_indicator(c, compact=True)
            if isinstance(key, (dict, list)):
                raise self.error("collection keys are not supported")
            if not self.skip_to_content() or self.col != c or self.peek() != ":":
                raise self.error("expected ':' after an explicit key")
            self.col += 1
            return key, True
        elif self.peek() in ("'", '"'):
            key = self.quoted_scalar()
        else:
            line, start = self.line, self.col
            j = start
            while not (line[j] == ":" and line[j + 1:j + 2] in ("", " ", "\t")):
                j += 1
            key = _construct_plain(line[start:j].rstrip(" \t"))
            self.col = j
        self.skip_spaces()
        if self.peek() != ":":
            raise self.error("expected ':' after a mapping key")
        self.col += 1
        return key, False

    # -- scalars and flow collections --------------------------------------------------

    def flow_or_scalar(self, n: int) -> Any:
        ch = self.peek()
        if ch in ("[", "{"):
            return self.flow_node()
        if ch in ("'", '"'):
            return self.quoted_scalar()
        return _construct_plain(self.plain_scalar(n, flow=False))

    def plain_scalar(self, n: int, *, flow: bool) -> str:
        ch, nxt = self.peek(), self.peek(1)
        if ch in "#,[]{}&*!|>'\"%@`" or (ch in "-?:" and nxt in ("", " ", "\t")):
            if ch in "|>":
                raise self.error("block scalars ('|', '>') are not supported")
            if ch in "&*!":
                raise self.error("anchors, aliases and tags are not supported")
            raise self.error(f"a plain scalar cannot start with {ch!r}")
        chunks = [self.plain_line(flow)]
        while self.col >= len(self.line.rstrip(" \t")):  # the scalar ran to the end of its line
            ln, blanks = self.ln + 1, 0
            while ln < len(self.lines) and not self.lines[ln].strip(" \t"):
                ln, blanks = ln + 1, blanks + 1
            if ln >= len(self.lines):
                break
            indent = self.leading_spaces(ln)
            rest = self.lines[ln][indent:].lstrip(" \t")
            if indent <= n or rest.startswith("#") or (
                self.lines[ln][:3] in ("---", "...") and self.lines[ln][3:4] in ("", " ", "\t")
            ):
                break
            if flow and rest[:1] in _FLOW_INDICATORS:
                break
            save = (self.ln, self.col)
            self.ln, self.col = ln, len(self.lines[ln]) - len(rest)
            if not flow and rest[:1] == ":" and rest[1:2] in ("", " ", "\t"):
                self.ln, self.col = save
                break
            chunks.append("\n" * blanks if blanks else " ")
            chunks.append(self.plain_line(flow))
        return "".join(chunks)

    def plain_line(self, flow: bool) -> str:
        """Plain text from the position to the end of the scalar on this line."""
        line, start = self.line, self.col
        j = start
        while j < len(line):
            ch = line[j]
            if ch == ":" and (line[j + 1:j + 2] in ("", " ", "\t") or (flow and line[j + 1:j + 2] in _FLOW_INDICATORS)):
                break
            if ch == "#" and j > start and line[j - 1] in " \t":
                break
            if flow and ch in _FLOW_INDICATORS:
                break
            j += 1
        text = line[start:j].rstrip(" \t")
        self.col = start + len(text)
        return text

    def fold_break(self, chunks: list[str]) -> None:
        """At a line end inside a quoted scalar: drop the line's trailing
        whitespace, fold the break (one break -> a space, k + 1 -> k newlines)
        and skip the next line's leading whitespace."""
        while chunks and chunks[-1] and chunks[-1][-1] in " \t":
            chunks[-1] = chunks[-1].rstrip(" \t")
        blanks = 0
        self.next_line()
        while not self.eof() and not self.line.strip(" \t"):
            blanks += 1
            self.next_line()
        if self.eof():
            raise self.error("unterminated quoted scalar")
        chunks.append("\n" * blanks if blanks else " ")
        self.skip_spaces()

    def quoted_scalar(self) -> str:
        quote = self.peek()
        self.col += 1
        chunks: list[str] = []
        while True:
            if self.eof():
                raise self.error("unterminated quoted scalar")
            line = self.line
            if self.col >= len(line):
                self.fold_break(chunks)
                continue
            ch = line[self.col]
            if quote == "'":
                if ch == "'":
                    if line[self.col + 1:self.col + 2] == "'":
                        chunks.append("'")
                        self.col += 2
                        continue
                    self.col += 1
                    return "".join(chunks)
                start = self.col
                while self.col < len(line) and line[self.col] != "'":
                    self.col += 1
                chunks.append(line[start:self.col])
                continue
            if ch == '"':
                self.col += 1
                return "".join(chunks)
            if ch == "\\":
                esc = line[self.col + 1:self.col + 2]
                if esc == "":  # an escaped line break: the lines join with no space
                    self.next_line()
                    blanks = 0
                    while not self.eof() and not self.line.strip(" \t"):
                        blanks += 1
                        self.next_line()
                    chunks.append("\n" * blanks)
                    self.skip_spaces()
                    continue
                if esc in _ESCAPES:
                    chunks.append(_ESCAPES[esc])
                    self.col += 2
                    continue
                if esc in _ESCAPE_CODES:
                    k = _ESCAPE_CODES[esc]
                    digits = line[self.col + 2:self.col + 2 + k]
                    if len(digits) != k or not all(d in "0123456789abcdefABCDEF" for d in digits):
                        raise self.error(f"bad escape \\{esc}{digits}")
                    chunks.append(chr(int(digits, 16)))
                    self.col += 2 + k
                    continue
                raise self.error(f"unknown escape \\{esc}")
            start = self.col
            while self.col < len(line) and line[self.col] not in '"\\':
                self.col += 1
            chunks.append(line[start:self.col])

    def flow_skip(self) -> None:
        while not self.eof():
            self.skip_spaces()
            if self.col >= len(self.line) or self.peek() == "#":
                self.next_line()
                continue
            return
        raise self.error("unterminated flow collection")

    def flow_node(self) -> Any:
        ch = self.peek()
        if ch in ("[", "{"):
            close = "]" if ch == "[" else "}"
            self.col += 1
            out: Any = [] if ch == "[" else {}
            while True:
                self.flow_skip()
                if self.peek() == close:
                    self.col += 1
                    return out
                key = self.flow_node()
                self.flow_skip()
                if self.peek() == ":":
                    self.col += 1
                    self.flow_skip()
                    value = None if self.peek() in (",", close) else self.flow_node()
                    if ch == "[":
                        out.append({key: value})
                    else:
                        out[key] = value
                elif ch == "[":
                    out.append(key)
                else:
                    out[key] = None
                self.flow_skip()
                if self.peek() == ",":
                    self.col += 1
                elif self.peek() != close:
                    raise self.error(f"expected ',' or {close!r} in a flow collection")
        if ch in ("'", '"'):
            return self.quoted_scalar()
        return _construct_plain(self.plain_scalar(-1, flow=True))


def load(text: str) -> Any:
    """Read one YAML document (the subset the module docstring lists)."""
    return _Parser(text).document()


# ----------------------------------------------------------------------------------
# Writer (pyyaml's Emitter, block style, as safe_dump drives it)
# ----------------------------------------------------------------------------------

_BREAKS = "\n\x85\u2028\u2029"
_WHITESPACE = "\0 \t\r\n\x85\u2028\u2029"
_DQ_ESCAPES = {
    "\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n", "\x0B": "v", "\x0C": "f",
    "\x0D": "r", "\x1B": "e", '"': '"', "\\": "\\", "\x85": "N", "\xA0": "_", "\u2028": "L", "\u2029": "P",
}
_SHORT_TAGS = {"str": "!!str", "int": "!!int", "float": "!!float", "bool": "!!bool", "null": "!!null",
               "timestamp": "!!timestamp"}
_BEST_INDENT = 2
_BEST_WIDTH = 80


def _represent(value: Any) -> tuple[str, str]:
    """(tag, text) of a scalar, as SafeRepresenter writes it."""
    if value is None:
        return "null", "null"
    if isinstance(value, bool):
        return "bool", "true" if value else "false"
    if isinstance(value, int):
        return "int", str(value)
    if isinstance(value, float):
        if value != value:
            return "float", ".nan"
        if value == float("inf"):
            return "float", ".inf"
        if value == -float("inf"):
            return "float", "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return "float", text
    if isinstance(value, str):
        return "str", value
    if isinstance(value, datetime.datetime):
        return "timestamp", value.isoformat(" ")
    if isinstance(value, datetime.date):
        return "timestamp", value.isoformat()
    raise TypeError(f"YAML subset: cannot represent {type(value).__name__} {value!r}")


class _Analysis:
    __slots__ = ("empty", "multiline", "allow_flow_plain", "allow_block_plain", "allow_single_quoted")

    def __init__(self, text: str):
        self.empty = not text
        self.multiline = False
        self.allow_flow_plain = self.allow_block_plain = self.allow_single_quoted = True
        if not text:
            self.allow_flow_plain = False
            return
        block_ind = flow_ind = line_breaks = special = False
        leading_space = leading_break = trailing_space = trailing_break = False
        break_space = space_break = False
        if text.startswith("---") or text.startswith("..."):
            block_ind = flow_ind = True
        preceded_ws = True
        followed_ws = len(text) == 1 or text[1] in _WHITESPACE
        prev_space = prev_break = False
        for index, ch in enumerate(text):
            if index == 0:
                if ch in "#,[]{}&*!|>'\"%@`":
                    flow_ind = block_ind = True
                if ch in "?:":
                    flow_ind = True
                    if followed_ws:
                        block_ind = True
                if ch == "-" and followed_ws:
                    flow_ind = block_ind = True
            else:
                if ch in ",?[]{}":
                    flow_ind = True
                if ch == ":":
                    flow_ind = True
                    if followed_ws:
                        block_ind = True
                if ch == "#" and preceded_ws:
                    flow_ind = block_ind = True
            if ch in _BREAKS:
                line_breaks = True
            if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
                unicode_ok = (ch == "\x85" or "\xA0" <= ch <= "\ud7ff" or "\ue000" <= ch <= "\ufffd"
                              or "\U00010000" <= ch < "\U0010ffff") and ch != "\ufeff"
                if not unicode_ok:  # allow_unicode=True: only these need escapes
                    special = True
            if ch == " ":
                leading_space |= index == 0
                trailing_space |= index == len(text) - 1
                break_space |= prev_break
                prev_space, prev_break = True, False
            elif ch in _BREAKS:
                leading_break |= index == 0
                trailing_break |= index == len(text) - 1
                space_break |= prev_space
                prev_space, prev_break = False, True
            else:
                prev_space = prev_break = False
            preceded_ws = ch in _WHITESPACE
            followed_ws = index + 2 >= len(text) or text[index + 2] in _WHITESPACE
        if leading_space or leading_break or trailing_space or trailing_break:
            self.allow_flow_plain = self.allow_block_plain = False
        if break_space:
            self.allow_flow_plain = self.allow_block_plain = self.allow_single_quoted = False
        if space_break or special:
            self.allow_flow_plain = self.allow_block_plain = self.allow_single_quoted = False
        if line_breaks:
            self.allow_flow_plain = self.allow_block_plain = False
        if flow_ind:
            self.allow_flow_plain = False
        if block_ind:
            self.allow_block_plain = False
        self.multiline = line_breaks


class _Emitter:
    def __init__(self, sort_keys: bool):
        self.sort_keys = sort_keys
        self.out: list[str] = []
        self.indents: list[int | None] = []
        self.indent: int | None = None
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.open_ended = False

    # -- low-level writes (Emitter.write_indicator / write_indent / write_line_break)

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def write_indicator(self, indicator: str, need_whitespace: bool, whitespace: bool = False,
                        indention: bool = False) -> None:
        data = indicator if self.whitespace or not need_whitespace else " " + indicator
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False
        self.write(data)

    def write_indent(self) -> None:
        indent = self.indent or 0
        if not self.indention or self.column > indent or (self.column == indent and not self.whitespace):
            self.write_line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def write_line_break(self, data: str = "\n") -> None:
        self.whitespace = True
        self.indention = True
        self.column = 0
        self.out.append(data)

    def increase_indent(self, flow: bool = False, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = _BEST_INDENT if flow else 0
        elif not indentless:
            self.indent += _BEST_INDENT

    # -- nodes -------------------------------------------------------------------

    def node(self, value: Any, *, root: bool = False, mapping: bool = False, simple_key: bool = False) -> None:
        if isinstance(value, dict):
            if not value:
                self.empty_flow("{", "}")
            else:
                self.block_mapping(value)
        elif isinstance(value, list):
            if not value:
                self.empty_flow("[", "]")
            else:
                self.block_sequence(value, mapping_context=mapping)
        else:
            self.increase_indent(flow=True)
            self.scalar(value, root=root, simple_key=simple_key)
            self.indent = self.indents.pop()

    def empty_flow(self, open_: str, close: str) -> None:
        self.write_indicator(open_, True, whitespace=True)
        self.increase_indent(flow=True)
        self.indent = self.indents.pop()
        self.write_indicator(close, False)

    def block_sequence(self, items: list, mapping_context: bool) -> None:
        self.increase_indent(flow=False, indentless=mapping_context and not self.indention)
        for item in items:
            self.write_indent()
            self.write_indicator("-", True, indention=True)
            self.node(item)
        self.indent = self.indents.pop()

    def block_mapping(self, mapping: dict) -> None:
        self.increase_indent(flow=False)
        items = list(mapping.items())
        if self.sort_keys:
            try:
                items = sorted(items)
            except TypeError:
                pass
        for key, value in items:
            self.write_indent()
            if isinstance(key, (dict, list)):
                raise TypeError("YAML subset: collection keys are not supported")
            tag, text = _represent(key)
            analysis = _Analysis(text)
            if len(text) + len(_SHORT_TAGS[tag]) < 128 and not analysis.empty and not analysis.multiline:
                self.node(key, mapping=True, simple_key=True)
                self.write_indicator(":", False)
            else:
                self.write_indicator("?", True, indention=True)
                self.node(key, mapping=True)
                self.write_indent()
                self.write_indicator(":", True, indention=True)
            self.node(value, mapping=True)
        self.indent = self.indents.pop()

    # -- scalars (Emitter.choose_scalar_style and the writers) ---------------------

    def scalar(self, value: Any, *, root: bool, simple_key: bool) -> None:
        tag, text = _represent(value)
        analysis = _Analysis(text)
        plain_implicit = _resolve(text, yaml12_floats=False) == tag
        split = not simple_key
        if plain_implicit and not (simple_key and (analysis.empty or analysis.multiline)) \
                and analysis.allow_block_plain:
            if root:
                self.open_ended = True
            self.write_plain(text, split)
        elif tag != "str":
            raise TypeError(f"YAML subset: {value!r} would need an explicit tag")
        elif analysis.allow_single_quoted and not (simple_key and analysis.multiline):
            self.write_single_quoted(text, split)
        else:
            self.write_double_quoted(text, split)

    def write_plain(self, text: str, split: bool) -> None:
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = False
        self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _BEST_WIDTH and split:
                        self.write_indent()
                        self.whitespace = False
                        self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch not in _BREAKS:
                    self.write_breaks(text[start:end])
                    self.write_indent()
                    self.whitespace = False
                    self.indention = False
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1

    def write_breaks(self, brs: str) -> None:
        if brs[0] == "\n":
            self.write_line_break()
        for br in brs:
            self.write_line_break("\n" if br == "\n" else br)

    def write_single_quoted(self, text: str, split: bool) -> None:
        self.write_indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if start + 1 == end and self.column > _BEST_WIDTH and split and start != 0 \
                            and end != len(text):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self.write_breaks(text[start:end])
                    self.write_indent()
                    start = end
            elif ch is None or ch in " " + _BREAKS or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1
        self.write_indicator("'", False)

    def write_double_quoted(self, text: str, split: bool) -> None:
        self.write_indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or not (
                "\x20" <= ch <= "\x7E" or "\xA0" <= ch <= "\ud7ff" or "\ue000" <= ch <= "\ufffd"
            ):
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _DQ_ESCAPES:
                        data = "\\" + _DQ_ESCAPES[ch]
                    elif ch <= "\xFF":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uffff":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self.write(data)
                    start = end + 1
            if 0 < end < len(text) - 1 and (ch == " " or start >= end) \
                    and self.column + (end - start) > _BEST_WIDTH and split:
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = False
                self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.write_indicator('"', False)

    def document(self, data: Any) -> str:
        if not isinstance(data, (dict, list)):
            raise TypeError("YAML subset: the document root must be a mapping or a sequence")
        self.node(data, root=True)
        self.write_indent()  # document end
        return "".join(self.out)


def dump(data: Any, sort_keys: bool = False) -> str:
    """``yaml.safe_dump(data, sort_keys=sort_keys, allow_unicode=True)`` for a
    mapping or sequence of the types the module docstring lists."""
    return _Emitter(sort_keys).document(data)
