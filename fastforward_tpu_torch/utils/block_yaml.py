"""A writer and a reader of the block-YAML subset that a quantization
state's ``config.yaml`` is written in, without PyYAML.

`safe_dump` gives the text ``yaml.safe_dump(data)`` gives (PyYAML's
defaults: block style, keys sorted, indent 2, width 80, no unicode) for a
mapping of str keys whose values are mappings, lists, str, int, bool,
float and None. It follows PyYAML's emitter: a str is plain where it
resolves to a str and has no indicator, else single-quoted, else
double-quoted with escapes; long plain and quoted scalars fold at the
width; a list under a key is written without indentation (``- item``); an
empty mapping or list is ``{}`` or ``[]``; a float is ``repr`` with ``.0``
put before an exponent that has no point (``1.0e-05``: PyYAML reads a bare
``1e-05`` as a string). Keys must be simple (fewer than 123 characters, one
line, not empty); a longer key raises.

`safe_load` reads that subset back as ``yaml.safe_load`` would: block
mappings and sequences (nested ones too), plain scalars resolved by YAML
1.1's implicit rules (null, bool, int, float, else str), single- and
double-quoted scalars with their folding and escapes, ``{}`` and ``[]``,
anchors and aliases. Anything else (flow collections with content, block
scalars, tags, timestamps, complex keys, comments) raises ValueError.
"""

import math
import re
from typing import Any

_WIDTH = 80
_INDENT = 2

_BREAKS = "\n\x85\u2028\u2029"
_WS_OR_END = "\0 \t\r\n\x85\u2028\u2029"

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:[Tt]|[ \t]+)[0-9][0-9]?"
                        r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_OTHER = re.compile(r"^(?:<<|=)$")  # the merge and value keys


def resolve(text: str) -> str:
    """The YAML 1.1 type a plain scalar reads as: "null", "bool", "int",
    "float", "timestamp", "other" or "str"."""
    for kind, pattern in (("bool", _BOOL), ("float", _FLOAT), ("int", _INT), ("null", _NULL),
                          ("timestamp", _TIMESTAMP), ("other", _OTHER)):
        if pattern.match(text):
            return kind
    return "str"


# -- the writer ---------------------------------------------------------------


def _analyze(s: str) -> dict:
    """Which scalar styles can hold ``s`` (PyYAML's analysis, allow_unicode
    off): plain in block context, single-quoted; and whether it spans
    lines."""
    if not s:
        return dict(empty=True, multiline=False, block_plain=True, single=True)
    block_ind = s.startswith("---") or s.startswith("...")
    line_breaks = special = False
    edge = break_space = space_break = False  # a space or break first or last
    preceded_ws = True
    followed_ws = len(s) == 1 or s[1] in _WS_OR_END
    prev_space = prev_break = False
    for i, ch in enumerate(s):
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                block_ind = True
            if ch in "?:" and followed_ws:
                block_ind = True
            if ch == "-" and followed_ws:
                block_ind = True
        else:
            if ch == ":" and followed_ws:
                block_ind = True
            if ch == "#" and preceded_ws:
                block_ind = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7e"):
            special = True  # unicode or a control character: no plain, no quotes
        if ch == " ":
            if i == 0 or i == len(s) - 1:
                edge = True
            if prev_break:
                break_space = True
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            if i == 0 or i == len(s) - 1:
                edge = True
            if prev_space:
                space_break = True
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded_ws = ch in _WS_OR_END
        followed_ws = i + 2 >= len(s) or s[i + 2] in _WS_OR_END
    plain = not (edge or break_space or space_break or special or line_breaks or block_ind)
    single = not (break_space or space_break or special)
    return dict(empty=False, multiline=line_breaks, block_plain=plain, single=single)


_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0a": "n", "\x0b": "v",
            "\x0c": "f", "\x0d": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N",
            "\xa0": "_", "\u2028": "L", "\u2029": "P"}


class _Writer:
    def __init__(self):
        self.out: list[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent = 0

    def write(self, data: str) -> None:
        self.out.append(data)
        self.column += len(data)

    def line_break(self, data: str = "\n") -> None:
        self.out.append(data)
        self.column = 0
        self.whitespace = self.indention = True

    def write_indent(self) -> None:
        if not self.indention or self.column > self.indent or (
                self.column == self.indent and not self.whitespace):
            self.line_break()
        if self.column < self.indent:
            self.whitespace = True
            self.write(" " * (self.indent - self.column))

    def indicator(self, ind: str, need_ws: bool, whitespace: bool = False,
                  indention: bool = False) -> None:
        self.write(ind if self.whitespace or not need_ws else " " + ind)
        self.whitespace = whitespace
        self.indention = self.indention and indention

    # scalars

    def scalar(self, value: Any, key: bool = False) -> None:
        text, style = _scalar_text(value, key)
        split = not key
        if style == "":
            self.plain(text, split)
        elif style == "'":
            self.single(text, split)
        else:
            self.double(text, split)

    def plain(self, text: str, split: bool) -> None:
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
            end += 1

    def single(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > _WIDTH and split and start != 0
                            and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.line_break()
                    for br in text[start:end]:
                        self.line_break(br)
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
        self.indicator("'", False)

    def double(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or not "\x20" <= ch <= "\x7e":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPES:
                        data = "\\" + _ESCAPES[ch]
                    elif ch <= "\xff":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uffff":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self.write(data)
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > _WIDTH and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.indicator('"', False)

    # collections

    def node(self, value: Any, in_mapping: bool) -> None:
        if isinstance(value, dict) and value:
            self.block_mapping(value)
        elif isinstance(value, list) and value:
            self.block_sequence(value, indentless=in_mapping and not self.indention)
        elif isinstance(value, (dict, list)):
            self.indicator("{" if isinstance(value, dict) else "[", True, whitespace=True)
            self.indicator("}" if isinstance(value, dict) else "]", False)
        else:
            outer = self.indent
            self.indent += _INDENT
            self.scalar(value)
            self.indent = outer

    def block_mapping(self, mapping: dict) -> None:
        outer = self.indent
        self.indent += _INDENT
        for key in sorted(mapping):
            if not isinstance(key, str):
                raise ValueError(f"block_yaml writes str keys only, not {key!r}")
            analysis = _analyze(key)
            if analysis["empty"] or analysis["multiline"] or len(key) + 5 >= 128:
                raise ValueError(f"key {key!r} is not a simple key (PyYAML would write a "
                                 "complex '?' key, which block_yaml does not)")
            self.write_indent()
            self.indent += _INDENT
            self.scalar(key, key=True)
            self.indent -= _INDENT
            self.indicator(":", False)
            self.node(mapping[key], in_mapping=True)
        self.indent = outer

    def block_sequence(self, items: list, indentless: bool) -> None:
        outer = self.indent
        if not indentless:
            self.indent += _INDENT
        for item in items:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(item, in_mapping=False)
        self.indent = outer


def _float_text(value: float) -> str:
    if value != value:
        return ".nan"
    if value == math.inf:
        return ".inf"
    if value == -math.inf:
        return "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _scalar_text(value: Any, key: bool) -> tuple[str, str]:
    """(text, style) of a scalar: style "" plain, "'" or '"'."""
    if value is None:
        return "null", ""
    if isinstance(value, bool):
        return ("true" if value else "false"), ""
    if isinstance(value, int):
        return str(value), ""
    if isinstance(value, float):
        return _float_text(value), ""
    if not isinstance(value, str):
        raise ValueError(f"block_yaml writes str, int, bool, float and None, not "
                         f"{type(value).__name__}")
    a = _analyze(value)
    if resolve(value) == "str" and not (key and (a["empty"] or a["multiline"])) \
            and a["block_plain"]:
        return value, ""
    if a["single"] and not (key and a["multiline"]):
        return value, "'"
    return value, '"'


def safe_dump(data: dict) -> str:
    """``yaml.safe_dump(data)``'s text for a mapping of the subset."""
    if not isinstance(data, dict):
        raise ValueError("block_yaml writes a mapping at the root")
    if not data:
        return "{}\n"
    w = _Writer()
    w.indent = -_INDENT  # the root mapping's keys at column 0
    w.block_mapping(data)
    w.out.append("\n")
    return "".join(w.out)


# -- the reader ---------------------------------------------------------------


def _construct(text: str) -> Any:
    """A plain scalar's value (PyYAML's safe constructors)."""
    kind = resolve(text)
    if kind == "null":
        return None
    if kind == "bool":
        return text.lower() in ("yes", "true", "on")
    if kind == "int":
        v = text.replace("_", "")
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
            n = 0
            for part in v.split(":"):
                n = n * 60 + int(part)
            return sign * n
        return sign * int(v)
    if kind == "float":
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            n = 0.0
            for part in v.split(":"):
                n = n * 60 + float(part)
            return sign * n
        return sign * float(v)
    if kind != "str":
        raise ValueError(f"block_yaml does not read the {kind} scalar {text!r}")
    return text


class _Reader:
    def __init__(self, text: str):
        self.s = text
        self.i = 0
        self.anchors: dict[str, Any] = {}

    def error(self, what: str):
        line = self.s.count("\n", 0, self.i) + 1
        return ValueError(f"block_yaml: {what} at line {line}")

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else "\0"

    def column(self) -> int:
        return self.i - (self.s.rfind("\n", 0, self.i) + 1)

    def next_line(self) -> tuple[int, int]:
        """(start of the next non-empty line's content, its indent) after
        the current line; (len, -1) at the end."""
        j = self.s.find("\n", self.i)
        while j != -1:
            start = j + 1
            k = start
            while k < len(self.s) and self.s[k] == " ":
                k += 1
            if k < len(self.s) and self.s[k] != "\n":
                return k, k - start
            j = self.s.find("\n", k) if k < len(self.s) else -1
        return len(self.s), -1

    def rest_of_line_blank(self) -> bool:
        j = self.i
        while j < len(self.s) and self.s[j] == " ":
            j += 1
        return j >= len(self.s) or self.s[j] == "\n"

    def is_seq_entry(self, pos: int) -> bool:
        return pos < len(self.s) and self.s[pos] == "-" and (
            pos + 1 >= len(self.s) or self.s[pos + 1] in " \n")

    # documents and blocks

    def document(self) -> Any:
        pos = 0
        while pos < len(self.s) and self.s[pos] in " \n":
            pos += 1
        if pos >= len(self.s):
            return None
        self.i = pos
        value = self.block_node(self.column(), -1)
        if not self.rest_of_line_blank() or self.next_line()[1] != -1:
            raise self.error("unexpected content")
        return value

    def block_node(self, indent: int, parent: int) -> Any:
        """The node starting at the current position (column ``indent``)
        inside a block of indent ``parent``."""
        ch = self.peek()
        if ch == "&":
            name = self.anchor_name()
            if self.rest_of_line_blank():
                pos, n = self.next_line()
                if n <= parent and not (n == parent and self.is_seq_entry(pos)):
                    value = None
                else:
                    self.i = pos
                    value = self.block_node(n, parent)
            else:
                self.skip_spaces()
                value = self.block_node(self.column(), parent)
            self.anchors[name] = value
            return value
        if ch == "*":
            name = self.anchor_name()
            if name not in self.anchors:
                raise self.error(f"unknown alias {name!r}")
            return self.anchors[name]
        if self.is_seq_entry(self.i):
            return self.block_sequence(indent)
        if ch in "{[":
            return self.empty_flow()
        start = self.i
        value = self.scalar(parent)
        if self.peek() == ":" and self.peek(1) in " \n\0":  # it was a key
            self.i = start
            return self.block_mapping(indent)
        return value

    def anchor_name(self) -> str:
        self.i += 1
        start = self.i
        while self.peek() not in " \n\0":
            self.i += 1
        return self.s[start:self.i]

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.i += 1

    def empty_flow(self) -> Any:
        pair = self.s[self.i:self.i + 2]
        if pair not in ("{}", "[]"):
            raise self.error("flow collections with content are not read")
        self.i += 2
        return {} if pair == "{}" else []

    def block_mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            if self.peek() == "?" and self.peek(1) in " \n\0":
                raise self.error("complex keys are not read")
            key = self.scalar(indent)
            if not (self.peek() == ":" and self.peek(1) in " \n\0"):
                raise self.error("expected ':' after a key")
            self.i += 1
            if self.rest_of_line_blank():
                pos, n = self.next_line()
                if n > indent or (n == indent and self.is_seq_entry(pos)):
                    self.i = pos
                    out[key] = self.block_node(n, indent)
                else:
                    out[key] = None
            else:
                self.skip_spaces()
                out[key] = self.block_node(self.column(), indent)
            if not self.rest_of_line_blank():
                raise self.error("unexpected content after a value")
            pos, n = self.next_line()
            if n != indent or self.is_seq_entry(pos):
                if n > indent:
                    raise self.error("bad indentation")
                return out
            self.i = pos

    def block_sequence(self, indent: int) -> list:
        out: list = []
        while True:
            self.i += 1  # the dash
            if self.rest_of_line_blank():
                pos, n = self.next_line()
                if n > indent:
                    self.i = pos
                    out.append(self.block_node(n, indent))
                else:
                    out.append(None)
            else:
                self.skip_spaces()
                out.append(self.block_node(self.column(), indent))
            if not self.rest_of_line_blank():
                raise self.error("unexpected content after an item")
            pos, n = self.next_line()
            if n != indent or not self.is_seq_entry(pos):
                if n > indent:
                    raise self.error("bad indentation")
                return out
            self.i = pos

    # scalars

    def scalar(self, parent: int) -> Any:
        """The scalar here; a plain one ends at ': ' on its line (a key) or
        runs on over lines more indented than ``parent``."""
        ch = self.peek()
        if ch == "'":
            return self.single()
        if ch == '"':
            return self.double()
        if ch in "&*!|>%@`#,[]{}":
            raise self.error(f"unsupported indicator {ch!r}")
        return _construct(self.plain(parent))

    def plain(self, parent: int) -> str:
        chunks = []
        line = self.plain_line()
        chunks.append(line)
        # continuation lines: more indented than the enclosing block, and
        # not after a key (the text stopped at ': ')
        while self.peek() != ":" and self.rest_of_line_blank():
            pos, n = self.next_line()
            if n <= parent:
                break
            breaks = self.s.count("\n", self.i, pos)
            save = self.i
            self.i = pos
            more = self.plain_line()
            if self.peek() == ":" and self.peek(1) in " \n\0":
                self.i = save
                break
            chunks.append("\n" * (breaks - 1) if breaks > 1 else " ")
            chunks.append(more)
        return "".join(chunks)

    def plain_line(self) -> str:
        start = self.i
        while True:
            ch = self.peek()
            if ch in "\n\0":
                break
            if ch == ":" and self.peek(1) in " \n\0":
                break
            if ch == "#" and self.i > start and self.s[self.i - 1] == " ":
                raise self.error("comments are not read")
            self.i += 1
        text = self.s[start:self.i]
        stripped = text.rstrip(" ")
        self.i -= len(text) - len(stripped)
        return stripped

    def spaces(self) -> str:
        """A run of spaces and line breaks inside a quoted scalar: the
        spaces as they are, unless a line break ends them; then the run is
        folded (one break a space, n breaks n - 1 newlines, the spaces
        around them dropped)."""
        j = self.i
        while j < len(self.s) and self.s[j] == " ":
            j += 1
        if j >= len(self.s) or self.s[j] != "\n":
            run, self.i = self.s[self.i:j], j
            return run
        breaks = 0
        self.i = j
        while self.peek() in " \n":
            breaks += self.peek() == "\n"
            self.i += 1
        return " " if breaks == 1 else "\n" * (breaks - 1)

    def single(self) -> str:
        self.i += 1
        out = []
        while True:
            ch = self.peek()
            if self.i >= len(self.s):
                raise self.error("unterminated single-quoted scalar")
            if ch == "'":
                if self.peek(1) == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if ch in " \n":
                out.append(self.spaces())
                continue
            out.append(ch)
            self.i += 1

    _UNESCAPE = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0a",
                 "v": "\x0b", "f": "\x0c", "r": "\x0d", "e": "\x1b", " ": " ", '"': '"',
                 "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}

    def double(self) -> str:
        self.i += 1
        out = []
        while True:
            ch = self.peek()
            if self.i >= len(self.s):
                raise self.error("unterminated double-quoted scalar")
            if ch == '"':
                self.i += 1
                return "".join(out)
            if ch == "\\":
                nxt = self.peek(1)
                if nxt in self._UNESCAPE:
                    out.append(self._UNESCAPE[nxt])
                    self.i += 2
                elif nxt in "xuU":
                    width = {"x": 2, "u": 4, "U": 8}[nxt]
                    out.append(chr(int(self.s[self.i + 2:self.i + 2 + width], 16)))
                    self.i += 2 + width
                elif nxt == "\n":  # an escaped line break: joined without a space,
                    self.i += 2    # each empty line after it a newline
                    while True:
                        self.skip_spaces()
                        if self.peek() != "\n":
                            break
                        out.append("\n")
                        self.i += 1
                else:
                    raise self.error(f"unknown escape \\{nxt}")
                continue
            if ch in " \n":
                out.append(self.spaces())
                continue
            out.append(ch)
            self.i += 1


def safe_load(text: str) -> Any:
    """``yaml.safe_load(text)`` for a text of the subset."""
    return _Reader(text).document()
