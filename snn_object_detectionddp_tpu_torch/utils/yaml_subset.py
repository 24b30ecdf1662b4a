"""A reader for the subset of YAML that the repo's config files use.

The port's only config reader: the machine the port runs on need not have
PyYAML. It reads what ``yaml.safe_load`` reads for these files, value for
value:

- block mappings nested by indentation (spaces only);
- ``#`` comments, on a line of their own or after a value;
- plain, single-quoted and double-quoted scalars;
- flow lists of scalars on one line (``image_size: [480, 640]``);
- empty values, ``null`` and ``~``;
- one optional ``---`` before the document.

Plain scalars resolve by YAML 1.1's rules, as PyYAML's resolver does them:
``5e-4`` is the STRING ``'5e-4'`` (a float needs a dot), ``1.0e-4`` a float,
``yes`` / ``on`` / ``no`` / ``off`` / ``true`` / ``false`` (lower, Title or
UPPER case) booleans, leading-zero integers octal, ``1_000`` an integer.
Anything outside the subset raises ``ValueError`` with the line number:
anchors, aliases, tags, ``|`` and ``>`` blocks, flow mappings, block
sequences, multi-line scalars, several documents, tabs, backslash escapes,
and the numbers and dates this reader does not resolve (``0b``/``0x``
integers, ``1:30`` base 60, ``2024-01-31``).
"""

from __future__ import annotations

import re

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1, in the decimal
# and octal forms only.
_INT = re.compile(r"^[-+]?(?:0[0-7_]+|0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"""^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
# What PyYAML would read as a binary, hex or base-60 number or as a date.
_OUTSIDE = re.compile(r"""^(?:[-+]?0[bx]
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$
                      |[0-9]{4}-[0-9][0-9]?-[0-9][0-9]?(?:[Tt ]|$))""", re.X)
# A plain scalar may not start with these (YAML's indicators).
_UNSUPPORTED_START = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                      ">": "block scalars", "{": "flow mappings", "%": "directives",
                      "@": "reserved indicators", "`": "reserved indicators",
                      "?": "complex keys"}


def _resolve_plain(text: str, line_no: int):
    """A plain scalar's value by YAML 1.1's implicit resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _OUTSIDE.match(text):
        raise ValueError(f"line {line_no}: {text!r} is a binary, hex or base-60 number or a "
                         "date, outside the supported YAML subset")
    if _INT.match(text):
        digits = text.replace("_", "")
        octal = digits.lstrip("+-")[:1] == "0" and digits.lstrip("+-") != "0"
        return int(digits, 8 if octal else 10)
    if _FLOAT.match(text):
        digits = text.replace("_", "").lower()
        return float(digits.replace(".inf", "inf").replace(".nan", "nan"))
    return text


def _quoted(text: str, line_no: int) -> tuple[str, str]:
    """Split a quoted scalar off the front of ``text``: (value, rest)."""
    quote = text[0]
    i = 1
    while True:
        j = text.find(quote, i)
        if j < 0:
            raise ValueError(f"line {line_no}: unterminated quoted scalar (multi-line "
                             "scalars are outside the supported YAML subset)")
        if quote == "'" and text[j + 1 : j + 2] == "'":  # '' is one quote
            i = j + 2
            continue
        break
    body = text[1:j]
    if quote == '"' and "\\" in body:
        raise ValueError(f"line {line_no}: backslash escapes are outside the supported YAML "
                         "subset")
    return (body.replace("''", "'") if quote == "'" else body), text[j + 1 :]


def _strip_comment(text: str, line_no: int) -> str:
    """``text`` without a trailing comment; a comment starts at a ``#``
    after whitespace (or at the start)."""
    for i, ch in enumerate(text):
        if ch == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip(" ")
    return text.rstrip(" ")


def _rest_is_empty(rest: str, line_no: int) -> None:
    rest = rest.lstrip(" ")
    if rest and not rest.startswith("#"):
        raise ValueError(f"line {line_no}: unexpected text after a quoted scalar: {rest!r}")


def _scalar(text: str, line_no: int, in_flow: bool = False):
    """One scalar from ``text`` (comment already stripped for plain ones)."""
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, line_no)
        _rest_is_empty(rest, line_no)
        return value
    if text[:1] in _UNSUPPORTED_START:
        raise ValueError(f"line {line_no}: {_UNSUPPORTED_START[text[0]]} are outside the "
                         f"supported YAML subset: {text!r}")
    if text[:2] == "- " or text == "-":
        raise ValueError(f"line {line_no}: block sequences are outside the supported YAML subset")
    if text[:1] == "[" or (in_flow and text[:1] in "[]{},"):
        raise ValueError(f"line {line_no}: nested flow collections are outside the supported "
                         "YAML subset")
    if ": " in text or text.endswith(":"):
        raise ValueError(f"line {line_no}: a mapping inside a value: {text!r}")
    return _resolve_plain(text, line_no)


def _flow_list(text: str, line_no: int) -> list:
    """``[a, "b", 3]`` on one line, scalars only."""
    items, rest = [], text[1:].lstrip(" ")
    if rest.startswith("]"):
        _rest_is_empty(rest[1:], line_no)
        return items
    while True:
        if rest[:1] in ("'", '"'):
            value, rest = _quoted(rest, line_no)
        else:
            end = min((i for i in (rest.find(","), rest.find("]")) if i >= 0), default=-1)
            if end < 0:
                raise ValueError(f"line {line_no}: unterminated flow list (multi-line flow "
                                 "collections are outside the supported YAML subset)")
            token, rest = rest[:end].strip(" "), rest[end:]
            if not token:
                raise ValueError(f"line {line_no}: empty item in a flow list")
            value = _scalar(token, line_no, in_flow=True)
        items.append(value)
        rest = rest.lstrip(" ")
        if rest.startswith(","):
            rest = rest[1:].lstrip(" ")
            if rest.startswith("]"):  # a trailing comma
                _rest_is_empty(rest[1:], line_no)
                return items
        elif rest.startswith("]"):
            _rest_is_empty(rest[1:], line_no)
            return items
        else:
            raise ValueError(f"line {line_no}: expected ',' or ']' in a flow list: {rest!r}")


def _split_key(content: str, line_no: int) -> tuple[object, str]:
    """``key: value`` -> (resolved key, value text)."""
    if content[:1] in ("'", '"'):
        key, rest = _quoted(content, line_no)
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            raise ValueError(f"line {line_no}: expected ':' after a quoted key")
        return key, rest[1:].strip(" ")
    m = re.search(r":( |$)", content)
    if m is None:
        raise ValueError(f"line {line_no}: expected 'key: value', got {content!r} (multi-line "
                         "scalars are outside the supported YAML subset)")
    key_text = content[: m.start()].rstrip(" ")
    if not key_text:
        raise ValueError(f"line {line_no}: empty key")
    return _scalar(key_text, line_no), content[m.end() :].strip(" ")


def parse(text: str):
    """Parse ``text`` and return a dict (or None for an empty document),
    equal to what ``yaml.safe_load`` returns for the supported subset."""
    root: dict = {}
    # Open mappings, innermost last: (indent, mapping). A key whose value
    # is empty opens a child mapping at a deeper indent, if one follows.
    stack: list[tuple[int, dict]] = [(-1, root)]
    pending = None  # (indent of the key, mapping, key) awaiting a nested block
    seen_content, seen_start = False, False
    for line_no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise ValueError(f"line {line_no}: tabs are outside the supported YAML subset")
        stripped = raw.strip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if raw.startswith(("---", "...")) and raw[3:4] in ("", " "):
            if seen_content or seen_start or raw.startswith("..."):
                raise ValueError(f"line {line_no}: multi-document files are outside the "
                                 "supported YAML subset")
            if _strip_comment(raw[3:], line_no):
                raise ValueError(f"line {line_no}: content after '---'")
            seen_start = True
            continue
        if raw.startswith("%"):
            raise ValueError(f"line {line_no}: directives are outside the supported YAML subset")
        indent = len(raw) - len(raw.lstrip(" "))
        if not seen_content:  # the top-level mapping's indent
            stack = [(indent, root)]
        seen_content = True
        if pending is not None:
            key_indent, parent, key = pending
            pending = None
            if indent > key_indent:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"line {line_no}: indentation {indent} does not match an open "
                             f"mapping (at {stack[-1][0]})")
        mapping = stack[-1][1]
        key, value_text = _split_key(raw[indent:].rstrip(" "), line_no)
        if value_text[:1] in ("'", '"'):
            value, rest = _quoted(value_text, line_no)
            _rest_is_empty(rest, line_no)
        elif value_text[:1] == "[":
            value = _flow_list(value_text, line_no)
        else:
            value_text = _strip_comment(value_text, line_no)
            value = _scalar(value_text, line_no)
        mapping[key] = value
        if value_text == "":
            pending = (indent, mapping, key)
    if not seen_content:
        return None
    return root
