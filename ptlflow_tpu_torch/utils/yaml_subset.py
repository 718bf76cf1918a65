"""A reader for the YAML the repo's configs are written in, without PyYAML.

``safe_load(text)`` returns what ``yaml.safe_load`` returns for the subset
that ``datasets.yaml``, ``configs/results/*.yaml`` and the model training
configs use: block mappings nested by indentation, block sequences of
scalars, flow sequences and mappings (``[368, 496]``, ``{gamma: 0.85}``),
comments, quoted and plain scalars resolved as YAML 1.1 does (null, bool,
decimal int, float).  Anything else (anchors, aliases, tags, block scalars,
several documents, octal/hex/sexagesimal numbers, dates, tabs) raises
``YamlSubsetError`` with the line, rather than being read otherwise than
PyYAML reads it.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, Tuple, Union

# PyYAML's implicit resolvers (yaml/resolver.py), decimal and float forms
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
# forms PyYAML resolves that this reader does not: octal, binary, hex and
# sexagesimal numbers, timestamps
_OTHER = re.compile(r"""^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                    |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)$""", re.X)
_NULL = {"~", "null", "Null", "NULL", ""}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}


class YamlSubsetError(ValueError):
    """YAML outside the subset this reader handles."""


def load(path: Union[str, Path]) -> Any:
    """``yaml.safe_load`` of a file, for the subset above."""
    return safe_load(Path(path).read_text())


def safe_load(text: str) -> Any:
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][1])
    if i != len(lines):
        raise YamlSubsetError(f"line {lines[i][0]}: unexpected indentation")
    return value


def _lines(text: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content without comment) of each line that
    holds anything."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw, n).rstrip()
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise YamlSubsetError(f"line {n}: tab in indentation")
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise YamlSubsetError(f"line {n}: document markers and "
                                  f"directives are not supported")
        out.append((n, len(body) - len(stripped), stripped))
    return out


def _strip_comment(line: str, n: int) -> str:
    quote = None
    for k, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (k == 0 or line[k - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (k == 0 or line[k - 1] in " \t"):
            return line[:k]
    if quote:
        raise YamlSubsetError(f"line {n}: unterminated quote")
    return line


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """The block value starting at ``lines[i]``, whose indent is
    ``indent``: a sequence if it starts with '- ', else a mapping."""
    n, ind, text = lines[i]
    if text == "-" or text.startswith("- "):
        return _sequence(lines, i, indent)
    if _split_key(text, n) is None:
        if i + 1 < len(lines) and lines[i + 1][1] >= indent:
            raise YamlSubsetError(f"line {n}: multi-line scalars are not "
                                  f"supported")
        return _scalar(text, n), i + 1
    return _mapping(lines, i, indent)


def _sequence(lines, i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines) and lines[i][1] == indent:
        n, _, text = lines[i]
        if not (text == "-" or text.startswith("- ")):
            break
        item = text[1:].strip()
        if not item or _split_key(item, n) is not None:
            raise YamlSubsetError(f"line {n}: only scalars and flow "
                                  f"collections as sequence items")
        out.append(_scalar(item, n))
        i += 1
    return out, i


def _mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines) and lines[i][1] == indent:
        n, _, text = lines[i]
        kv = _split_key(text, n)
        if kv is None:
            raise YamlSubsetError(f"line {n}: expected 'key: value'")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _scalar(rest, n)
        elif i < len(lines) and (lines[i][1] > indent or (
                lines[i][1] == indent and (lines[i][2] == "-"
                                           or lines[i][2].startswith("- ")))):
            out[key], i = _block(lines, i, lines[i][1])
        else:
            out[key] = None
    if i < len(lines) and lines[i][1] > indent:
        raise YamlSubsetError(f"line {lines[i][0]}: unexpected indentation")
    return out, i


def _split_key(text: str, n: int):
    """(key, rest) of 'key: rest' or 'key:', or None for a plain scalar."""
    if text[0] in "[{":
        return None
    if text[0] in "'\"":
        end = text.find(text[0], 1)
        key_text, after = text[:end + 1], text[end + 1:]
        if not after.startswith(":"):
            return None
        return _scalar(key_text, n), after[1:].strip()
    m = re.match(r"^([^:]*?):(?:\s+(.*))?$", text)
    if m is None:
        return None
    return _scalar(m.group(1), n), (m.group(2) or "").strip()


def _scalar(text: str, n: int) -> Any:
    text = text.strip()
    if text[:1] in "[{":
        value, k = _flow(text, 0, n)
        if text[k:].strip():
            raise YamlSubsetError(f"line {n}: text after a flow collection")
        return value
    if text[:1] in ("&", "*", "!", "|", ">", "?", "@", "`"):
        raise YamlSubsetError(f"line {n}: '{text[0]}' (anchors, aliases, "
                              f"tags, block scalars) is not supported")
    if text[:1] in "'\"":
        return _quoted(text, n)
    if ": " in text or text.endswith(":"):
        raise YamlSubsetError(f"line {n}: nested 'key: value' on one line")
    if text == "-" or text.startswith("- "):
        raise YamlSubsetError(f"line {n}: a sequence entry after a key on "
                              f"one line")
    return _resolve(text, n)


def _resolve(text: str, n: int) -> Any:
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    if _OTHER.match(text):
        raise YamlSubsetError(f"line {n}: '{text}' (octal, hex, binary, "
                              f"sexagesimal or a date) is not supported")
    return text


def _quoted(text: str, n: int) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise YamlSubsetError(f"line {n}: text after a quoted scalar")
    body = text[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise YamlSubsetError(f"line {n}: quote inside a quoted scalar")
        return body.replace("''", "'")
    if "\\" in body:
        raise YamlSubsetError(f"line {n}: escapes in double-quoted scalars "
                              f"are not supported")
    if '"' in body:
        raise YamlSubsetError(f"line {n}: quote inside a quoted scalar")
    return body


def _flow(text: str, k: int, n: int) -> Tuple[Any, int]:
    """A flow sequence or mapping starting at ``text[k]``; returns the
    value and the index after its closing bracket."""
    close = "]" if text[k] == "[" else "}"
    is_map = close == "}"
    items, out_map = [], {}
    k += 1
    while True:
        while k < len(text) and text[k] == " ":
            k += 1
        if k >= len(text):
            raise YamlSubsetError(f"line {n}: unterminated flow collection")
        if text[k] == close:
            return (out_map if is_map else items), k + 1
        if text[k] in "[{":
            value, k = _flow(text, k, n)
            entry = None
        else:
            start, depth, quote = k, 0, None
            while k < len(text):
                ch = text[k]
                if quote:
                    quote = None if ch == quote else quote
                elif ch in "'\"" and k == start:
                    quote = ch
                elif ch in "[{":
                    depth += 1
                elif ch in ",]}" and depth == 0:
                    break
                elif ch in "]}":
                    depth -= 1
                k += 1
            entry = text[start:k].strip()
            value = None
        if is_map:
            if entry is None:
                raise YamlSubsetError(f"line {n}: a collection as a flow "
                                      f"mapping key")
            kv = _split_key(entry, n)
            if kv is None:
                raise YamlSubsetError(f"line {n}: expected 'key: value' in "
                                      f"a flow mapping")
            key, rest = kv
            out_map[key] = _scalar(rest, n) if rest else None
        else:
            items.append(value if entry is None else _scalar(entry, n))
        while k < len(text) and text[k] == " ":
            k += 1
        if k < len(text) and text[k] == ",":
            k += 1
        elif k < len(text) and text[k] != close:
            raise YamlSubsetError(f"line {n}: expected ',' or '{close}'")
