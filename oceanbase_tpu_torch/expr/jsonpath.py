"""JSON path evaluation over dictionary-encoded documents.

Reference surface: the ob_expr_json_* family under src/sql/engine/expr/
(ob_expr_json_extract.cpp, ob_expr_json_unquote.cpp, ...) and the
ObJsonPath parser (src/share/json_type). The reference evaluates paths
per ROW over a binary JSON format; the columnar rebuild evaluates each
path ONCE per DISTINCT document (documents are dict-encoded varchar, so
the dictionary is the set of distinct docs) and rows map through their
int32 codes — the same LUT recipe as every string function in
expr/compile.py. Parsing cost is O(distinct docs), device cost is one
gather.

Path grammar (the MySQL subset that covers the ob_expr_json tests):
    $                whole document
    .key   ."a b"    object member
    [N]              array element (non-negative)
Chained arbitrarily: $.a.b[0]."c d".
"""

from __future__ import annotations

import json


class JsonPathError(ValueError):
    pass


_MISSING = object()  # sentinel: path not present (differs from JSON null)


def parse_path(path: str) -> tuple:
    """'$' '.key' '[0]' chain -> tuple of steps (str member | int index)."""
    s = path.strip()
    if not s.startswith("$"):
        raise JsonPathError(f"JSON path must start with $: {path!r}")
    i, steps = 1, []
    while i < len(s):
        c = s[i]
        if c == ".":
            i += 1
            if i < len(s) and s[i] == '"':
                # backslash escapes inside quoted members ($."a\"b")
                j, buf = i + 1, []
                while j < len(s) and s[j] != '"':
                    if s[j] == "\\" and j + 1 < len(s):
                        buf.append(s[j + 1])
                        j += 2
                    else:
                        buf.append(s[j])
                        j += 1
                if j >= len(s):
                    raise JsonPathError(f"unterminated quote in {path!r}")
                steps.append("".join(buf))
                i = j + 1
            else:
                j = i
                while j < len(s) and s[j] not in ".[":
                    j += 1
                if j == i:
                    raise JsonPathError(f"empty member name in {path!r}")
                steps.append(s[i:j])
                i = j
        elif c == "[":
            j = s.find("]", i)
            if j < 0:
                raise JsonPathError(f"missing ] in {path!r}")
            idx = s[i + 1:j].strip()
            if not idx.isdigit():
                raise JsonPathError(f"bad array index in {path!r}")
            steps.append(int(idx))
            i = j + 1
        else:
            raise JsonPathError(f"unexpected {c!r} in {path!r}")
    return tuple(steps)


def _walk(doc, steps):
    cur = doc
    for st in steps:
        if isinstance(st, str):
            if not isinstance(cur, dict) or st not in cur:
                return _MISSING
            cur = cur[st]
        else:
            if not isinstance(cur, list) or st >= len(cur):
                return _MISSING
            cur = cur[st]
    return cur


def json_repr(v) -> str:
    """MySQL-style JSON text (', '/': ' separators, like JSON_OBJECT)."""
    return json.dumps(v, separators=(", ", ": "), ensure_ascii=False)


def extract_repr(doc_text: str, steps: tuple) -> str | None:
    """json_extract: JSON representation of the value at path, or None
    (SQL NULL) when the document is invalid or the path is missing."""
    try:
        doc = json.loads(doc_text)
    except (ValueError, TypeError):
        return None
    v = _walk(doc, steps)
    if v is _MISSING:
        return None
    return json_repr(v)


def unquote(json_text: str | None) -> str | None:
    """json_unquote: a quoted JSON string loses its quotes; everything
    else (numbers, objects, arrays, true/false/null) keeps its JSON text.
    SQL NULL propagates."""
    if json_text is None:
        return None
    t = json_text.strip()
    if t.startswith('"'):
        try:
            v = json.loads(t)
        except ValueError:
            return json_text
        if isinstance(v, str):
            return v
    return json_text


def json_type_of(json_text: str | None) -> str | None:
    """json_type over a JSON text fragment (MySQL type names)."""
    if json_text is None:
        return None
    try:
        v = json.loads(json_text)
    except (ValueError, TypeError):
        return None
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER"
    if isinstance(v, float):
        return "DOUBLE"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, list):
        return "ARRAY"
    return "OBJECT"


def array_length(doc_text: str, steps: tuple = ()) -> int | None:
    try:
        doc = json.loads(doc_text)
    except (ValueError, TypeError):
        return None
    v = _walk(doc, steps)
    if v is _MISSING or not isinstance(v, list):
        return None
    return len(v)


def is_valid(doc_text: str) -> bool:
    try:
        json.loads(doc_text)
        return True
    except (ValueError, TypeError):
        return False
