"""Incremental parsing helpers for streamed output (reference
common/json-partial.{h,cpp} and common/regex-partial.{h,cpp}): close off a
truncated JSON document so tool-call arguments parse mid-stream, and detect
partial matches of a stop/trigger pattern at the end of a buffer.

The port's own copy of llamacog_tpu/runtime/partial.py (it imports no JAX).
"""

from __future__ import annotations

import json


def parse_json_partial(text: str):
    """Parse a possibly-truncated JSON document; returns (value, consumed,
    healed) where `healed` is True when closing tokens were synthesized
    (common_json_parse's healing marker behavior). Raises ValueError when
    the text can't be made valid."""
    text = text.lstrip()
    if not text:
        raise ValueError("empty input")
    try:
        dec = json.JSONDecoder()
        val, end = dec.raw_decode(text)
        return val, end, False
    except json.JSONDecodeError:
        pass
    healed = _heal(text)
    if healed is None:
        raise ValueError("unparseable partial JSON")
    return json.loads(healed), len(text), True


def _heal(text: str) -> str | None:
    """Append the minimal closers (quote, brackets, braces) that make a
    truncated JSON prefix parse."""
    stack = []
    in_str = False
    esc = False
    for ch in text:
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch in "[{":
            stack.append("]" if ch == "[" else "}")
        elif ch in "]}":
            if not stack or stack[-1] != ch:
                return None
            stack.pop()
    out = text
    if esc:
        out = out[:-1]
    if in_str:
        out += '"'
    # drop a trailing comma / dangling key before closing
    for _ in range(2):
        stripped = out.rstrip()
        if stripped.endswith(","):
            out = stripped[:-1]
        elif stripped.endswith(":"):
            out = stripped + " null"
    while stack:
        out += stack.pop()
    try:
        json.loads(out)
        return out
    except json.JSONDecodeError:
        return None


def partial_stop_match(text: str, stop: str) -> int:
    """Length of the longest suffix of `text` that is a proper prefix of
    `stop` (string_find_partial_stop, common/common.cpp): the streamer must
    hold back that many chars in case the stop string completes next chunk."""
    for n in range(min(len(stop) - 1, len(text)), 0, -1):
        if text.endswith(stop[:n]):
            return n
    return 0


class PartialRegex:
    """regex-partial role (common/regex-partial.h): match a pattern against
    a stream, reporting where a suffix could still grow into a match (so the
    streamer holds those chars back). Uses the `regex` module's partial-match
    support (the role of the reference's reversed-pattern trick)."""

    def __init__(self, pattern: str):
        import regex

        self.pattern = pattern
        self._re = regex.compile(pattern)

    def match(self, text: str):
        """Returns (match_or_None, partial_start): partial_start is the
        earliest index whose suffix is a viable match prefix (-1 if none)."""
        import regex

        m = self._re.search(text)
        if m:
            return m, -1
        pm = self._re.search(text, partial=True)
        if pm is not None and pm.partial and pm.start() < len(text):
            return None, pm.start()
        return None, -1
