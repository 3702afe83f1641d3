"""GBNF grammar-constrained decoding.

A pushdown automaton over Unicode code points with a parallel stack set and
partial-UTF8 tracking, the same computational model as the reference engine
(src/llama-grammar.h:13-122, llama-grammar.cpp), re-implemented for the
lazy-grammar sampling trick (common/sampling.h:20-25): check only the sampled
token; on violation build a mask and resample.

Grammar language: GBNF (grammars/README.md) — rules `name ::= ...`, string
literals with escapes, char classes with ranges and negation, `.`,
alternation, grouping, repetition `? * + {m} {m,} {m,n}`, comments.

The port's own copy of llamacog_tpu/runtime/grammar.py (it imports no JAX).
"""

from __future__ import annotations

from dataclasses import dataclass


# a terminal matcher: ("any",) | (negated: bool, ranges: tuple[(lo, hi), ...])
# an item: ("t", matcher) | ("r", rule_id)


class GrammarParseError(ValueError):
    pass


@dataclass
class Grammar:
    rules: list[list[list[tuple]]]  # rule -> alternates -> items
    root_id: int
    names: dict[str, int]


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.names: dict[str, int] = {}
        self.rules: dict[int, list[list[tuple]]] = {}

    # -- lexing helpers -----------------------------------------------------
    def _ws(self, newlines: bool) -> None:
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":
                while self.pos < len(self.text) and self.text[self.pos] not in "\r\n":
                    self.pos += 1
            elif c in " \t":
                self.pos += 1
            elif c in "\r\n":
                if not newlines:
                    # a newline followed by | continues the rule
                    save = self.pos
                    while self.pos < len(self.text) and self.text[self.pos] in " \t\r\n":
                        self.pos += 1
                    if self.pos < len(self.text) and self.text[self.pos] == "|":
                        continue
                    self.pos = save
                    return
                self.pos += 1
            else:
                return

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        start = self.pos
        while (p := self._peek()) and (p.isalnum() or p in "-_"):
            self.pos += 1
        if start == self.pos:
            raise GrammarParseError(f"expected name at {self.pos}")
        return self.text[start : self.pos]

    def _rule_id(self, name: str) -> int:
        if name not in self.names:
            self.names[name] = len(self.names)
        return self.names[name]

    def _new_rule(self, alternates: list[list[tuple]]) -> int:
        rid = len(self.names)
        self.names[f"<anon-{rid}>"] = rid
        self.rules[rid] = alternates
        return rid

    def _char(self) -> int:
        c = self._peek()
        if not c:
            raise GrammarParseError("unexpected end in char")
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self._peek()
        self.pos += 1
        simple = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91, "]": 93, "^": 94, "-": 45}
        if e in simple:
            return simple[e]
        if e in ("x", "u", "U"):
            n = {"x": 2, "u": 4, "U": 8}[e]
            hexs = self.text[self.pos : self.pos + n]
            self.pos += n
            return int(hexs, 16)
        raise GrammarParseError(f"unknown escape \\{e}")

    # -- grammar ------------------------------------------------------------
    def parse(self) -> Grammar:
        self._ws(True)
        while self.pos < len(self.text):
            name = self._name()
            rid = self._rule_id(name)
            self._ws(True)
            if self.text[self.pos : self.pos + 3] != "::=":
                raise GrammarParseError(f"expected ::= after {name!r}")
            self.pos += 3
            self._ws(True)
            self.rules[rid] = self._alternates(nested=False)
            self._ws(True)
        if "root" not in self.names:
            raise GrammarParseError("grammar has no root rule")
        n = len(self.names)
        table: list[list[list[tuple]]] = [[] for _ in range(n)]
        for rid, alts in self.rules.items():
            table[rid] = alts
        for name, rid in self.names.items():
            if not table[rid]:
                raise GrammarParseError(f"undefined rule {name!r}")
        return Grammar(table, self.names["root"], dict(self.names))

    def _alternates(self, nested: bool) -> list[list[tuple]]:
        alts = [self._sequence(nested)]
        self._ws(nested)
        while self._peek() == "|":
            self.pos += 1
            self._ws(True)
            alts.append(self._sequence(nested))
            self._ws(nested)
        return alts

    def _sequence(self, nested: bool) -> list[tuple]:
        items: list[tuple] = []
        last_start = 0  # index of the item a postfix operator applies to
        while True:
            self._ws(nested)
            c = self._peek()
            if c == '"':
                self.pos += 1
                last_start = len(items)
                while self._peek() != '"':
                    cp = self._char()
                    items.append(("t", (False, ((cp, cp),))))
                self.pos += 1
                # a repetition after a literal applies to the LAST char only
                last_start = len(items) - 1 if items else 0
            elif c == "[":
                self.pos += 1
                negated = False
                if self._peek() == "^":
                    negated = True
                    self.pos += 1
                ranges = []
                while self._peek() != "]":
                    lo = self._char()
                    hi = lo
                    if self._peek() == "-" and self.text[self.pos + 1] != "]":
                        self.pos += 1
                        hi = self._char()
                    ranges.append((lo, hi))
                self.pos += 1
                last_start = len(items)
                items.append(("t", (negated, tuple(ranges))))
            elif c == ".":
                self.pos += 1
                last_start = len(items)
                items.append(("t", ("any",)))
            elif c == "(":
                self.pos += 1
                self._ws(True)
                sub = self._alternates(nested=True)
                self._ws(True)
                if self._peek() != ")":
                    raise GrammarParseError(f"expected ) at {self.pos}")
                self.pos += 1
                rid = self._new_rule(sub)
                last_start = len(items)
                items.append(("r", rid))
            elif c and (c.isalnum() or c in "-_"):
                save = self.pos
                name = self._name()
                after_name = self.pos
                # "name ::=" means the next rule starts here — backtrack
                self._ws(True)
                if self.text[self.pos : self.pos + 3] == "::=":
                    self.pos = save
                    break
                self.pos = after_name
                last_start = len(items)
                items.append(("r", self._rule_id(name)))
            else:
                break
            # postfix repetition operators
            self._ws(nested)
            op = self._peek()
            if op and op in "*+?":
                self.pos += 1
                mn, mx = {"*": (0, -1), "+": (1, -1), "?": (0, 1)}[op]
                items = self._repeat(items, last_start, mn, mx)
            elif op == "{":
                self.pos += 1
                self._ws(False)
                mn = self._int()
                self._ws(False)
                if self._peek() == ",":
                    self.pos += 1
                    self._ws(False)
                    mx = self._int() if self._peek() != "}" else -1
                else:
                    mx = mn
                if self._peek() != "}":
                    raise GrammarParseError(f"expected }} at {self.pos}")
                self.pos += 1
                items = self._repeat(items, last_start, mn, mx)
        return items

    def _int(self) -> int:
        start = self.pos
        while self._peek().isdigit():
            self.pos += 1
        if start == self.pos:
            raise GrammarParseError(f"expected number at {self.pos}")
        return int(self.text[start : self.pos])

    def _repeat(self, items: list[tuple], start: int, mn: int, mx: int) -> list[tuple]:
        seq = items[start:]
        head = items[:start]
        out = head + seq * mn
        if mx < 0:
            # S{m,}: R ::= S R | ε
            rid = self._new_rule([[], []])
            self.rules[rid] = [seq + [("r", rid)], []]
            out.append(("r", rid))
        elif mx > mn:
            # chain of nested optionals, (x (x ...)?)?
            prev = None
            for _ in range(mx - mn):
                body = seq + ([("r", prev)] if prev is not None else [])
                prev = self._new_rule([body, []])
            out.append(("r", prev))
        return out


def parse_gbnf(text: str) -> Grammar:
    return _Parser(text).parse()


def _match(matcher: tuple, cp: int) -> bool:
    if matcher[0] == "any":
        return True
    negated, ranges = matcher
    hit = any(lo <= cp <= hi for lo, hi in ranges)
    return hit != negated


class GrammarState:
    """Parallel-stack pushdown state over code points, with partial-UTF8
    carry so multi-byte characters can split across tokens
    (llama-grammar.h:46-49)."""

    def __init__(self, grammar: Grammar, vocab=None):
        self.g = grammar
        self.vocab = vocab
        root = grammar.rules[grammar.root_id]
        stacks: set[tuple] = set()
        for alt in root:
            self._expand(tuple(reversed(alt)), stacks)
        self.stacks = stacks
        self._partial = b""

    def _expand(self, stack: tuple, out: set) -> None:
        """Expand rule refs until the top of stack is a terminal (or empty)."""
        if not stack:
            out.add(stack)
            return
        top = stack[-1]
        if top[0] == "t":
            out.add(stack)
            return
        rest = stack[:-1]
        for alt in self.g.rules[top[1]]:
            self._expand(rest + tuple(reversed(alt)), out)

    # -- core ---------------------------------------------------------------
    def _advance_char(self, stacks: set, cp: int) -> set:
        out: set = set()
        for stack in stacks:
            if stack and stack[-1][0] == "t" and _match(stack[-1][1], cp):
                self._expand(stack[:-1], out)
        return out

    def _advance_text(self, stacks: set, data: bytes, partial: bytes):
        buf = partial + data
        i = 0
        while i < len(buf):
            b = buf[i]
            ln = 1 if b < 0x80 else 2 if b >> 5 == 6 else 3 if b >> 4 == 14 else 4 if b >> 3 == 30 else 1
            if i + ln > len(buf):
                return stacks, buf[i:]  # partial char carried to next token
            try:
                cp = buf[i : i + ln].decode("utf-8")
                cp = ord(cp)
            except UnicodeDecodeError:
                cp = 0xFFFD
            stacks = self._advance_char(stacks, cp)
            if not stacks:
                return stacks, b""
            i += ln
        return stacks, b""

    @property
    def can_end(self) -> bool:
        return any(not s for s in self.stacks)

    def accepts_text(self, data: bytes) -> bool:
        stacks, _ = self._advance_text(self.stacks, data, self._partial)
        return bool(stacks)

    def accepts_token(self, token: int) -> bool:
        if self.vocab is not None and self.vocab.is_eog(token):
            return self.can_end
        piece = self.vocab.token_to_piece(token) if self.vocab else b""
        if not piece:
            return True
        return self.accepts_text(piece)

    def accept_text(self, data: bytes) -> None:
        self.stacks, self._partial = self._advance_text(self.stacks, data, self._partial)
        if not self.stacks:
            raise ValueError("text rejected by grammar")

    def accept_token(self, token: int) -> None:
        if self.vocab is not None and self.vocab.is_eog(token):
            if not self.can_end:
                raise ValueError("EOG not allowed by grammar")
            return
        piece = self.vocab.token_to_piece(token) if self.vocab else b""
        if piece:
            self.accept_text(piece)

    def _vocab_first_cps(self):
        """Cached per-vocab arrays: each token's first codepoint (-2 empty
        piece, -1 undecodable/continuation byte) and a single-char flag."""
        cache = getattr(self.vocab, "_gbnf_first_cps", None)
        if cache is not None:
            return cache
        import numpy as np

        n = self.vocab.n_tokens()
        first = np.full(n, -1, np.int64)
        single = np.zeros(n, bool)
        for t in range(n):
            piece = self.vocab.token_to_piece(t)
            if not piece:
                first[t] = -2
                continue
            b = piece[0]
            ln = 1 if b < 0x80 else 2 if b >> 5 == 6 else 3 if b >> 4 == 14 else 4 if b >> 3 == 30 else 1
            if len(piece) < ln:
                continue  # partial char: full check needed
            try:
                first[t] = ord(piece[:ln].decode("utf-8"))
                single[t] = len(piece) == ln
            except UnicodeDecodeError:
                pass
        self.vocab._gbnf_first_cps = (first, single)
        return first, single

    def token_mask(self):
        """Boolean allow-mask over the vocab.

        Reject-based prefilter (the role of the reference's incremental
        masking, llama-grammar.cpp:163): a token can only be legal if its
        FIRST codepoint matches some terminal at a stack top, so the vocab
        is first filtered with vectorized range checks — only survivors
        (plus EOG and undecodable pieces) walk the pushdown. Single-char
        tokens are decided by the prefilter alone. Cuts the common
        constrained-JSON case from O(V*stacks) Python to O(V) numpy +
        O(candidates)."""
        import numpy as np

        n = self.vocab.n_tokens()
        if self._partial:  # mid-UTF8-char state: prefilter doesn't apply
            mask = np.zeros(n, dtype=bool)
            for t in range(n):
                mask[t] = self.accepts_token(t)
            return mask
        first, single = self._vocab_first_cps()
        allowed_first = np.zeros(n, dtype=bool)
        for top in {st[-1] for st in self.stacks if st}:
            matcher = top[1]  # stack tops are ("t", char-class) terminals
            if matcher[0] == "any":
                allowed_first |= first >= 0
                continue
            negated, ranges = matcher
            hit = np.zeros(n, dtype=bool)
            for lo, hi in ranges:
                hit |= (first >= lo) & (first <= hi)
            if negated:
                hit = ~hit & (first >= 0)
            allowed_first |= hit
        mask = np.zeros(n, dtype=bool)
        mask[first == -2] = True  # empty pieces never violate
        # single-char candidates are fully decided by the first-cp match
        mask |= allowed_first & single
        # multi-char or undecodable candidates walk the full pushdown
        cand = np.nonzero((allowed_first & ~single) | (first == -1))[0]
        for t in cand:
            mask[t] = self.accepts_token(t)
        if self.vocab is not None:  # EOG legality is stack-emptiness
            for t in self.vocab.eog_ids:
                if 0 <= t < n:
                    mask[t] = self.can_end
        return mask

    def copy(self) -> "GrammarState":
        st = GrammarState.__new__(GrammarState)
        st.g = self.g
        st.vocab = self.vocab
        st.stacks = set(self.stacks)
        st._partial = self._partial
        return st


def grammar_from_gbnf(text: str, vocab=None) -> GrammarState:
    return GrammarState(parse_gbnf(text), vocab)
