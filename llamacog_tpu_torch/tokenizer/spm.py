"""SentencePiece-style (SPM) tokenizer.

Greedy highest-score bigram merging with byte fallback, matching the
reference algorithm (llama.cpp src/llama-vocab.cpp:109-230 llm_tokenizer_spm,
tokenize loop :2415-2465).
"""

from __future__ import annotations

import heapq

from .vocab import SPM_SPACE, Vocab


class SpmTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def _tokenize_fragment(self, text: str, output: list[int]) -> None:
        v = self.vocab
        # invalid code points (e.g. lone surrogates) become U+FFFD, matching
        # the reference's lenient utf-8 decode (unicode.cpp:620-636)
        data = text.encode("utf-8", errors="replace")
        # split into utf-8 characters (byte spans)
        spans: list[tuple[int, int]] = []  # (start, len) into data
        i = 0
        while i < len(data):
            b = data[i]
            if b < 0x80:
                ln = 1
            elif b >> 5 == 0b110:
                ln = 2
            elif b >> 4 == 0b1110:
                ln = 3
            elif b >> 3 == 0b11110:
                ln = 4
            else:
                ln = 1
            ln = min(ln, len(data) - i)
            spans.append((i, ln))
            i += ln

        n = len(spans)
        starts = [s for s, _ in spans]
        sizes = [l for _, l in spans]
        prevs = list(range(-1, n - 1))
        nexts = list(range(1, n)) + [-1]
        rev_merge: dict[bytes, tuple[int, int]] = {}
        heap: list[tuple[float, int, int, int]] = []  # (-score, left, right, size)

        def try_add_bigram(left: int, right: int) -> None:
            if left == -1 or right == -1:
                return
            txt = data[starts[left] : starts[left] + sizes[left] + sizes[right]]
            tok = v.bytes_to_token(txt)
            if tok < 0 or tok >= v.n_tokens() or v.scores is None:
                return
            heapq.heappush(heap, (-float(v.scores[tok]), left, right, len(txt)))
            rev_merge[txt] = (left, right)

        for i in range(1, n):
            try_add_bigram(i - 1, i)

        while heap:
            nscore, left, right, size = heapq.heappop(heap)
            if sizes[left] == 0 or sizes[right] == 0 or sizes[left] + sizes[right] != size:
                continue
            sizes[left] += sizes[right]
            sizes[right] = 0
            nexts[left] = nexts[right]
            if nexts[right] >= 0:
                prevs[nexts[right]] = left
            try_add_bigram(prevs[left], left)
            try_add_bigram(left, nexts[left])

        def resegment(idx: int) -> None:
            txt = data[starts[idx] : starts[idx] + sizes[idx]]
            tok = v.bytes_to_token(txt)
            if tok >= 0:
                output.append(tok)
                return
            p = rev_merge.get(txt)
            if p is None:
                for byte in txt:
                    output.append(v.byte_to_token(byte))
                return
            resegment(p[0])
            resegment(p[1])

        i = 0
        while i != -1:
            resegment(i)
            i = nexts[i]

    def tokenize(
        self, text: str, add_special: bool = True, parse_special: bool = False
    ) -> list[int]:
        v = self.vocab
        output: list[int] = []
        fragments = v.partition_specials(text, parse_special)
        is_prev_special = True  # prefix first fragment with space
        if add_special and v.add_bos:
            output.append(v.bos_id)
            is_prev_special = True
        for frag in fragments:
            if isinstance(frag, int):
                output.append(frag)
                is_prev_special = True
            else:
                t = frag
                if v.add_space_prefix and is_prev_special:
                    t = " " + t
                t = t.replace(" ", SPM_SPACE)
                self._tokenize_fragment(t, output)
                is_prev_special = False
        if add_special and v.add_eos:
            output.append(v.eos_id)
        return output
