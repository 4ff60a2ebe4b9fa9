"""Draft-token proposers for speculative multi-token decoding.

Port of ``repro.serving.spec``, the same code over the port's engine.

Decode is memory-bandwidth-bound: every step streams the whole KV pool to
emit ONE token per lane (the regime Chiplet Cloud's Fig 8 prices, and the
reason CC-MEM exists).  Speculative decoding is the standard escape: a
cheap *proposer* drafts up to ``spec_k`` continuation tokens per lane, the
target model scores last-accepted + drafts in ONE pass through the paged
flash-prefill path (which already handles K>1 query positions against the
block pool), and the engine keeps the longest draft prefix that matches
what plain decode would have produced — so every extra accepted token
amortizes one full KV sweep.

A proposer is anything with::

    propose(history: Sequence[int], k: int) -> list[int]

``history`` is the request's effective token stream so far (prompt tail +
generated output, host side); the return is at most ``k`` draft tokens.
Proposers are *advisory only*: the verify-and-accept step guarantees the
emitted stream is bit-identical to ``spec_decode="off"`` regardless of
what is proposed, so a bad proposer costs speed, never correctness.  The
interface is deliberately model-free so a small draft *model* can slot in
later — it only needs to produce host-side token lists per request.

``NgramProposer`` is the self-drafting baseline: it assumes the sequence
repeats — find the longest recent n-gram suffix that occurred earlier in
the history and replay what followed it.  That wins on repetitive or
structured output (code, JSON, quoted context, greedy loops) and proposes
nothing on text with no self-similarity, where speculation degrades to
plain decode plus a cheap host-side scan.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

#: Accepted values for ``ServingEngine(spec_decode=...)``.
SPEC_DECODE_MODES = ("off", "ngram")


class NgramProposer:
    """Suffix-match n-gram drafting over the request's own history.

    For ``n`` from ``max_n`` down to ``min_n``: take the history's last
    ``n`` tokens, find the RIGHTMOST earlier occurrence of that n-gram
    with at least ``k`` continuation tokens available — falling back to
    the rightmost occurrence with ANY continuation — and propose the (up
    to ``k``) tokens that followed it.  Longer matches are preferred
    (more context agreement), and the rightmost occurrence wins so the
    draft tracks the most recent phrasing.  The with-room preference
    matters on short-cycle output (greedy loops): the most recent match
    sits flush against the end of the history and offers a 1-token
    draft, while an occurrence one period earlier replays a full ``k``
    tokens of the same cycle.
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"({min_n}, {max_n})")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = [int(t) for t in history]
        n_hist = len(h)
        if k <= 0 or n_hist < self.min_n + 1:
            return []
        for n in range(min(self.max_n, n_hist - 1), self.min_n - 1, -1):
            suffix = h[n_hist - n:]
            fallback = None
            for i in range(n_hist - n - 1, -1, -1):
                if h[i:i + n] == suffix:
                    if n_hist - (i + n) >= k:
                        return h[i + n:i + n + k]
                    if fallback is None:
                        fallback = h[i + n:i + n + k]
            if fallback is not None:
                return fallback
        return []


def make_proposer(spec_decode: str):
    """Map the engine knob to a proposer instance (None when off)."""
    if spec_decode == "off":
        return None
    if spec_decode == "ngram":
        return NgramProposer()
    raise ValueError(
        f"spec_decode must be one of {SPEC_DECODE_MODES}, "
        f"got {spec_decode!r}")
