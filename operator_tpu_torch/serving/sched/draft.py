"""Prompt-lookup draft model: n-gram self-speculation from the request's
own context.

Incident-analysis prompts are highly templated — the same log lines,
field names and remediation phrasing recur inside one request — so the
cheapest possible draft model works unusually well here: match the tail
n-gram of (prompt + generated so far) against an earlier occurrence in
the same context and propose the tokens that followed it (the
prompt-lookup decoding trick; xLLM runs the same idea inside its async
scheduler).  There is no second model, no extra device program and no
training: the draft is host-side list matching, and the mixed ragged
program verifies the proposal as one ``q_count = k + 1`` row
(sched/mixed.py).  Greedy output is byte-identical by construction —
the commit accepts exactly the prefix the target model would have
produced one token at a time (sched/scheduler.py ``_commit``).

Deterministic by construction: same context, same proposal — the
acceptance-rate determinism test rides on this.

The port's own copy of ``operator_tpu/serving/sched/draft.py``.
"""

from __future__ import annotations

__all__ = ["PromptLookupDraft"]


class PromptLookupDraft:
    """Stateless n-gram lookup over a request's own token context.

    ``propose`` scans for the most recent earlier occurrence of the
    context's tail n-gram (longest ``ngram`` first, down to 1) and
    returns up to ``k`` continuation tokens.  An empty return means "no
    draft": the scheduler falls back to a plain one-token decode row for
    that step, so a miss costs nothing but this scan (measured and
    reported as ``draft_overhead_ms`` by bench.py).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1) -> None:
        self.max_ngram = max(1, int(max_ngram))
        self.min_ngram = max(1, min(int(min_ngram), self.max_ngram))

    def propose(self, context: list, k: int) -> list:
        """Up to ``k`` draft tokens continuing ``context``, or ``[]``."""
        if k <= 0 or len(context) < self.min_ngram + 1:
            return []
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if len(context) <= n:
                continue
            tail = context[-n:]
            # rightmost earlier occurrence wins: recent context is the
            # best predictor of what a templated generation does next
            for i in range(len(context) - n - 1, -1, -1):
                if context[i : i + n] == tail:
                    # i + n <= len(context) - 1, so at least one
                    # continuation token always exists here
                    return list(context[i + n : i + n + k])
        return []
