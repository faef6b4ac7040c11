"""Prefill/decode disaggregation on top of the fabric.

The port's own copy of ``operator_tpu/fabric/disagg.py``.  Storm-shaped
load (huge log prompts, short analyses) forces every replica to be sized
for both phases.  Roles split that: a *prefill* replica runs prompts and
registers the resulting pages in the fabric (scheduler mirror -> host
pool -> ``/healthz`` inventory), a *decode* replica pulls pages over the
fabric and decodes, and *mixed* (the default) serves both phases exactly
as before: a fleet with no roles configured behaves as the pre-fabric
fleet.

The two-leg dispatch below generalizes token-level resume
(``router/resume.py``) from failover-only to steady state: the prefill
leg generates exactly one token (forcing the full prompt through prefill
and the mirror), then the decode leg resumes from that token on a decode
replica whose admission-time prefetch pulls the prompt's pages instead
of recomputing them.  Roles are a *preference*, never a hard filter: a
fleet with no decode replica degrades to mixed candidates rather than
rejecting.
"""

from __future__ import annotations

from typing import Optional

from ..utils.timing import METRICS

PREFILL = "prefill"
DECODE = "decode"
MIXED = "mixed"
VALID_ROLES = frozenset((PREFILL, DECODE, MIXED))


def normalize_role(role: Optional[str]) -> str:
    """Validate a configured role; empty/None means mixed."""
    if not role:
        return MIXED
    role = role.strip().lower()
    if role not in VALID_ROLES:
        raise ValueError(
            f"invalid replica role {role!r}: expected one of "
            f"{sorted(VALID_ROLES)}"
        )
    return role


def role_preference(candidate_role: Optional[str], wanted: str) -> int:
    """Candidate ordering key for a role-aware route: exact match first,
    then mixed/unknown (they can serve anything), then the opposite
    role — degrade, never reject."""
    if candidate_role == wanted:
        return 0
    if candidate_role in (None, "", MIXED):
        return 1
    return 2


async def disaggregated_dispatch(
    router,
    prefill_send,
    decode_send,
    *,
    key: str = "",
    request_id: str = "",
    deadline=None,
    tokens: int = 256,
    kv_hint=None,
    metrics=None,
):
    """Run one request as a prefill leg + a decode leg over the fabric.

    ``prefill_send(replica, attempt, budget_s)`` must run the prompt for
    exactly one generated token and return a result exposing
    ``token_ids``; ``decode_send(replica, attempt, budget_s,
    prefix_tokens)`` resumes from those tokens for the remaining budget.
    Both legs ride the ordinary ``router.dispatch`` machinery (breakers,
    failover, requeue) with a role preference; the shared deadline means
    the decode leg sees whatever budget the prefill leg left behind.

    Returns ``(prefill_outcome, decode_outcome)``.
    """
    m = metrics if metrics is not None else METRICS
    prefill_out = await router.dispatch(
        prefill_send,
        key=key,
        request_id=f"{request_id}:prefill" if request_id else "",
        deadline=deadline,
        tokens=1,
        kv_hint=kv_hint,
        role=PREFILL,
    )
    prefix = list(getattr(prefill_out.response, "token_ids", ()) or ())

    async def _decode_leg(replica, attempt, budget_s):
        return await decode_send(replica, attempt, budget_s, prefix)

    decode_out = await router.dispatch(
        _decode_leg,
        key=key,
        request_id=request_id,
        deadline=deadline,
        tokens=tokens,
        kv_hint=kv_hint,
        role=DECODE,
    )
    m.incr("fabric_disagg_handoff")
    return prefill_out, decode_out
