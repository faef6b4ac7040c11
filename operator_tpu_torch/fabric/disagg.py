"""Replica roles for prefill/decode disaggregation.

The port's copy of the role half of ``operator_tpu/fabric/disagg.py``:
the three roles a replica advertises on ``/healthz`` and the router's
ordering key over them.  The two-leg dispatch itself
(``disaggregated_dispatch``) needs the fabric's fetch path and waits with
it (ROADMAP.md Queue 1 item 5b).
"""

from __future__ import annotations

from typing import Optional

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
