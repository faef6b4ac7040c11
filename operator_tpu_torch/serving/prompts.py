"""Prompt construction for explanation generation.

The port's copy of ``operator_tpu/serving/prompts.py``.

Honours the AIProvider CR's ``promptTemplate`` (reference
aiprovider-crd.yaml:46-48); the default template instructs the model to
answer in the Root Cause / Fix sections that downstream event truncation
preserves (reference EventService.java:282-301).

Context management for long logs (SURVEY.md §5 long-context entry): rather
than shipping the whole log, the prompt carries the top-scoring match
windows — the selection the pattern engine already did — plus the log tail,
within a fixed character budget so batched prefill lengths stay bounded.
"""

from __future__ import annotations

from typing import Optional

from ..schema.analysis import AnalysisRequest, AnalysisResult

#: the preamble before the first placeholder is STATIC across every
#: request, so its KV is cached once (the continuous scheduler's
#: block-hash prefix cache; the wave engine's registered shared prefix,
#: primed by ``build_serving_engine``) and each admission prefills only
#: the variable remainder —
#: keep new static instructions above the first ``{`` and variable
#: content below it
DEFAULT_TEMPLATE = """You are a Kubernetes failure analyst. A pod failed; your job is to name the root cause and the most direct fix.

Ground rules:
- Trust the pattern analysis and the quoted log evidence over speculation; if they conflict, say which you believe and why.
- Distinguish the root cause from its symptoms (a CrashLoopBackOff is a symptom; the exception or exit code behind it is the cause).
- Common causes worth checking against the evidence: out-of-memory kills (exit 137, OOMKilled), failed liveness/readiness probes, image pull errors, missing config/secrets, permission errors, disk pressure or eviction, dependency outages (databases, DNS, upstream services), and application exceptions at startup.
- Name concrete Kubernetes objects and fields in the fix when the evidence identifies them (limits, probes, image tags, env vars).
- If the evidence is insufficient for a confident diagnosis, say so and name the single most useful signal to collect next.

Pod: {pod_name} (namespace {namespace})
Pattern analysis (severity {severity}): {patterns}

Strongest log evidence:
{evidence}

Recent log tail:
{log_tail}

Answer concisely with exactly two sections:
Root Cause: <one or two sentences naming the root cause>
Fix: <the most direct remediation>"""

#: budgets keep batched prefill bounded (32 concurrent events -> one prefill,
#: BASELINE config 4)
MAX_EVIDENCE_CHARS = 1600
MAX_TAIL_CHARS = 1200
#: retrieval-augmented context from incident memory (near-miss recall,
#: operator_tpu/memory/recall.py) rides the SAME budget discipline —
#: injecting prior incidents must never blow up the prefill bucket
MAX_PRIOR_INCIDENT_CHARS = 1200


def pack_blocks(blocks: "list[str]", budget: int, *, sep: str = "\n---\n") -> str:
    """The one budget-aware block packer every prompt section uses: take
    blocks in order, truncating the block that crosses the char budget and
    dropping the rest.  Evidence selection and prior-incident injection
    share this so neither can silently exceed its slice of the prompt."""
    kept: list[str] = []
    used = 0
    for block in blocks:
        block = block.strip()
        if not block:
            continue
        remaining = budget - used
        if remaining <= 0:
            break
        if len(block) > remaining:
            block = block[:remaining]
        kept.append(block)
        used += len(block)
    return sep.join(kept)


def _pattern_summary(result: Optional[AnalysisResult]) -> str:
    if result is None or not result.events:
        return "no known failure patterns matched"
    parts = []
    for event in result.top_events(3):
        if event.matched_pattern is None:
            continue
        parts.append(f"{event.matched_pattern.name} (score {event.score:.2f})")
    return "; ".join(parts) or "no named patterns"


def _evidence(result: Optional[AnalysisResult]) -> str:
    if result is None:
        return "(none)"
    blocks = [
        event.context.render()
        for event in result.top_events(3)
        if event.context is not None
    ]
    return pack_blocks(blocks, MAX_EVIDENCE_CHARS) or "(none)"


def prior_incident_section(request: AnalysisRequest) -> str:
    """Render near-miss recalls as an appended prompt section ("" when
    there are none).  Appended AFTER the template so the static preamble —
    and its shared-prefix KV registration — is untouched."""
    priors = request.prior_incidents
    if not priors:
        return ""
    blocks = []
    for i, prior in enumerate(priors):
        if not prior.explanation:
            continue
        head = (
            f"[{i + 1}] similarity {prior.score:.2f}, "
            f"seen {prior.seen_count}x"
            + (f", severity {prior.severity}" if prior.severity else "")
            + (f", last {prior.last_seen}" if prior.last_seen else "")
        )
        blocks.append(f"{head}\n{prior.explanation}")
    body = pack_blocks(blocks, MAX_PRIOR_INCIDENT_CHARS)
    if not body:
        return ""
    return (
        "\n\nSimilar previously-analyzed incidents (for context; this "
        "failure is NOT identical to them — diagnose the evidence above "
        "on its own merits):\n" + body
    )


def build_warmup_prompt() -> str:
    """A production-shaped prompt for engine warmup (the operator's).

    Starts with the template's static preamble and pads evidence/log_tail
    to their production CHAR budgets with log-shaped filler, so it
    tokenizes at real log density and warms the prefill lengths real
    explanation prompts use.  Lives next to DEFAULT_TEMPLATE so a
    placeholder change updates both or neither."""
    line = ("2026-01-01T00:00:00Z ERROR connection refused "
            "connecting to upstream service on port 8080\n")
    evidence = (line * (MAX_EVIDENCE_CHARS // len(line) + 1))[:MAX_EVIDENCE_CHARS]
    log_tail = (line * (MAX_TAIL_CHARS // len(line) + 1))[:MAX_TAIL_CHARS]
    return DEFAULT_TEMPLATE.format(
        pod_name="warmup", namespace="warmup", severity="NONE",
        patterns="warmup", evidence=evidence, log_tail=log_tail,
    )


def template_preamble(template: str) -> "str | None":
    """The static preamble of a prompt template — everything above its
    first ``{`` placeholder — IF the template actually renders.

    The one extraction rule for every shared-prefix registration site
    (engine build, the operator's startup CR scan, the provider's lazy
    path): a template whose ``format`` raises falls back to
    DEFAULT_TEMPLATE in :func:`build_prompt`, so registering ITS preamble
    would hold KV pages and a registry slot for a prefix no rendered
    prompt ever starts with — such templates return None."""
    if not template or not template.strip():
        return None
    probe = {
        "pod_name": "p", "namespace": "n", "severity": "NONE",
        "patterns": "x", "evidence": "x", "log_tail": "x",
    }
    try:
        template.format(**probe)
    except Exception:  # noqa: BLE001 - ANY render failure (KeyError,
        # AttributeError from '{x.y}', TypeError from '{x[0]}' on str, ...)
        # means build_prompt will fall back to DEFAULT_TEMPLATE, and the
        # caller sites must never be taken down by a malformed CR template
        return None
    return template.split("{", 1)[0]


def build_prompt(request: AnalysisRequest) -> str:
    from ..patterns.windows import tail_chars  # local import keeps serving lean

    result = request.analysis_result
    config = request.provider_config
    template = (config.prompt_template if config and config.prompt_template else DEFAULT_TEMPLATE)
    failure = request.failure_data
    pod = failure.pod if failure else None
    log_tail = tail_chars(failure.logs if failure else "", MAX_TAIL_CHARS)
    fields = {
        "pod_name": (pod.metadata.name if pod else None) or (result.pod_name if result else None) or "unknown",
        "namespace": (pod.metadata.namespace if pod else None)
        or (result.pod_namespace if result else None)
        or "unknown",
        "severity": (result.summary.highest_severity if result else None) or "NONE",
        "patterns": _pattern_summary(result),
        "evidence": _evidence(result),
        "log_tail": log_tail or "(no logs)",
    }
    try:
        rendered = template.format(**fields)
    except (KeyError, IndexError, ValueError):
        # user template with unknown placeholders: fall back to default
        rendered = DEFAULT_TEMPLATE.format(**fields)
    # retrieval-augmented context (near-miss recall) appends AFTER the
    # render: the template's static preamble stays byte-identical, so the
    # shared-prefix KV cache keeps matching these prompts
    return rendered + prior_incident_section(request)
