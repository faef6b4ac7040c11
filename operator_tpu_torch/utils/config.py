"""Operator configuration — the MicroProfile-Config equivalent.

The port's own copy of ``operator_tpu/utils/config.py``: the whole
``OperatorConfig`` dataclass and its ``from_env``, field for field, so one
environment resolves to the same values in both packages, and the
fields of its own in ``PORT_FIELDS`` (which the reference does not read).  The port's
``serving/provider.py:build_serving_engine`` reads the serving knobs
through it and serves every one of them, as the reference does.

Three tiers, mirroring the reference (SURVEY.md §5 config entry):
static defaults < environment variables < CR spec (runtime behaviour such as
AI on/off and provider params lives in the CRDs, not here).

Env mapping follows the reference's keys where they exist:
``podmortem.watch.namespaces`` -> ``PODMORTEM_WATCH_NAMESPACES``
(reference PodFailureWatcher.java:52-53), ``pattern.cache.directory`` ->
``PATTERN_CACHE_DIRECTORY`` (application.properties:4-5).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Optional


#: the port's own fields, beside the reference's: ``serving_max_seq``
PORT_FIELDS = ("serving_max_seq",)


@dataclass
class OperatorConfig:
    # --- watch / reconcile ------------------------------------------------
    watch_namespaces: list[str] = field(default_factory=list)  # empty = all
    watch_restart_delay_s: float = 5.0  # reference PodFailureWatcher.java:574
    reconcile_interval_s: float = 60.0

    # --- pattern cache / sync --------------------------------------------
    pattern_cache_directory: str = "/shared/patterns"  # application.properties:4-5
    git_binary: str = "git"
    sync_timeout_s: float = 120.0
    # budget for single control-loop apiserver calls outside an analysis
    # envelope (pattern-library status patches, secret reads, list sweeps):
    # enforced so a wedged apiserver connection stalls one reconcile tick,
    # not the whole reconciler forever (graftlint GL003)
    kube_call_timeout_s: float = 15.0

    # --- storage (reference AnalysisStorageService.java:48,74-76) ---------
    max_recent_failures: int = 10
    conflict_max_retries: int = 5
    conflict_backoff_base_s: float = 0.1  # 100ms * 2^n

    # --- events (reference EventService.java:32,81) -----------------------
    reporting_controller: str = "podmortem.operator"
    event_message_limit: int = 1024

    # --- analysis budgets (application.properties:7-11) -------------------
    parse_timeout_s: float = 30.0
    ai_timeout_s: float = 180.0
    log_tail_bytes: int = 1_000_000  # cap on fetched pod log
    # end-to-end deadline budget (utils/deadline.py): born when a failure
    # is CLAIMED, enforced at every hop; the reference's whole envelope is
    # its 180 s external-LLM read budget, so that is the default.  A
    # Podmortem CR overrides per-CR via spec.analysisDeadline.
    analysis_deadline_s: float = 180.0
    # slice of the remaining budget log collection may spend before the
    # pipeline degrades to events-only evidence
    collect_budget_fraction: float = 0.2
    # per-provider circuit breaker (operator/providers.py CircuitBreaker):
    # consecutive-failure trip -> open (AI skipped, pattern-only results)
    # -> half-open probe after the reset window
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 30.0

    # --- multi-replica data plane (operator_tpu/router/, docs/ROBUSTNESS.md)
    # the failover router in front of N serving replicas: an AIProvider
    # apiUrl naming several endpoints (comma-separated, or the per-pod DNS
    # of the headless serving Service) is dispatched with consistent-hash
    # affinity, per-replica breakers, load-fed shedding, and requeue-ONCE
    # failover carrying the residual deadline
    router_vnodes: int = 64
    # queue pressure (queued + inflight) past which the affinity owner is
    # considered overloaded and the router sheds to a lighter replica
    router_shed_pressure: int = 8
    # per-REPLICA breaker: tighter than the per-provider one — with N
    # replicas a sick one should drain fast (siblings absorb the traffic),
    # and its half-open probe re-admits it quickly once healthy
    router_replica_failure_threshold: int = 3
    router_replica_reset_s: float = 10.0
    # background /healthz polling (operator/app.py): the operator probes
    # every routed serving replica at this cadence and feeds the router's
    # HealthBoard, so load-fed shedding works even when no request
    # traffic is producing load reports; each probe is bounded by
    # kube_call_timeout_s.  0 = off (passive breaker-only gating).
    router_health_poll_s: float = 15.0
    # this serving replica's identity on GET /healthz ("" = POD_NAME, then
    # hostname) — what the router's probes and AIResponse.replica_id carry
    serving_replica_id: str = ""

    # --- HA / survivable control plane (docs/ROBUSTNESS.md) ----------------
    # lease-based leader election (operator/lease.py): watcher, reconcilers,
    # pattern sync, and the pipeline run ONLY while this replica holds the
    # coordination.k8s.io Lease; standbys keep probes + engine warm and take
    # over (re-list + claim resume) when the leader's renewTime expires.
    # Off by default so single-replica installs and tests are unchanged.
    leader_election: bool = False
    lease_name: str = "podmortem-tpu-operator"
    lease_namespace: str = ""  # "" = the api's namespace (or "default")
    lease_duration_s: float = 15.0
    lease_renew_period_s: float = 5.0
    lease_retry_period_s: float = 2.0
    # this replica's holder identity; the deployment injects POD_NAME via
    # the downward API, "" falls back to hostname-pid
    pod_name: str = ""
    # durable claim ledger (operator/claims.py): crash-safe JSONL of
    # claim→stage→terminal transitions; a restarted (or newly elected)
    # operator replays it and resumes non-terminal analyses with their
    # REMAINING deadline budget.  None = in-memory only (the pre-HA
    # dedupe semantics).  The shipped deployment points it at the
    # pattern-cache PVC next to the incident journal.
    claims_path: Optional[str] = None
    claims_max_entries: int = 10_000
    # graceful drain (SIGTERM): in-flight analyses get this long to finish
    # (their own deadlines usually end them sooner); then tasks are
    # cancelled, journals flushed, and the lease released
    shutdown_grace_s: float = 30.0
    # serving httpserver drain: after the listener closes, in-flight HTTP
    # handlers (and the engine waves they ride) get this long to complete.
    # Size it UNDER terminationGracePeriodSeconds minus the preStop sleep
    # and shutdown_grace_s, or the HTTP drain can eat the whole SIGTERM
    # budget before the analysis drain and journal flushes run
    serving_drain_grace_s: float = 30.0

    # --- serving-engine supervisor (serving/engine.py) ---------------------
    # watchdog over the decode loop: a step making no progress within the
    # stall budget — or a loop death — triggers an engine reset; in-flight
    # requests are requeued ONCE with their residual deadline, then failed
    # (podmortem_supervisor_{restart,requeue,gaveup}_total)
    engine_supervisor: bool = True
    # generous default: a step can legitimately hide a multi-second in-band
    # XLA compile (novel bucket) — only a genuinely wedged device should trip
    supervisor_stall_s: float = 120.0
    # how long the supervisor waits for an abandoned (stalled) decode thread
    # to come back before resetting device state under it anyway
    supervisor_join_grace_s: float = 10.0

    # --- incident memory (operator_tpu/memory/, docs/MEMORY.md) -----------
    # recall across failures: exact fingerprint hit reuses the stored
    # analysis (AI leg skipped), near hit injects prior incidents into the
    # prompt, miss analyzes then remembers
    memory_enabled: bool = True
    # JSONL journal path (crash-safe append); unset = in-memory only.
    # The shipped deployment points it at the pattern-cache PVC.
    memory_path: Optional[str] = None
    memory_max_entries: int = 2048
    memory_ttl_s: float = 604800.0  # 7d; 0 = no TTL (LRU bound only)
    # near-miss similarity threshold; 0 = the embedder's own default
    # (lexical hashing 0.3, MiniLM 0.45 — patterns/semantic.py)
    recall_threshold: float = 0.0
    recall_top_k: int = 3
    # ConfigMap name for PVC-less durability (snapshot flushed at most
    # every memory_flush_interval_s); empty = off
    memory_configmap: str = ""
    memory_flush_interval_s: float = 30.0
    # bearer token required by GET /incidents* on the health port ("" =
    # open, like the probes) — incident records quote log evidence, which
    # can carry secrets, so fleets with untrusted pod networks set this
    incidents_api_token: str = ""

    # --- observability (operator_tpu/obs/, docs/OBSERVABILITY.md) ---------
    # per-analysis tracing + flight recorder: every analysis produces a
    # span tree; deadline-exceeded / breaker-open / engine-error analyses
    # additionally dump a black-box record
    obs_enabled: bool = True
    # bounded in-memory ring of recent traces (GET /traces)
    trace_ring_capacity: int = 256
    # append-only JSONL of every completed trace (crash-safe, same
    # discipline as the incident journal); unset = ring only
    trace_journal_path: Optional[str] = None
    # black-box dumps (full trace + deadline ledger + fault-plan seed on
    # deadline-exceeded / breaker-open / engine-error); unset = the
    # trace journal path (or ring only when that is unset too)
    trace_blackbox_path: Optional[str] = None

    # --- storage text caps ------------------------------------------------
    # Kubernetes rejects objects whose TOTAL annotations exceed 256 KiB;
    # the stored AI text is truncated at this cap with an explicit
    # "…[truncated]" marker (full text still goes to CR status, itself
    # capped below against the ~1.5 MiB etcd object limit)
    max_annotation_chars: int = 8192
    max_status_explanation_chars: int = 32768

    # --- health / metrics endpoint (reference operator-deployment.yaml:61-78
    # probes /q/health/*; ours serves /healthz/* + /metrics) ---------------
    health_host: str = "0.0.0.0"
    health_port: int = 8080  # 0 = ephemeral (tests), -1 = disabled

    # --- serving ----------------------------------------------------------
    model_id: str = "tinyllama-1.1b"
    checkpoint_dir: Optional[str] = None
    # MiniLM-class sentence encoder for semantic pattern matching (the
    # subsumed log-parser's neural scorer); unset = lexical HashingEmbedder
    encoder_checkpoint_dir: Optional[str] = None
    max_batch_size: int = 32  # BASELINE config 4: 32 events -> one prefill
    # paged KV cache (ops/paged_attention.py): allocate HBM by actual
    # sequence need instead of max_seq per slot — the batch-32-at-8B-scale
    # memory fix (SURVEY.md §7 hard part c).  kv_pages=0 means worst-case
    # sizing (no oversubscription).
    kv_cache_mode: str = "paged"  # "paged" | "contiguous"
    kv_page_size: int = 64
    kv_pages: int = 0
    # decode steps fused per host round-trip (serving/engine.py): hides host
    # latency on K-1 of K tokens; admissions join at block boundaries
    decode_block: int = 4
    # decode-ahead lookahead (serving/engine.py step()): blocks left in
    # flight while the host processes older tokens; 2 hides the per-block
    # host<->device round trip, 1 = synchronous
    pipeline_depth: int = 2
    # chunked prefill (Sarathi-style): prefill at most this many prompt
    # tokens per engine round so long prefills don't stall in-flight
    # decodes; 0 = one-shot prefill (power of two when set)
    prefill_chunk: int = 0
    # continuous-batching scheduler (serving/sched/, docs/SERVING.md):
    # "continuous" (the DEFAULT since the decode-ahead/speculation PR)
    # replaces the wave machinery with the explicit
    # schedule→dispatch→commit loop over ONE ragged mixed prefill+decode
    # program — token-level admission into the running wave, per-token
    # slot/page recycling, decode-ahead pipelining and prompt-lookup
    # speculation.  Requires paged KV, no mesh, no guided/LoRA traffic
    # (provider falls back to wave with a loud warning).  "wave" is the
    # explicit opt-out and still owns guided/LoRA/mesh serving.
    sched_mode: str = "continuous"  # "continuous" | "wave"
    # max prefill tokens ONE row contributes to a step (Sarathi chunk)
    sched_chunk: int = 64
    # flat token axis of the mixed program (>= max_batch_size so a full
    # decode batch always fits); 0 = max(sched_chunk, max_batch_size)
    sched_token_budget: int = 0
    # decode-ahead pipelining (sched/scheduler.py): dispatched steps left
    # in flight while the next wave is planned from predicted row state;
    # 2 hides the per-step host round-trip, 1 = synchronous commit
    sched_pipeline_depth: int = 2
    # prompt-lookup self-speculation (sched/draft.py): greedy rows verify
    # up to spec_lookup_k draft tokens from their own prompt+generated
    # context per step — multiple committed tokens per host round-trip,
    # byte-identical greedy output by construction
    spec_decode: bool = True
    spec_lookup_k: int = 4
    # shared-prefix KV caching (engine.set_shared_prefix): the default
    # prompt template's static preamble is prefilled once and admissions
    # forward only their suffix; paged mode only, exact (causal) reuse
    prefix_cache: bool = True
    # automatic block-hash prefix caching for the continuous scheduler
    # (serving/kvstore.py): page-granular APC keyed by rolling hash over
    # page-aligned token blocks — admissions reuse any cached prompt
    # prefix, not just a registered template preamble
    kv_prefix_cache: bool = True
    # host-RAM offload tier for evicted prefix blocks (ops/kv_transfer.py):
    # pinned numpy pool size in MB; 0 = eviction simply forgets blocks
    kv_host_pool_mb: int = 0
    # token-level streaming resume (router/resume.py): journal path for
    # per-request generated-token checkpoints; on failover the survivor
    # re-prefills prompt+generated-so-far instead of restarting the
    # stream.  None/"" = off
    resume_checkpoint_path: Optional[str] = None
    # program-grid precompile at warmup (engine.precompile_grid): compile
    # every prefill/decode program admission can select BEFORE readiness
    # flips — a mid-run XLA compile is a multi-second p99 outlier.
    # "serving" = unguided grid; "full" adds guided variants; "off" = the
    # pre-r5 behavior (first bucket hit pays its compile in-band)
    warmup_grid: str = "serving"
    # nucleus-sampling candidate set (engine SAMPLE_TOP_K): top-p filtering
    # runs inside the top-k — raise for high-temperature diversity
    sample_top_k: int = 64
    # serving dtype: "int8" (weight-only per-channel quant, models/quant.py)
    # or "bf16".  int8 is the DEFAULT behind the parity gate (token-identical
    # greedy on the tiny models, tests/test_quant_parity.py): it halves HBM
    # weight traffic — decode at serving batch sizes is bandwidth-bound —
    # and fits Mistral-7B per chip on v5e (config 5)
    serving_dtype: str = "int8"
    # legacy override (pre-PR-10 name): when non-empty it wins over
    # serving_dtype, so existing WEIGHT_DTYPE deployments keep their pin
    weight_dtype: str = ""
    # persisted AOT executable cache (serving/aotcache.py): a directory
    # (PVC-backed in deploy/) where compiled serving programs are stored
    # and restored on boot — warm bring-up skips the warmup compile
    # entirely.  None/"" = off
    aot_cache_path: Optional[str] = None
    # multi-chip serving (BASELINE configs 3/5): "" = single device,
    # "auto" = plan_for(all local devices), or explicit "dp=2,tp=4[,fsdp=1]"
    serving_mesh: str = ""
    # production safety: without a checkpoint the engine would generate
    # noise from random weights; the provider factory refuses unless this
    # is set (tests/benches opt in explicitly)
    allow_random_weights: bool = False
    # multi-LoRA serving: a directory of `<name>.safetensors` adapter files
    # (parallel/lora.py save_lora) loaded into the stacked registry at
    # engine build; requests select by name (SamplingParams.adapter /
    # AIProvider additionalConfig.lora_adapter / API model field)
    lora_dir: Optional[str] = None
    lora_alpha: float = 16.0
    # OpenAI-compatible completion API (serving/httpserver.py) served from
    # the operator process on the SAME engine the tpu-native provider uses;
    # -1 = disabled (default), 0 = ephemeral port (tests)
    completion_api_port: int = -1
    completion_api_host: str = "0.0.0.0"
    completion_api_token: str = ""  # "" = no auth required
    # step clock (serving/perf.py, docs/OBSERVABILITY.md "Step clock"):
    # bounded ring of per-step decode-attribution records behind
    # /healthz, /fleet, black-box dumps and bench step_attribution
    step_ring_capacity: int = 512
    # POST /profile?seconds=N on-demand jax.profiler capture on the
    # serving API (off by default: captures cost device attention+disk)
    profile_enabled: bool = False
    profile_dir: str = "/tmp/operator-tpu-profile"
    # SLO ledger (obs/sloledger.py, docs/OBSERVABILITY.md "SLO ledger"):
    # class:target-seconds pairs every analysis is admitted under, and an
    # optional journal path for terminal records ("" / None = in-memory)
    slo_classes: str = "interactive:2,standard:30,batch:120"
    slo_ledger_path: Optional[str] = None
    # open-loop load generation (operator_tpu/loadgen/): the seed every
    # arrival-schedule draw derives from — same seed, byte-identical storm
    loadgen_seed: int = 0
    # --- value-aware overload control (router/value.py, docs/ROBUSTNESS.md
    # "Degradation ladder"): shed-lowest-value-first + degrade-before-reject
    # queue pressure at which the ladder starts DEGRADING (reduced
    # max_tokens, finish_reason "degraded") before anything is rejected;
    # 0 = half of shed_pressure
    degrade_pressure: int = 0
    # fraction of max_tokens a degraded request keeps (truncated analysis
    # depth — the first ladder rung)
    degrade_max_tokens_frac: float = 0.25
    # per-class attainment floor: a class whose live attainment
    # (obs/sloledger.py attainment_by_class) is below this is PROTECTED —
    # never shed, only degraded
    slo_attainment_target: float = 0.9
    # value-score bar at exactly shed_pressure; the bar rises linearly
    # with pressure beyond it, so deeper overload sheds progressively
    # higher-value work (smooth decay, not a cliff)
    shed_value_floor: float = 1.0
    # ladder shed line: queue pressure past which below-bar requests are
    # dropped outright (router_shed_pressure stays the router's
    # move-to-lighter-replica line; this one actually sheds)
    shed_pressure: int = 8
    # continuous-scheduler submit queue bound: at this depth enqueue
    # evicts the lowest-value non-protected request (0 = unbounded)
    sched_queue_limit: int = 0

    # --- serverless fleet (router/discovery.py, operator/autoscale.py,
    # docs/SCALING.md) -----------------------------------------------------
    # endpoint-watch fleet membership: list+watch the headless serving
    # Service's Endpoints and mutate the router's consistent-hash ring
    # live — joins pre-warmed via a health probe before taking traffic,
    # departures drain through the breaker/failover path
    discovery_enabled: bool = False
    discovery_service: str = "podmortem-serving"
    discovery_namespace: str = ""  # "" = the api's namespace (or "default")
    discovery_port: str = "http"  # EndpointPort NAME to route to
    discovery_scheme: str = "http"
    # gate joins on a successful /healthz probe (which also primes the
    # replica's KV prefix store with a load report) before ring insertion
    discovery_prewarm: bool = True
    # SLO-judged autoscaler (leader-only control loop): scales the serving
    # Deployment via the scale subresource on router fleet pressure +
    # per-class SLO attainment — including to ZERO when idle
    autoscale_enabled: bool = False
    autoscale_interval_s: float = 15.0
    autoscale_min_replicas: int = 0
    autoscale_max_replicas: int = 8
    # least-loaded healthy replica's queue pressure past which the fleet
    # bursts out (OverloadPolicy's fleet_pressure is the same signal the
    # degradation ladder keys on — scale-up is the rung ABOVE degrade)
    autoscale_target_pressure: float = 4.0
    autoscale_deployment: str = "podmortem-serving"
    autoscale_namespace: str = ""  # "" = the api's namespace (or "default")
    # idle window before the fleet scales to zero (only when
    # autoscale_min_replicas == 0); pending arrivals wake it back up
    scale_to_zero_idle_s: float = 600.0

    # --- fleet KV fabric (operator_tpu/fabric/, docs/FABRIC.md) -----------
    # peer-to-peer KV page transfer: an admission-time prefix miss
    # consults the fleet block index and fetches pages from a holder's
    # host pool over GET /kv/blocks/{hash} instead of recomputing.
    # Requires kv_prefix_cache and kv_host_pool_mb > 0 (fetched pages
    # land in the host pool; the existing one-DMA restore path revives
    # them on match)
    kv_fabric: bool = False
    # per-fetch deadline (seconds), clamped to the request's residual
    # budget at the call — a failed fetch must never cost more than the
    # recompute it replaced
    kv_fabric_fetch_timeout_s: float = 2.0
    # concurrent page fetches in flight per replica (bounded client)
    kv_fabric_concurrency: int = 4
    # mirror newly-registered prompt blocks into the host pool at
    # prefill completion (inside the commit step's host-sync window) so
    # peers can fetch them without waiting for eviction to spill them
    kv_fabric_mirror: bool = True
    # comma-separated peer base URLs whose /healthz inventories feed
    # this replica's fabric index (fabric/peers.py).  Hostnames are
    # DNS-expanded every poll round, so the single headless-Service name
    # (http://podmortem-serving:8000) covers the whole fleet.  "" (the
    # default) starts no poller: an in-process harness feeds the index
    # directly, and a standalone replica without peers has no fabric to
    # fetch from — the empty-index gate skips the prefetch entirely
    kv_fabric_peers: str = ""
    # seconds between peer inventory poll rounds
    kv_fabric_poll_s: float = 5.0
    # prefill/decode disaggregation role advertised on /healthz
    # (fabric/disagg.py): "prefill" | "decode" | "mixed".  A routing
    # preference, never a filter — mixed (the default) serves both
    # phases and a role-less fleet behaves exactly as before
    replica_role: str = "mixed"

    # --- the port's own (PORT_FIELDS) -------------------------------------
    # positions a serving row holds, up to the model's max_seq_len; 0 = the
    # reference's min(max_seq_len, 2048).  Mistral's 4,096-token window
    # takes effect only past 4,096 positions, so a mistral-7b deployment
    # sets its whole context, SERVING_MAX_SEQ=8192
    serving_max_seq: int = 0

    @classmethod
    def from_env(cls, env: Optional[dict[str, str]] = None) -> "OperatorConfig":
        env = dict(os.environ if env is None else env)
        cfg = cls()
        for f in fields(cls):
            key = f.name.upper()
            if f.name == "watch_namespaces":
                key = "PODMORTEM_WATCH_NAMESPACES"
            raw = env.get(key)
            if raw is None:
                continue
            if f.name == "watch_namespaces":
                cfg.watch_namespaces = [ns.strip() for ns in raw.split(",") if ns.strip()]
            elif f.type in ("float", float):
                cfg.__setattr__(f.name, float(raw))
            elif f.type in ("int", int):
                cfg.__setattr__(f.name, int(raw))
            elif f.type in ("bool", bool):
                cfg.__setattr__(f.name, raw.strip().lower() in ("1", "true", "yes", "on"))
            else:
                cfg.__setattr__(f.name, raw)
        return cfg
