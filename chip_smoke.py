#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``operator_tpu_torch``).

    python3 chip_smoke.py [--out results.json]
        [--phases device,kernels,serve,wave,analysis,checkpoint,operator,remote,parity]

Runs on one CUDA card, from the root of a checkout; exits non-zero, and
prints no result, when no card is present or the package is missing.
Phases, in order — any failure stops the run:

1. device: the card's name and power limit (``nvidia-smi``), the build
   of every kernel of the port from the checkout's sources (one ``nvcc``
   per source, all started together), and each library's count of
   tensor-core instructions (``cuobjdump -sass``: ``HMMA`` for mma.sync,
   ``HGMMA`` for wgmma) — the bf16 ragged (K1), paged decode (K2/K3) and
   prefill (K4) kernels run on the tensor cores, so their libraries must
   have some;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (tinyllama-1.1b: QH=32, KH=4, D=64, page 64,
   32 rows), bf16 and f32, tolerances stated below.  The ragged kernel
   (K1) over every geometry the scheduler produces, chunk 64, valid rows
   only; the paged decode kernel (K2/K3) at mixed lengths with full
   pages, length-1 rows, a window and released (all-zero table) rows,
   every row; the flash-prefill kernel (K4) at T in {64, 512, 2048}, B in
   {1, 8}, ragged lengths and a window, every row (bf16 tolerance about
   twice their largest measured error, not K1's looser one); the
   best-window similarity kernel (K5) at the semantic path's three
   geometries (4,096 windows x 19 patterns, x 1,024 patterns, and one
   query x 2,048 incidents; D = 384) and at any D (4,096 x 19 at D = 385,
   rows off 16-byte vectors, and at D = 1,536, 6 KB rows in f32), scores
   and the plain score at the chosen window, and exact first indices
   where window rows repeat; and the K5 wrapper's host time per call,
   part by part.
   Times each kernel, its plain version and one PyTorch library call
   computing the same function (``scaled_dot_product_attention`` over
   the gathered KV, or with the causal+length mask; ``torch.matmul`` +
   ``max`` for K5; timed here only, never called by the port), beside
   the least time the card could take (``bound``); K1 at the serve
   phase's three waves (decode, mixed, prefill), the mixed one its record;
3. serve: the continuous path at full width — tinyllama-1.1b, 22
   layers, int8 weights from a seed, 32 slots, page 64, chunk 64,
   pipeline depth 2, speculative decoding on, the block-hash prefix cache
   on (the default) — through the port's HTTP server on localhost, with
   concurrent ``/v1/completions`` requests of mixed prompt lengths, greedy
   and sampled: the timed COLD drive.  Every kernel's launch count is set
   to 0 just before and read just after: the ragged kernel must have
   launched exactly once per layer per step, the others never, and the
   pages must balance in four terms (free + rows + the cache's pages +
   the shared-prefix hold).  Then one more request, untimed, of 786 prompt
   tokens: each of the 22 K1 calls of its first decode or verify step is
   held to the plain version on its own inputs (valid rows), and that
   step's tile 0 must have keys in at least three of its splits, so the
   split-KV merge is held too; and the same prompt again, held on its
   FIRST prefill step, a cache hit (12 of 13 pages cached: 18 queries at
   kv_len 786).  Then the WARM drive, the same ten requests again: it
   must save exactly the prompt tokens of every cached full block (4,032)
   and its step records must carry them.  Then, through ``engine.submit``,
   a deadline that fits fewer tokens than asked (finish "deadline"), one
   already passed (``DeadlineExceeded``), and a burst over a queue limit
   of 4 with an ``OverloadPolicy`` on the scheduler and the generator
   (sheds counted, every request settled); ``spill_cache()`` must leave
   no cached page on the card.  Then a second engine with a 256 MB host
   pool and 48 KV pages: a cold drive, a pressure drive (the same bodies,
   first byte changed) whose admissions must evict the cached blocks to
   the pinned pool while steps are in flight, ``spill_cache()`` and one
   short request, and a warm drive that restores the first chain from
   the pool: the pages balance, a restored page must hold exactly the
   bytes gathered at its eviction, and no commit window's drain may wait
   half a step (the copies run on a side stream);
4. wave: the wave path (``SCHED_MODE=wave``, ``DECODE_BLOCK=4``,
   ``PIPELINE_DEPTH=2``, ``OPERATOR_TPU_FLASH_PREFILL=1``) at the same
   width through the HTTP server with the same requests, driven twice,
   once with each decode-kernel selector (``OPERATOR_TPU_PAGED_KERNEL``
   ``v1``, the default, then ``v2``), each engine built anew and the
   counts set to 0 before each drive: the prefill kernel must have
   launched 22 times per prefill wave, the decode kernel 22 x 4 times per
   decode block, the ragged and similarity kernels never; every request
   finishes and every page comes back free.  Then one more request,
   untimed: each of its prefill wave's 22 K4 calls is held to the plain
   version on its own inputs (every row; ``prefill_drive_limit``); and
   one more, of 786 prompt tokens: each of the 22 K2/K3 calls of its
   first decode step is held to the plain version (every row, WAVE_TOL),
   and its long row must have keys in at least three of the kernel's
   splits, so the split-KV merge is held too;
5. analysis: the semantic analysis path at the full width of
   all-MiniLM-L6-v2 (f32 weights from a seed, byte-level token ids,
   buckets of 32 texts x 256 tokens) through ``PatternEngine.analyze``
   with a ``SemanticMatcher`` on the card: a crash-loop log of 33,000
   lines (4,096 windows after the newest-windows cut) and a short one,
   then ``IncidentIndex.query`` over 2,048 incidents.  The counts are
   set to 0 before each drive: K5 must launch exactly once per analysis
   and once per query, K1-K4 never.  Each K5 call of the drives is held
   to the plain version on its own inputs;
6. checkpoint: a tinyllama-1.1b checkpoint at full width (bf16, the
   serve phase's seeded weights) written by the port's ``save_params``
   as HF-layout shards with an index, with the committed
   SentencePiece-style ``tokenizer.json`` (``tests/torch_tokenizers/``),
   loaded back through ``build_tpu_native_provider`` (``CHECKPOINT_DIR``,
   int8 weights quantized as they land, the continuous scheduler): the
   tokenizer must be the checkpoint's ``HFTokenizer``, not the byte
   fallback, and the int8 tree byte for byte the seeded tree's
   ``quantize_params``.  Ten ``AnalysisRequest``s of the fixture logs
   (regex analysis, pod, logs; half greedy, 32 tokens each) go through
   ``TPUNativeProvider.generate`` at once, counts set to 0 before: K1
   exactly once per layer per step, the others never; one more request's
   22 K1 calls are held to the plain version; the same drive on an engine
   built in memory from the seeded tree must give the greedy requests'
   responses exactly (admission held until all ten are queued, in both,
   so both take the same steps).  Then an all-MiniLM-L6-v2-width f32
   encoder checkpoint (HF BERT names, ``config.json``, a 30,522-entry
   ``vocab.txt`` built from the fixtures and the built-in patterns):
   ``build_embedder`` must return a ``NeuralEmbedder`` (not the lexical
   fallback) whose weights are the seeded tree's, and
   ``PatternEngine.analyze`` of the 33,000-line log launches K5 once,
   held to the plain version, with the events of an in-memory encoder of
   the same weights and WordPiece tokenizer.  Checkpoint bytes, write and
   load seconds, GB/s, device memory after the load, the drive's wall,
   tokens/s and K1 launches, and the analysis wall, encoder span and K5
   launches are printed with the card's name and power limit;
7. operator: the port's ``Operator`` (its default device, cuda) over the
   in-memory ``FakeKubeApi``, with the checkpoint phase's two checkpoints
   (kept for it, deleted after it): ``providerId: tpu-native`` through
   two AIProviders on the one engine (greedy, and the default
   temperature), each named by a Podmortem selecting ``app=payment`` pods
   of its variant, and ``ENCODER_CHECKPOINT_DIR`` for the semantic matcher
   and incident recall.  Ten pods in CrashLoopBackOff, one fixture log
   each, half per AIProvider, are poked with the reference demo's
   MODIFIED patch, the engine's admission held until all ten requests are
   queued; then a new pod with the log of a pod that stored an
   explanation (a recall hit), and pods with that log's numbers changed,
   then the next candidate's, until one changes the fingerprint (near or
   miss).  Every pod must carry its annotations, a ``recentFailures``
   entry whose status follows the provider's answer (``Analyzed``, or
   ``PatternOnly`` when seeded weights decode to blanks) and its two
   Events, the SLO ledger must settle each analysis once as completed, K1
   must launch 22 times per step of the drive and never for the hit, K5
   once per semantic ``analyze()`` and once per recall ``query()`` over a
   non-empty index, and ``/metrics`` must show the hit.  One more
   request's 22 K1 calls and one ``analyze()``'s K5 call are held to the
   plain versions, and a direct ``TPUNativeProvider`` drive of the same
   captured requests on an engine of the same weights (admission held
   too) must give the greedy pods' stored explanations.  Per pod: the
   wall from the poke to the stored status, its stage split from the
   span tree (collect, analyze, recall, generate, store) and the host
   time outside the engine; the drive's tokens/s against the checkpoint
   phase's provider drive, and the recall hit's wall;
8. remote: the serving front as a service and the operator's remote
   path, on the checkpoint phase's two checkpoints (kept for it too): two
   ``CompletionServer``s, replicas A and B, on an event loop of their own
   over one engine on the card, with the encoder as the embedder and the
   ``tpu-native`` provider as the analysis backend.  (a) The ten fixture
   prompts as chat requests, half greedy, 32 tokens, streamed, then the
   same ten plain, each drive held until all ten are queued in order, on
   an empty prefix cache from the same sampler state: each greedy
   stream's deltas must join to its plain text.  (b) A stream of 256
   tokens whose socket closes after its first chunk: its row must leave
   the scheduler within pipeline depth + 2 steps and the pages balance,
   ``/healthz`` ``inflight`` 0.  (c) Three ``AnalysisRequest``s through
   ``/api/v1/analysis/analyze``, then through ``TPUNativeProvider``
   directly, both held: equal greedy ``AIResponse``s.  (d) The port's
   ``Operator`` with ``providerId: openai-compatible`` naming both
   replicas: the operator phase's ten pods, each analysis held at the
   provider until all ten have their affinity owner; the replica owning
   enough pods is stopped between two held batches of five, so its pods
   fail there, requeue once and land on the other while its breaker
   opens; every pod stores its answer, ``GET /fleet`` lists both
   replicas, and the greedy answers equal a held replay of the captured
   engine requests from each batch's sampler state.  (e)
   ``/v1/embeddings`` of eight fixture lines equals ``embedder.embed``
   bit for bit.  (f) ``/metrics`` parses as Prometheus text and under
   OpenMetrics, and ``POST /profile?seconds=1`` during a short drive
   writes a trace naming K1's kernel.  In every drive K1 launches once
   per layer per step, K5 once per semantic ``analyze()`` and recall
   ``query()`` on the operator side; time to the first chunk, chunks per
   stream, the steps from the close to the release, tokens/s, the
   per-pod stage split and the HTTP overhead per request (the provider's
   dispatch span less the replica's own request span) are printed;
9. parity: small f32 ``tiny-test`` engines on the card (kernels) and on
   the CPU (plain versions) must give the same greedy tokens — the
   continuous engine, and the wave engine with the decode selector at
   ``v1`` and ``v2`` and flash prefill on and off; the continuous engine
   with the prefix cache and an 8 MB host pool over two waves of prompts
   sharing a prefix, a ``spill_cache()`` between them (and the warm wave
   the cold one's on the card); and a ``PatternEngine``
   with a tiny f32 ``NeuralEmbedder`` must find the same events on the
   card as on the CPU over the 12 fixture logs (scores within 1e-4).

``--phases device,kernels,serve,profile`` (or ``...,wave,profile``, the
``v1`` drive, or ``...,analysis,profile``, the long analysis) also drives
that phase's work again under ``torch.profiler`` and prints the device
time by kernel and the device's busy share (not part of the default
run).

The line before the last is one JSON object with a record per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

#: bf16: the plain version rounds the softmax probabilities to bf16 before
#: P.V and rounds again at the end; the kernel keeps them in f32 and rounds
#: once — a few bf16 ulps of outputs of magnitude up to ~3
TOL = {"bfloat16": 6e-2, "float32": 1e-4}
#: the decode (K2/K3) and prefill (K4) kernels, for the same reasons: in
#: bf16 about twice the largest error measured on these cases (0.0078
#: decode, 0.0156 prefill — a bf16 ulp at magnitude 2)
WAVE_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12  # dense tensor-core bf16 peak
F32_FLOPS = 67e12  # float32 on the CUDA cores (K5 does its products there)
#: time_ms's spin before each timed call: 200,000 SM cycles, about 0.1 ms
#: at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 200_000
#: K5: the kernel and the plain version sum the same f32 products in
#: different orders (bf16 inputs are widened exactly)
SIM_TOL = 1e-5

#: the serve and wave phases' requests: prompt lengths in characters and
#: the completion budget
PROMPT_CHARS = [16, 40, 100, 220, 400, 700, 1000, 1500, 64, 300]
MAX_TOKENS = 32
#: the held requests' prompt (LOG_LINE * 5) in tokens: 785 bytes + BOS
HIT_PROMPT_TOKENS = 786

LOG_LINE = (
    "2026-10-16T12:00:01Z kubelet[812]: Back-off restarting failed container "
    "app in pod web-7d9f8c (exit code 137, reason OOMKilled, memory limit "
    "512Mi exceeded)\n"
)


def fail(message: str) -> "SystemExit":
    return SystemExit(f"chip_smoke: FAIL: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def tensor_core_instructions(build) -> dict:
    """Each built library's count of tensor-core instructions in its SASS
    (``HMMA``: mma.sync; ``HGMMA``: wgmma), read by ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    counts = {}
    for name in build.source_names():
        sass = subprocess.run(
            [tool, "-sass", str(build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True,
        ).stdout
        counts[name] = len(re.findall(r"\bHG?MMA\b", sass))
    return counts


def prefill_drive_limit(dtype: str, want_abs):
    """The per-element limit for the wave drive's own K4 calls: WAVE_TOL
    plus one bf16 ulp of the output (2^-7 |plain|), never above K1's 6e-2.
    Those calls reach |out| = 4.16, where one ulp is 0.03125, and the
    kernel rounds P to bf16 before normalising while the plain version
    rounds it after, so the two can land one ulp apart (0.03125 measured
    on an H100); small outputs keep the 3e-2 of the kernels phase."""
    if dtype != "bfloat16":
        return WAVE_TOL[dtype]
    return (WAVE_TOL[dtype] + want_abs * 2.0 ** -7).clamp(max=TOL[dtype])


class HeldToPlain:
    """Stands in for a kernel's dispatch function: the first ``calls``
    calls that ``select`` accepts are each held to the plain version on
    their own inputs right after the launch (the plain version launches
    none of the port's kernels, so the counts are untouched), rows chosen
    by ``valid``, each element within ``limit(dtype, |plain|)``; ``note``
    adds what a call covered to its record."""

    def __init__(self, fn, plain, calls: int, limit, select=None, valid=None, note=None):
        self.fn, self.plain, self.calls, self.limit = fn, plain, calls, limit
        self.select, self.valid, self.note = select, valid, note
        self.held: list = []

    def __call__(self, *args, **kwargs):
        import torch

        got = self.fn(*args, **kwargs)
        if len(self.held) < self.calls and (self.select is None or self.select(*args)):
            want = self.plain(*args, **kwargs)
            got_v, want_v = got.float(), want.float()
            if self.valid is not None:
                rows = self.valid(*args)
                got_v, want_v = got_v[rows], want_v[rows]
            dtype = str(got.dtype).replace("torch.", "")
            err = (got_v - want_v).abs()
            self.held.append({
                "max_abs_err": err.max().item(),
                "excess": (err - self.limit(dtype, want_v.abs())).max().item(),
                "max_abs_plain": want_v.abs().max().item(),
                "finite": bool(torch.isfinite(got_v).all().item()),
                "dtype": dtype,
                **(self.note(*args, **kwargs) if self.note else {}),
            })
        return got


def held_drive_calls(url: str, module, name: str, held: HeldToPlain, prompt: str) -> dict:
    """One more request, untimed, with ``module.name`` replaced by
    ``held``; fails unless all of its calls were held and each agrees
    (every element within its limit: ``excess`` <= 0).  The record keeps
    the largest of each number over the calls."""
    setattr(module, name, held)
    try:
        _post(url, {"prompt": prompt, "max_tokens": 8, "temperature": 0.0})
    finally:
        setattr(module, name, held.fn)
    calls = held.held
    record = {"calls": len(calls), "dtypes": sorted({c["dtype"] for c in calls})}
    for key in (calls[0] if calls else {}):
        if key not in ("finite", "dtype"):
            record[key] = max(c[key] for c in calls)
    print(json.dumps({"drive_calls": {name: record}}), flush=True)
    bad = [c for c in calls if not c["finite"] or not c["excess"] <= 0]
    if len(calls) != held.calls or bad:
        raise fail(f"{name}: {len(calls)} of {held.calls} drive calls held, outside tolerance: {bad}")
    return record


def k1_split_note(q, k_pages, v_pages, page_table, kv_len, q_count, sliding_window=None) -> dict:
    """How many of tile 0's splits hold keys of a live row in this K1
    call, by the kernel's span rule (``csrc/ragged_attention.cu``
    ``tile_span``) and the wrapper's plan; 1 when the plan does not split."""
    from operator_tpu_torch.ops import ragged_attention as ra

    plan = ra.launch_plan(q, k_pages, page_table)
    group = q.shape[2] // k_pages.shape[2]
    most = 0
    for seq, count in zip(kv_len.tolist(), q_count.tolist()):
        if count <= 0:
            continue
        if plan.n_splits == 1:
            most = max(most, 1)
            continue
        end = min(seq, seq - count + min((ra.TILE_ROWS - 1) // group, count - 1) + 1)
        begin = 0
        if sliding_window:
            begin = max(seq - count - sliding_window + 1, 0)
            begin -= begin % ra.STAGE_KEYS
        most = max(most, -(-end // plan.split_keys) - begin // plan.split_keys)
    return {"n_splits": plan.n_splits, "splits_with_keys": most}


def k2_split_note(q, k_pages, v_pages, page_table, lengths, sliding_window=None) -> dict:
    """How many of the decode kernel's splits hold keys of the longest
    row in this K2/K3 call, by the kernel's span rule
    (``csrc/paged_attention.cu``) and the wrapper's plan; 1 when the plan
    does not split."""
    from operator_tpu_torch.ops import paged_attention as pa
    from operator_tpu_torch.ops import ragged_attention as ra

    plan = pa.launch_plan(q, k_pages, page_table)
    most = 0
    for seq in lengths.tolist():
        end = min(seq, page_table.shape[1] * k_pages.shape[1])
        lo = max(seq - sliding_window, 0) if sliding_window else 0
        begin = lo - lo % ra.STAGE_KEYS
        if plan.n_splits == 1 or end <= begin:
            most = max(most, 1)
            continue
        most = max(most, (end - 1) // plan.split_keys - begin // plan.split_keys + 1)
    return {"n_splits": plan.n_splits, "splits_with_keys": most}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` with a cold L2: each call is preceded by
    a write of twice the card's 50 MB L2 (outside the timed events), as
    the serving step finds a layer's pages after 21 other layers, and by
    a spin of the card (``torch.cuda._sleep``, about 0.1 ms) that lets the
    host enqueue the call before the start event runs, so a call shorter
    than its host-side work is timed without the host's gap.  All calls
    are enqueued before the one synchronise."""
    import torch

    flush = torch.empty(100 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

B, C, QH, KH, D, PAGE, PPS = 32, 64, 32, 4, 64, 64, 32
MAX_SEQ = PAGE * PPS


def geometry(name: str, rng):
    """(c, kv_len, q_count, window) for one scheduler geometry."""
    import numpy as np

    c, window = C, None
    kv_len = rng.integers(64, MAX_SEQ + 1, size=B)
    if name == "prefill":  # whole prompts and mid-prompt chunks
        q_count = np.minimum(kv_len, C)
        q_count[: B // 2] = kv_len[: B // 2] = rng.integers(1, C + 1, size=B // 2)
    elif name == "decode":
        c = 1
        kv_len = rng.integers(1, MAX_SEQ + 1, size=B)
        q_count = np.ones(B, np.int64)
    elif name == "mixed":  # 24 decode rows, 4 chunks, 4 idle slots
        q_count = np.ones(B, np.int64)
        q_count[24:28] = C
        q_count[28:] = 0
        kv_len[28:] = 0
    elif name == "verify":  # committed token + k prompt-lookup drafts
        q_count = 1 + rng.integers(1, 5, size=B)
    elif name == "idle_rows":  # live rows left out of the step
        q_count = np.where(np.arange(B) % 2 == 0, 1, 0)
    elif name == "window":
        q_count = np.ones(B, np.int64)
        q_count[::4] = C
        window = 200
    elif name == "ragged":  # kv_len never a multiple of the page size
        kv_len = PAGE * rng.integers(1, PPS, size=B) + rng.integers(1, PAGE, size=B)
        q_count = np.where(np.arange(B) % 3 == 0, np.minimum(kv_len, 37), 1)
    # the waves of the serve phase's step: at most t_budget = 64 query
    # tokens in all, decode rows first, then one prefill chunk
    elif name == "wave_decode":  # every slot decodes
        q_count = np.ones(B, np.int64)
    elif name == "wave_mixed":  # 24 decode rows, a 40-token chunk, idle slots
        q_count = np.zeros(B, np.int64)
        q_count[:24] = 1
        q_count[24] = 40
        kv_len[25:] = 0
    elif name == "wave_prefill":  # one 64-token chunk of a long prompt
        q_count = np.zeros(B, np.int64)
        q_count[0] = C
        kv_len[1:] = 0
        kv_len[0] = rng.integers(C, 1536 + 1)
    elif name == "wave_hit":  # a prefix-cache hit's first chunk: the held
        # warm request of the serve phase, 786 prompt tokens of which 12
        # pages were cached, so 18 queries at the end of 786 keys
        q_count = np.zeros(B, np.int64)
        q_count[0] = HIT_PROMPT_TOKENS - cached_tokens(HIT_PROMPT_TOKENS)
        kv_len[1:] = 0
        kv_len[0] = HIT_PROMPT_TOKENS
    else:
        raise ValueError(name)
    return c, kv_len.astype(np.int32), q_count.astype(np.int32), window


def kernel_case(name: str, dtype, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    c, kv_len, q_count, window = geometry(name, rng)
    num_pages = B * PPS + 1
    table = (1 + rng.permutation(num_pages - 1)[: B * PPS]).reshape(B, PPS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (num_pages, PAGE, KH, D)
    k_pages = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v_pages = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = torch.randn((B, c, QH, D), generator=gen, device="cuda").to(dtype)
    args = (
        q, k_pages, v_pages,
        torch.as_tensor(table, dtype=torch.int32, device="cuda"),
        torch.as_tensor(kv_len, device="cuda"),
        torch.as_tensor(q_count, device="cuda"),
    )
    return args, window, kv_len, q_count


def bound(kv_len, q_count, window, itemsize):
    """Least time for the function on these inputs: live KV (each row's
    in-window keys), the valid q rows and out rows, the indices; and the
    QK^T + PV operations at the bf16 tensor-core peak."""
    live_kv = 0
    flops = 0
    for length, count in zip(kv_len.tolist(), q_count.tolist()):
        if count <= 0:
            continue
        live_kv += min(length, window or length)
        for i in range(count):
            q_pos = length - count + i
            keys = min(q_pos + 1, window or (q_pos + 1))
            flops += 4 * keys * QH * D
    nbytes = live_kv * KH * D * 2 * itemsize + 2 * int(sum(q_count)) * QH * D * itemsize
    nbytes += (len(kv_len) * PPS + 2 * len(kv_len)) * 4
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def sdpa(q, k, v, mask):
    """One ``scaled_dot_product_attention`` call over [B, H, T, D] tensors
    with a boolean mask; GQA by ``enable_gqa`` or, on a torch without it,
    by expanding the KV heads first (outside the timing)."""
    import torch.nn.functional as F

    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    except TypeError:
        group = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def library_call(args, window):
    """One PyTorch call computing the same function:
    scaled_dot_product_attention over the pre-gathered KV with the
    ragged causal mask (built outside the timing)."""
    import torch

    q, k_pages, v_pages, table, kv_len, q_count = args
    b, c = q.shape[0], q.shape[1]
    k = k_pages[table.long()].reshape(b, MAX_SEQ, KH, D).transpose(1, 2).contiguous()
    v = v_pages[table.long()].reshape(b, MAX_SEQ, KH, D).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()  # [B, QH, C, D]
    kv_pos = torch.arange(MAX_SEQ, device="cuda")[None, None, :]
    q_pos = ((kv_len - q_count).long()[:, None] + torch.arange(c, device="cuda"))[:, :, None]
    mask = (kv_pos <= q_pos) & (kv_pos < kv_len.long()[:, None, None])
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    return sdpa(qd, k, v, mask[:, None])


def phase_kernels(results: dict) -> dict:
    import torch

    from operator_tpu_torch.ops import ragged_attention as ra

    geometries = [
        "prefill", "decode", "mixed", "verify", "idle_rows", "window", "ragged",
        "wave_decode", "wave_mixed", "wave_prefill", "wave_hit",
    ]
    checks = []
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for seed, name in enumerate(geometries):
            args, window, kv_len, q_count = kernel_case(name, dtype, seed)
            got = ra.ragged_attention_cuda(*args, sliding_window=window)
            torch.cuda.synchronize()
            want = ra.ragged_attention_reference(*args, sliding_window=window)
            c = args[0].shape[1]
            valid = torch.arange(c, device="cuda")[None, :] < args[5][:, None]
            err = (got[valid].float() - want[valid].float()).abs().max().item()
            finite = bool(torch.isfinite(got[valid].float()).all().item())
            checks.append({"geometry": name, "dtype": dname, "max_abs_err": err,
                           "tol": TOL[dname], "finite": finite})
            print(json.dumps({"kernel_check": checks[-1]}), flush=True)
            if not finite or not err <= TOL[dname]:
                raise fail(f"ragged kernel {name}/{dname}: max_abs_err={err} (tol {TOL[dname]})")
            if dname == "bfloat16":
                worst = max(worst, err)
    # the serve phase's waves in bf16 (and a prefix-cache hit's first
    # chunk); the mixed one is the record
    timings = {}
    for name in ("wave_decode", "wave_mixed", "wave_prefill", "wave_hit"):
        args, window, kv_len, q_count = kernel_case(name, torch.bfloat16, 100)
        bound_ms, bound_by = bound(kv_len, q_count, window, 2)
        timings[name] = {
            "ms": time_ms(lambda: ra.ragged_attention_cuda(*args, sliding_window=window), 50),
            "plain_ms": time_ms(
                lambda: ra.ragged_attention_reference(*args, sliding_window=window), 5
            ),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(library_call(args, window), 20),
        }
        print(json.dumps({"kernel_timing": {
            "geometry": name, **timings[name], "bound_us": bound_ms * 1e3,
        }}), flush=True)
    record = {
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "operator_tpu_torch/ops/csrc/ragged_attention.cu",
        "replaces": "operator_tpu/ops/ragged_attention.py:114",
        "launches": None,  # filled by the serve phase
        "max_abs_err": worst,
        **timings["wave_mixed"],
        "geometries": timings,  # the serve phase's waves and the hit chunk
    }
    results["kernel_checks"] = checks
    results["kernel_timings"] = timings
    return record


#: the serve and wave phases' prompts in tokens (byte tokenizer: chars + BOS)
PROMPT_TOKENS = [n + 1 for n in PROMPT_CHARS]


def cached_tokens(prompt_tokens: int, page: int = PAGE) -> int:
    """Prompt tokens a warm request reuses from the prefix cache: every
    full block but the one the match leaves so one token prefills
    (``(len - 1) // page`` blocks)."""
    return (prompt_tokens - 1) // page * page


def decode_case(name: str, dtype, seed: int):
    """(args, window, lengths) of the paged decode kernel at tinyllama's
    shapes: 32 rows, page 64, 32 pages per row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    window = None
    released: list = []
    lengths = rng.integers(1, MAX_SEQ + 1, size=B)
    lengths[:6] = [1, 64, 128, 2048, 63, 65]  # length 1, full pages, page edges
    if name == "decode_window":
        window = 200
    elif name == "decode_released":  # finished slots: zero table, length 1
        released = list(range(0, B, 3))
        lengths[released] = 1
    elif name == "decode_wave":
        # the wave path's decode rows: the serve phase's ten requests half
        # way through their 32 tokens, the other 22 slots never admitted
        lengths[:] = 1
        released = list(range(len(PROMPT_TOKENS), B))
        lengths[: len(PROMPT_TOKENS)] = [n + 16 for n in PROMPT_TOKENS]
    num_pages = B * PPS + 1
    table = (1 + rng.permutation(num_pages - 1)[: B * PPS]).reshape(B, PPS)
    table[released] = 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (num_pages, PAGE, KH, D)
    args = (
        torch.randn((B, QH, D), generator=gen, device="cuda").to(dtype),
        torch.randn(shape, generator=gen, device="cuda").to(dtype),
        torch.randn(shape, generator=gen, device="cuda").to(dtype),
        torch.as_tensor(table, dtype=torch.int32, device="cuda"),
        torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
    )
    return args, window, lengths


def decode_bound(lengths, window, itemsize):
    """Least time of one decode call: each row's live K and V read once,
    q read, out written, the ids of the pages holding live keys and the
    lengths read; 4 * keys * QH * D operations at the bf16 tensor-core
    peak."""
    keys = live_pages = 0
    for n in map(int, lengths):
        first = max(n - window, 0) if window else 0
        keys += n - first
        live_pages += (n - 1) // PAGE - first // PAGE + 1
    nbytes = keys * KH * D * 2 * itemsize + 2 * B * QH * D * itemsize + (live_pages + B) * 4
    flops = 4 * keys * QH * D
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def decode_library_call(args, window):
    """SDPA over the gathered KV with the length (and window) mask."""
    import torch

    q, k_pages, v_pages, table, lengths = args
    k = k_pages[table.long()].reshape(B, MAX_SEQ, KH, D).transpose(1, 2).contiguous()
    v = v_pages[table.long()].reshape(B, MAX_SEQ, KH, D).transpose(1, 2).contiguous()
    pos = torch.arange(MAX_SEQ, device="cuda")[None, :]
    mask = pos < lengths.long()[:, None]
    if window is not None:
        mask = mask & (pos >= lengths.long()[:, None] - window)
    return sdpa(q[:, :, None, :].contiguous(), k, v, mask[:, None, None, :])


def prefill_case(name: str, dtype, seed: int):
    """(args, window, lengths) of the flash-prefill kernel at tinyllama's
    head layout."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    window = None
    if name == "prefill_t64_b1":
        t, lengths = 64, [64]
    elif name == "prefill_t512_b8":
        t, lengths = 512, [512, 1, 300, 77, 511, 256, 130, 64]
    elif name == "prefill_t2048_b1":
        t, lengths = 2048, [1501]
    elif name == "prefill_t2048_b8":
        t, lengths = 2048, [2048, 1, 1501, 700, 65, 1024, 2000, 333]
    elif name == "prefill_window":
        t, lengths, window = 512, [512, 40, 300, 9, 511, 256, 130, 64], 128
    elif name == "prefill_wave":
        # the wave path's first prefill bucket: the serve phase's ten
        # prompts, padded to 16 rows with copies of row 0, t = 2048
        t = 2048
        lengths = PROMPT_TOKENS + [PROMPT_TOKENS[0]] * 6
    else:
        raise ValueError(name)
    b = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = (
        torch.randn((b, t, QH, D), generator=gen, device="cuda").to(dtype),
        torch.randn((b, t, KH, D), generator=gen, device="cuda").to(dtype),
        torch.randn((b, t, KH, D), generator=gen, device="cuda").to(dtype),
        torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
    )
    return args, window, np.asarray(lengths)


def prefill_bound(lengths, t, window, itemsize):
    """Least time of one prefill call: q read and out written over all T
    positions (padded query rows are part of the output), K and V read at
    the positions some query row attends to — the first ``length`` of
    each row, and V at all T where the window leaves a padded query with
    no key (the plain version averages V there); 4 * QH * D operations
    for every (query, key) pair the mask admits, padded query rows
    included, and 2 * QH * D * T for each query row with no key, at the
    bf16 tensor-core peak."""
    import numpy as np

    q_pos = np.arange(t)
    kv_rows = flops = 0
    for length in lengths.tolist():
        hi = np.minimum(q_pos + 1, length)  # keys <= q and < length
        lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros_like(q_pos)
        keys = np.clip(hi - lo, 0, None)
        empty = int((keys == 0).sum())
        kv_rows += length + (t if empty else length)  # K rows + V rows
        flops += 4 * QH * D * int(keys.sum()) + 2 * QH * D * t * empty
    nbytes = (len(lengths) * t * 2 * QH + kv_rows * KH) * D * itemsize + len(lengths) * 4
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def prefill_library_call(args, window):
    """SDPA with the causal + length (+ window) mask, built outside the
    timing (SDPA takes is_causal or a mask, not both)."""
    import torch

    q, k, v, lengths = args
    t = q.shape[1]
    pos = torch.arange(t, device="cuda")
    mask = (pos[None, :] <= pos[:, None])[None] & (
        pos[None, None, :] < lengths.long()[:, None, None]
    )
    if window is not None:
        mask = mask & (pos[None, :] > pos[:, None] - window)[None]
    return sdpa(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), mask[:, None],
    )


def phase_wave_kernels(results: dict) -> list:
    """The paged decode kernel (K2/K3) and the flash-prefill kernel (K4)
    against their plain versions, every row; then their times."""
    import torch

    from operator_tpu_torch.ops import flash_prefill as fp
    from operator_tpu_torch.ops import paged_attention as pa

    checks = []
    worst = {"decode": 0.0, "prefill": 0.0}
    cases = [("decode", name) for name in (
        "decode_mixed", "decode_window", "decode_released", "decode_wave",
    )] + [("prefill", name) for name in (
        "prefill_t64_b1", "prefill_t512_b8", "prefill_t2048_b1", "prefill_t2048_b8",
        "prefill_window",
    )]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for seed, (kind, name) in enumerate(cases):
            if kind == "decode":
                args, window, _ = decode_case(name, dtype, seed)
                got = pa.paged_attention_cuda(*args, sliding_window=window)
                torch.cuda.synchronize()
                want = pa.paged_attention_reference(*args, sliding_window=window)
            else:
                args, window, _ = prefill_case(name, dtype, seed)
                got = fp.flash_prefill_cuda(*args, sliding_window=window)
                torch.cuda.synchronize()
                want = fp.flash_prefill_reference(*args, sliding_window=window)
            err = (got.float() - want.float()).abs().max().item()
            finite = bool(torch.isfinite(got.float()).all().item())
            del got, want
            torch.cuda.empty_cache()
            tol = WAVE_TOL[dname]
            checks.append({"kernel": kind, "geometry": name, "dtype": dname,
                           "max_abs_err": err, "tol": tol, "finite": finite})
            print(json.dumps({"kernel_check": checks[-1]}), flush=True)
            if not finite or not err <= tol:
                raise fail(f"{kind} kernel {name}/{dname}: max_abs_err={err} (tol {tol})")
            if dname == "bfloat16":
                worst[kind] = max(worst[kind], err)
    timings = {}
    for kind, name in (("decode", "decode_wave"), ("decode", "decode_mixed"),
                       ("prefill", "prefill_wave"), ("prefill", "prefill_t2048_b8")):
        if kind == "decode":
            args, window, lengths = decode_case(name, torch.bfloat16, 100)
            bound_ms, bound_by = decode_bound(lengths, window, 2)
            kernel = lambda: pa.paged_attention_cuda(*args, sliding_window=window)  # noqa: E731
            plain = lambda: pa.paged_attention_reference(*args, sliding_window=window)  # noqa: E731
            library = decode_library_call(args, window)
            iters = (50, 5, 20)
        else:
            args, window, lengths = prefill_case(name, torch.bfloat16, 100)
            bound_ms, bound_by = prefill_bound(lengths, args[0].shape[1], window, 2)
            kernel = lambda: fp.flash_prefill_cuda(*args, sliding_window=window)  # noqa: E731
            plain = lambda: fp.flash_prefill_reference(*args, sliding_window=window)  # noqa: E731
            library = prefill_library_call(args, window)
            iters = (5, 2, 5)
        timings[name] = {
            "ms": time_ms(kernel, iters[0]),
            "plain_ms": time_ms(plain, iters[1], warmup=1),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(library, iters[2]),
        }
        del args, library
        torch.cuda.empty_cache()
        print(json.dumps({"kernel_timing": {
            "geometry": name, **timings[name], "bound_us": bound_ms * 1e3,
        }}), flush=True)
    results["wave_kernel_checks"] = checks
    results["wave_kernel_timings"] = timings
    # both selector values launch this one kernel, so its check and times
    # stand in both records; each record's launches come from the wave
    # drive under its own selector value
    decode = {
        "route": "cuda",
        "source": "operator_tpu_torch/ops/csrc/paged_attention.cu",
        "launches": None,  # filled by the wave phase
        "max_abs_err": worst["decode"],
        **timings["decode_wave"],
        "geometries": {name: timings[name] for name in ("decode_wave", "decode_mixed")},
    }
    return [
        {"name": "paged_decode_attention_v2", **decode,
         "replaces": "operator_tpu/ops/paged_attention.py:252"},
        {"name": "paged_decode_attention_v1", **decode,
         "replaces": "operator_tpu/ops/paged_attention.py:191"},
        {"name": "flash_prefill_attention", "route": "cuda",
         "source": "operator_tpu_torch/ops/csrc/flash_prefill.cu",
         "replaces": "operator_tpu/ops/flash_prefill.py:78",
         "launches": None, "max_abs_err": worst["prefill"],
         **timings["prefill_wave"]},
    ]


#: K5's geometries on the semantic path: name -> (windows, patterns, D)
SIM_GEOMETRIES = {
    "analysis": (4096, 19, 384),  # max_windows x the built-in library
    "library": (4096, 1024, 384),  # the same log against a large library
    "recall": (1, 2048, 384),  # one query x IncidentStore.max_entries
    # any D, as the JAX kernel: rows off 16-byte vectors, and rows of 6 KB
    # (an encoder wider than 1,024 in f32: the streaming layout)
    "odd_d": (4096, 19, 385),
    "wide_d": (4096, 19, 1536),
}


def similarity_case(name: str, dtype, seed: int, duplicated: bool = False):
    """(windows, patterns) of unit rows on the card.  ``duplicated``: each
    pattern is a copy of one window row in the first half, and that row
    appears again right after it, one tile on and near the end, so the
    first copy is the only right index (returned as the third item)."""
    import numpy as np
    import torch

    w, p, d = SIM_GEOMETRIES[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    windows = torch.nn.functional.normalize(
        torch.randn((w, d), generator=gen, device="cuda"), dim=-1).to(dtype)
    patterns = torch.nn.functional.normalize(
        torch.randn((p, d), generator=gen, device="cuda"), dim=-1).to(dtype)
    firsts = None
    if duplicated:
        rng = np.random.default_rng(seed)
        firsts = rng.choice(w // 2, size=min(p, w // 2), replace=False)
        taken = set(firsts.tolist())
        for j, first in enumerate(firsts.tolist()):
            for later in (first + 1, first + 65, w - 1 - j):
                if later < w and later not in taken:
                    windows[later] = windows[first]
            patterns[j] = windows[first]
    return windows, patterns, firsts


def similarity_bound(w: int, p: int, d: int, itemsize: int):
    """Least time of one best-window call: both matrices read once, the
    scores and indices written once; 2 * W * P * D float32 operations on
    the CUDA cores."""
    nbytes = (w + p) * d * itemsize + p * 8
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * w * p * d / F32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_similarity(windows, patterns, scores, idx) -> float:
    """K5's result against the plain version on the same inputs: the
    largest error of the scores and of the plain score at the chosen
    window (cuBLAS may order near-equal windows differently)."""
    import torch

    from operator_tpu_torch.ops import similarity as sim

    want, _ = sim.best_window_scores_reference(windows, patterns)
    matrix = sim.similarity_matrix(windows, patterns)
    chosen = matrix[idx.long(), torch.arange(patterns.shape[0], device=matrix.device)]
    return max((scores - want).abs().max().item(), (chosen - want).abs().max().item())


def phase_similarity_kernels(results: dict, phases: set) -> dict:
    """K5 against its plain version at the three geometries in bf16 and
    f32, exact first indices on repeated rows; then its f32 times (and,
    with ``profile``, ten calls per geometry under ``torch.profiler``)."""
    import torch

    from operator_tpu_torch.ops import similarity as sim

    checks = []
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for seed, name in enumerate(SIM_GEOMETRIES):
            for duplicated in (False, True):
                if duplicated and name == "recall":
                    continue  # one window: nothing to repeat
                windows, patterns, firsts = similarity_case(name, dtype, seed, duplicated)
                scores, idx = sim.best_window_scores_cuda(windows, patterns)
                torch.cuda.synchronize()
                err = check_similarity(windows, patterns, scores, idx)
                exact = True
                if duplicated:
                    got = idx[: len(firsts)].cpu().numpy()
                    exact = bool((got == firsts).all())
                checks.append({"kernel": "similarity", "geometry": name, "dtype": dname,
                               "repeated_rows": duplicated, "max_abs_err": err,
                               "tol": SIM_TOL, "first_index_exact": exact})
                print(json.dumps({"kernel_check": checks[-1]}), flush=True)
                if not err <= SIM_TOL or not exact:
                    raise fail(f"similarity kernel {name}/{dname} repeated={duplicated}: "
                               f"max_abs_err={err} (tol {SIM_TOL}), first index exact={exact}")
                worst = max(worst, err)
    timings = {}
    for name, (w, p, d) in SIM_GEOMETRIES.items():
        windows, patterns, _ = similarity_case(name, torch.float32, 100)
        bound_ms, bound_by = similarity_bound(w, p, d, 4)
        timings[name] = {
            "ms": time_ms(lambda: sim.best_window_scores_cuda(windows, patterns), 50),
            "plain_ms": time_ms(lambda: sim.best_window_scores_reference(windows, patterns), 20),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(lambda: torch.matmul(windows, patterns.T).max(0), 20),
        }
        print(json.dumps({"kernel_timing": {
            "kernel": "similarity", "geometry": name, **timings[name], "bound_us": bound_ms * 1e3,
        }}), flush=True)
    results["similarity_kernel_checks"] = checks
    results["similarity_kernel_timings"] = timings
    results["similarity_host_us"] = {
        name: similarity_host_us(*similarity_case(name, torch.float32, 100)[:2])
        for name in ("analysis", "recall")
    }
    print(json.dumps({"similarity_host_us": results["similarity_host_us"]}), flush=True)
    if "profile" in phases:  # the kernels' own device time, without time_ms's events
        results["similarity_kernel_profile"] = {}
        for name in SIM_GEOMETRIES:
            windows, patterns, _ = similarity_case(name, torch.float32, 100)
            results["similarity_kernel_profile"][name] = profile_call(
                lambda: [sim.best_window_scores_cuda(windows, patterns) for _ in range(10)])
    return {
        "name": "best_window_similarity",
        "route": "cuda",
        "source": "operator_tpu_torch/ops/csrc/similarity.cu",
        "replaces": "operator_tpu/ops/similarity.py:85",
        "launches": None,  # filled by the analysis phase
        "max_abs_err": worst,
        **timings["analysis"],
        "geometries": timings,
    }


def similarity_host_us(windows, patterns, iters: int = 400) -> dict:
    """The K5 wrapper's host time per call in microseconds, part by part:
    each part run ``iters`` times back to back on the host clock (the card
    is not waited for; a synchronise ends each part, outside its time).
    ``checks`` is the whole call less the parts timed."""
    import torch

    from operator_tpu_torch.ops import similarity as sim

    (w, d), p = windows.shape, patterns.shape[0]
    device = windows.device
    fn = sim._kernel_fn()
    plan = sim.launch_plan(w, p, d, 4, sim._sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    scores = torch.empty(p, dtype=torch.float32, device=device)
    best = torch.empty(p, dtype=torch.int32, device=device)
    part_s = torch.empty((plan.shares, p), dtype=torch.float32, device=device)
    part_i = torch.empty((plan.shares, p), dtype=torch.int32, device=device)
    counters = sim.ticket_counters(device, stream, plan.p_tiles)
    scratch = plan.shares > 1
    ptrs = (part_s.data_ptr(), part_i.data_ptr(), counters.data_ptr()) if scratch else (None,) * 3

    def outputs():
        torch.empty(p, dtype=torch.float32, device=device)
        torch.empty(p, dtype=torch.int32, device=device)

    def scratches():
        if scratch:
            torch.empty((plan.shares, p), dtype=torch.float32, device=device)
            torch.empty((plan.shares, p), dtype=torch.int32, device=device)
            sim.ticket_counters(device, stream, plan.p_tiles)

    parts = {
        "call": lambda: sim.best_window_scores_cuda(windows, patterns),
        "plan": lambda: sim.launch_plan(w, p, d, 4, sim._sm_count(device)),
        "stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "outputs": outputs,
        "scratch": scratches,
        "launch": lambda: fn(windows.data_ptr(), patterns.data_ptr(), scores.data_ptr(),
                             best.data_ptr(), *ptrs, w, p, d, plan.config, plan.share_w,
                             plan.shares, 0, stream),
    }
    out = {}
    for name, part in parts.items():
        for _ in range(20):
            part()
        torch.cuda.synchronize()
        started = time.perf_counter()
        for _ in range(iters):
            part()
        out[name] = (time.perf_counter() - started) / iters * 1e6
        torch.cuda.synchronize()
    out["checks"] = out["call"] - sum(v for k, v in out.items() if k != "call")
    out["shares"] = plan.shares
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path through the HTTP server
# ---------------------------------------------------------------------------

SERVE_ENV = {
    "OPERATOR_TPU_MODEL": "tinyllama-1.1b",
    "ALLOW_RANDOM_WEIGHTS": "true",
    "SERVING_DTYPE": "int8",
    "MAX_BATCH_SIZE": "32",
    "KV_PAGE_SIZE": "64",
    "SCHED_CHUNK": "64",
    "SCHED_PIPELINE_DEPTH": "2",
    "SPEC_DECODE": "true",
}


class HttpLoop:
    """The port's ``CompletionServer``s (asyncio ``start``/``stop``) on an
    event loop of their own thread, while the drives talk to them over
    urllib from this one."""

    def __init__(self, *servers) -> None:
        self.servers = list(servers)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="http", daemon=True)
        self.thread.start()
        for server in self.servers:
            self.run(server.start())

    def run(self, coro, timeout: float = 600.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self) -> None:
        """Stop every server still listening, then the loop."""
        try:
            for server in self.servers:
                if server.bound_port is not None:
                    self.run(server.stop(), timeout=120)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
            self.loop.close()


def healthz(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
        return json.loads(resp.read())


def _post(url: str, body: dict, timeout: float = 600.0) -> dict:
    request = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(request, timeout=timeout) as resp:
        return json.loads(resp.read())


def request_bodies() -> list:
    prompts = [(LOG_LINE * (n // len(LOG_LINE) + 1))[:n] for n in PROMPT_CHARS]
    return [
        {"prompt": p, "max_tokens": MAX_TOKENS,
         "temperature": 0.0 if i % 2 == 0 else 0.7, "top_p": 0.95}
        for i, p in enumerate(prompts)
    ]


def drive_requests(url: str, bodies: list) -> tuple:
    """Send every body at once from its own thread; returns (completion
    tokens, wall seconds).  Fails unless every request finished with a
    sane usage record."""
    replies: list = [None] * len(bodies)
    errors: list = []

    def send(i: int) -> None:
        try:
            replies[i] = _post(url, bodies[i])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {exc!r}")

    started = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(900)
    wall = time.perf_counter() - started
    if errors or any(t.is_alive() for t in threads):
        raise fail(f"requests failed: {errors}")
    completion = 0
    for body, reply in zip(bodies, replies):
        choice = reply["choices"][0]
        usage = reply["usage"]
        if choice["finish_reason"] not in ("length", "stop"):
            raise fail(f"unexpected finish_reason {choice['finish_reason']}")
        if usage["prompt_tokens"] != len(body["prompt"].encode()) + 1:
            raise fail(f"prompt_tokens {usage['prompt_tokens']} for {len(body['prompt'])} chars")
        if not 0 <= usage["completion_tokens"] <= MAX_TOKENS:
            raise fail(f"completion_tokens {usage['completion_tokens']}")
        completion += usage["completion_tokens"]
    if completion == 0:
        raise fail("no request generated any token")
    return completion, wall


def balanced(sched, where: str) -> dict:
    """The scheduler's page accounting, failing unless it balances in
    four terms: free + rows' grants + the prefix cache's pages + the
    shared-prefix hold == every page but the trash page."""
    acc = sched.page_accounting()
    if acc["available"] + acc["row_pages"] + acc["store_pages"] + acc["prefix_pages"] != acc["total"]:
        raise fail(f"page accounting does not balance {where}: {acc}")
    return acc


def wait_idle(sched) -> None:
    deadline = time.time() + 30
    while sched.num_active and time.time() < deadline:
        time.sleep(0.05)


def timed_drive(url: str, sched, config, kernel_modules: dict, where: str,
                bodies: "list | None" = None) -> dict:
    """The ten requests once, every kernel count set to 0 just before and
    read just after: K1 exactly once per layer per step, the others never;
    the scheduler holds no row after it and its pages balance.  Returns
    the drive's record, the prefix cache's economy over it included."""
    g = sched.generator
    bodies = bodies or request_bodies()
    counter = g.metrics.counter
    kv_names = ("kv_hit", "kv_miss", "kv_prefill_tokens_saved", "kv_evict",
                "kv_offload", "kv_restore")
    kv0 = {name: counter(name) for name in kv_names}
    ring = g.step_clock.ring
    seq0 = ring.records(1)[0].seq if len(ring) else -1
    for module in kernel_modules.values():
        module.launches = 0
    steps0, dev0 = sched.steps, len(sched.device_ms)
    completion, wall = drive_requests(url, bodies)
    launches = {name: m.launches for name, m in kernel_modules.items()}
    steps = sched.steps - steps0
    device_ms = sched.device_ms[dev0:]
    wait_idle(sched)
    accounting = balanced(sched, f"after the {where} drive")
    if accounting["row_pages"]:
        raise fail(f"rows hold pages after the {where} drive: {accounting}")
    if launches["ragged_paged_attention"] != config.num_layers * steps or steps == 0:
        raise fail(
            f"{where} drive: ragged kernel launched {launches['ragged_paged_attention']} "
            f"times over {steps} steps of {config.num_layers} layers"
        )
    others = {k: n for k, n in launches.items() if k != "ragged_paged_attention"}
    if any(others.values()):
        raise fail(f"other kernels launched on the continuous path: {others}")
    records = [r for r in ring.records() if r.seq > seq0]
    return {
        "completion_tokens": completion, "wall_s": wall,
        "tokens_per_s": completion / wall, "steps": steps,
        "device_ms_per_step": sum(device_ms) / len(device_ms) if device_ms else None,
        "launches": launches, "page_accounting": accounting,
        "kv_economy": {name[3:]: counter(name) - kv0[name] for name in kv_names},
        "cached_tokens": sum(r.cached_tokens or 0 for r in records),
        "step_records": len(records),
    }


def phase_serve(results: dict, kernel_modules: dict, phases: set) -> dict:
    import torch

    from operator_tpu_torch.ops import ragged_attention as ra
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine
    from operator_tpu_torch.serving.sched import mixed as mixed_module

    t0 = time.perf_counter()
    engine, model_id = build_serving_engine("cuda", SERVE_ENV, seed=0)
    config = engine.generator.config
    if (config.num_layers, config.hidden_size, config.num_heads) != (22, 2048, 32):
        raise fail(f"not tinyllama-1.1b at full width: {config}")
    sched = engine.scheduler
    if sched._kvstore is None or sched._kvstore.host_pool is not None:
        raise fail("the default continuous engine has no prefix cache, or a host pool")
    engine.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
    http = HttpLoop(server)
    url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
    try:
        # one short request first so the timed drive is not a cold start
        _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
        # the cold drive: the prefix cache holds nothing of these prompts;
        # a request admitted after another finished its prefill can hit
        cold = timed_drive(url, sched, config, kernel_modules, "cold")
        launches = cold["launches"]
        stats = sched.stats()
        if "profile" in phases:
            sched.spill_cache()  # profile a cold drive, as before the cache
            results["profile"] = profile_drive(url, request_bodies())
        # a prompt over two splits long; the held step is the first whose
        # live rows reach past the prompt: a decode or verify step
        prompt = LOG_LINE * 5
        prompt_tokens = len(prompt.encode()) + 1
        if prompt_tokens != HIT_PROMPT_TOKENS:
            raise fail(f"the held prompt has {prompt_tokens} tokens")
        held = held_drive_calls(url, mixed_module, "ragged_paged_attention", HeldToPlain(
            mixed_module.ragged_paged_attention, ra.ragged_attention_reference,
            config.num_layers, lambda dtype, _: TOL[dtype],
            select=lambda q, k, v, table, kv_len, q_count: (
                (kv_len * (q_count > 0)).max().item() > prompt_tokens),
            valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
            note=k1_split_note,
        ), prompt)
        if held["splits_with_keys"] < 3:
            raise fail(f"the held K1 step's tile 0 had keys in {held['splits_with_keys']} splits, want >= 3")
        # the same prompt again, held on its FIRST prefill step: a cache
        # hit, 12 of its 13 pages store-owned, so 18 queries at kv_len 786
        hit_q = prompt_tokens - cached_tokens(prompt_tokens)
        saved0 = engine.generator.metrics.counter("kv_prefill_tokens_saved")
        held_hit = held_drive_calls(url, mixed_module, "ragged_paged_attention", HeldToPlain(
            mixed_module.ragged_paged_attention, ra.ragged_attention_reference,
            config.num_layers, lambda dtype, _: TOL[dtype],
            select=lambda q, k, v, table, kv_len, q_count: bool(
                ((kv_len == prompt_tokens) & (q_count == hit_q)).any().item()),
            valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
            note=lambda q, k, v, table, kv_len, q_count, sliding_window=None: {
                **k1_split_note(q, k, v, table, kv_len, q_count, sliding_window),
                "q_count": int(q_count.max().item()), "kv_len": int(kv_len.max().item()),
            },
        ), prompt)
        hit_saved = engine.generator.metrics.counter("kv_prefill_tokens_saved") - saved0
        if hit_saved != cached_tokens(prompt_tokens) or held_hit["q_count"] != hit_q:
            raise fail(f"the held hit request reused {hit_saved} tokens, first chunk "
                       f"{held_hit['q_count']} queries; want {cached_tokens(prompt_tokens)}, {hit_q}")
        # the warm drive: the same ten bodies; every full block but the
        # last of each prompt is cached
        warm = timed_drive(url, sched, config, kernel_modules, "warm")
        want_saved = sum(cached_tokens(n) for n in PROMPT_TOKENS)
        if warm["kv_economy"]["prefill_tokens_saved"] != want_saved:
            raise fail(f"warm drive saved {warm['kv_economy']['prefill_tokens_saved']} "
                       f"prefill tokens, the prompts give {want_saved}")
        if warm["cached_tokens"] != want_saved:
            raise fail(f"warm drive's step records carry {warm['cached_tokens']} cached "
                       f"tokens, want {want_saved}")
        admission = deadline_and_overload(engine, sched)
        spilled = sched.spill_cache()
        after_spill = balanced(sched, "after spill_cache()")
        if after_spill["store_pages"] != 0:
            raise fail(f"store pages left after spill_cache(): {after_spill}")
        summary = engine.generator.step_clock.summary()
        serve = {
            "model": model_id, "layers": config.num_layers, "weights": "int8",
            "slots": engine.generator.max_slots, "requests": len(PROMPT_CHARS),
            "prompt_chars": PROMPT_CHARS, "max_tokens": MAX_TOKENS,
            **{k: v for k, v in cold.items() if k not in ("kv_economy", "cached_tokens")},
            "cold_kv_economy": cold["kv_economy"], "cold_cached_tokens": cold["cached_tokens"],
            "warm": warm, "warm_saved_expected": want_saved,
            "setup_s": setup_s,
            "spec_decode": stats["spec_decode"],
            "decode_tokens_per_host_sync": stats["decode_tokens_per_host_sync"],
            "kv_economy": sched.stats()["kv_economy"],
            "spilled_blocks": spilled, "page_accounting_after_spill": after_spill,
            "admission": admission,
            "step_clock": {"peak_tflops": engine.generator.step_clock.peak_tflops,
                           "flops_per_token": engine.generator.step_clock.flops_per_token,
                           "summary": summary},
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "held_calls": held, "held_hit_calls": held_hit,
            # the replica's load report as the router reads it
            "healthz_load": healthz(server.bound_port)["load"],
        }
        print(json.dumps({"serve": serve}), flush=True)
        results["serve"] = serve
        return launches
    finally:
        http.stop()
        engine.close()


def deadline_and_overload(engine, sched) -> dict:
    """The deadline policy and the overload ladder on the full-width
    engine, through ``engine.submit`` (HTTP carries no deadline): a
    request whose budget fits fewer tokens than it asks finishes
    "deadline"; one whose deadline has passed fails with
    ``DeadlineExceeded``; with an ``OverloadPolicy`` and a queue limit on
    the scheduler and the generator (as the reference's pipeline wires
    them), a burst over the limit sheds and every request settles."""
    from operator_tpu_torch.router.value import OverloadPolicy, ValueModel
    from operator_tpu_torch.serving.types import DeadlineExceeded, SamplingParams, ShedLowValue

    g = engine.generator
    per_token = g.decode_token_estimate_s()
    if per_token <= 0:
        raise fail("no measured decode step time after the drives")
    clamped = engine.submit(LOG_LINE, SamplingParams(
        max_tokens=MAX_TOKENS, temperature=0.0, stop_on_eos=False,
        deadline=g._clock() + 6.5 * per_token,
    )).result(timeout=300)
    if clamped.finish_reason != "deadline" or not 1 <= clamped.completion_tokens < MAX_TOKENS:
        raise fail(f"a deadline fitting ~6 tokens gave {clamped.completion_tokens} tokens, "
                   f"finish {clamped.finish_reason!r}")
    try:
        engine.submit(LOG_LINE, SamplingParams(max_tokens=8, deadline=g._clock() - 1.0))
    except DeadlineExceeded:
        pass
    else:
        raise fail("an expired deadline was accepted")
    policy = OverloadPolicy(
        ValueModel({"interactive": 2.0, "standard": 30.0, "batch": 120.0}),
        shed_pressure=8.0, metrics=g.metrics,
    )
    sched.queue_limit, sched.overload_policy, g.overload_policy = 4, policy, policy
    counter = g.metrics.counter
    before = {name: counter(name) for name in ("sched_queue_evicted", "admission_shed")}
    classes = ["batch", "standard", "interactive", None]
    try:
        futures = [
            engine.submit(f"{LOG_LINE[:60]} burst {i}", SamplingParams(
                max_tokens=8, temperature=0.0, slo_class=classes[i % 4],
            ))
            for i in range(24)
        ]
        settled = {"ok": 0, "shed": 0, "degraded": 0}
        for future in futures:
            try:
                result = future.result(timeout=300)
            except ShedLowValue:
                settled["shed"] += 1
            else:
                settled["degraded" if result.finish_reason == "degraded" else "ok"] += 1
    finally:
        sched.queue_limit, sched.overload_policy, g.overload_policy = 0, None, None
    wait_idle(sched)
    sheds = {name: counter(name) - before[name] for name in before}
    if settled["shed"] == 0 or sum(sheds.values()) != settled["shed"]:
        raise fail(f"the burst over the queue limit: {settled}, counted sheds {sheds}")
    balanced(sched, "after the overload burst")
    out = {
        "decode_token_estimate_ms": per_token * 1e3,
        "deadline_tokens": clamped.completion_tokens,
        "burst": settled, "sheds": sheds, "decisions": len(policy.log.lines()),
    }
    print(json.dumps({"admission": out}), flush=True)
    return out


POOL_ENV = {**SERVE_ENV, "KV_HOST_POOL_MB": "256", "KV_PAGES": "49"}


def phase_serve_pool(results: dict, kernel_modules: dict) -> None:
    """The prefix cache's host-RAM tier at full width: a second engine
    with a 256 MB pinned pool and 48 KV pages.  The cold drive caches the
    ten prompts' block chain; a pressure drive of the same ten bodies with
    their first byte changed (a chain of its own) must evict those blocks
    at admission while steps are in flight, so their pages are gathered,
    copied to the pool on the side stream and put into it in commit
    windows; ``spill_cache()`` and one short request move the rest; the
    warm drive restores the first chain from the pool.  Fails unless
    blocks were offloaded in flight and restored, the pages balance, a
    restored page holds exactly the bytes gathered at its eviction, and
    no commit window's drain waited as long as half a step (a copy queued
    behind the in-flight step would)."""
    import torch

    from operator_tpu_torch.ops import kv_transfer
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine

    engine, model_id = build_serving_engine("cuda", POOL_ENV, seed=0)
    sched, g = engine.scheduler, engine.generator
    config = g.config
    pool = sched._kvstore.host_pool
    if pool is None or pool.capacity_bytes != 256 << 20:
        raise fail("KV_HOST_POOL_MB=256 did not give the store a 256 MB pool")
    drains: list = []  # (host ms waiting + putting, [gather->copy-done device ms], pages)
    restores: list = []  # (start, end) events around each restored page
    checked: dict = {}  # the block whose bytes are held: hash, gathered, equal
    fetch_host_ms: list = []  # host time of each fetch_page call (pinning included)
    original_drain, original_restore = sched._drain_offload, kv_transfer.restore_page
    original_fetch = kv_transfer.fetch_page
    original_evict, original_restore_block = sched._evict_blocks, sched._restore_block

    def timed_drain() -> None:
        fetches = [f for _, _, _, f in sched._pending_offload]
        t0 = time.perf_counter()
        original_drain()
        host_ms = (time.perf_counter() - t0) * 1e3
        drains.append((host_ms, [f.ready.elapsed_time(f.done) for f in fetches], len(fetches)))

    def timed_restore(paged, page, k, v):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original_restore(paged, page, k, v)
        end.record()
        restores.append((start, end))
        return out

    def timed_fetch(k_dev, v_dev):
        t0 = time.perf_counter()
        out = original_fetch(k_dev, v_dev)
        fetch_host_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def kept_evict(count: int) -> None:
        before = len(sched._pending_offload)
        original_evict(count)
        if "hash" not in checked and len(sched._pending_offload) > before:
            h, k_dev, v_dev, _ = sched._pending_offload[before]
            checked.update(hash=h, gathered=(k_dev.clone(), v_dev.clone()))

    def held_restore_block(blk) -> None:
        original_restore_block(blk)
        if blk.hash == checked.get("hash") and "equal" not in checked:
            checked["equal"] = (
                torch.equal(g.paged_cache.k_pages[:, blk.page], checked["gathered"][0])
                and torch.equal(g.paged_cache.v_pages[:, blk.page], checked["gathered"][1])
            )

    sched._drain_offload, sched._evict_blocks = timed_drain, kept_evict
    sched._restore_block = held_restore_block
    kv_transfer.restore_page, kv_transfer.fetch_page = timed_restore, timed_fetch
    engine.warmup()
    server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
    http = HttpLoop(server)
    url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
    try:
        _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
        cold = timed_drive(url, sched, config, kernel_modules, "pool cold")
        shifted = [{**body, "prompt": "#" + body["prompt"][1:]} for body in request_bodies()]
        pressure = timed_drive(url, sched, config, kernel_modules, "pool pressure", shifted)
        in_flight = list(drains)
        if not in_flight or pressure["kv_economy"]["offload"] == 0:
            raise fail(f"the pressure drive evicted nothing to the pool: {pressure['kv_economy']}")
        spilled = sched.spill_cache()
        _post(url, {"prompt": "drain the offloads", "max_tokens": 2, "temperature": 0.0})
        if not pool.has(checked["hash"]):
            raise fail("the checked block did not reach the host pool")
        restores.clear()
        warm = timed_drive(url, sched, config, kernel_modules, "pool warm")
        if warm["kv_economy"]["restore"] == 0 or "equal" not in checked:
            raise fail(f"the warm drive restored nothing from the pool: {warm['kv_economy']}")
        if not checked["equal"]:
            raise fail("a restored page's bytes differ from the bytes gathered at its eviction")
        step_ms = sorted(sched.device_ms)[len(sched.device_ms) // 2]
        waited = max(ms for ms, _, _ in in_flight)
        spans = [span for _, ss, _ in in_flight for span in ss]
        record = {
            "pool_mb": 256, "kv_pages": g.allocator.num_pages, "spilled_blocks": spilled,
            "cold": cold, "pressure": pressure, "warm": warm,
            "kv_economy": sched.stats()["kv_economy"],
            "pool_blocks": len(pool), "pool_bytes": pool.bytes_used,
            "drains_in_flight": len(in_flight),
            "drain_host_ms_in_flight": [ms for ms, _, _ in in_flight],
            "drain_pages_in_flight": [n for _, _, n in in_flight],
            "drain_host_ms_max": waited,
            "copy_span_ms_in_flight": [min(spans), max(spans)] if spans else None,
            "fetch_host_ms": [min(fetch_host_ms), max(fetch_host_ms), sum(fetch_host_ms)],
            "step_stream_ms_median": step_ms,
            "drain_waited_behind_a_step": waited >= step_ms / 2,
            "restore_ms_per_page": [s.elapsed_time(e) for s, e in restores],
            "restored_bytes_equal": checked["equal"],
        }
        print(json.dumps({"serve_pool": record}), flush=True)
        if record["drain_waited_behind_a_step"]:
            raise fail(f"a commit window's drain waited {waited} ms, a step is {step_ms} ms")
        results["serve_pool"] = record
    finally:
        http.stop()
        engine.close()
        sched._drain_offload, sched._evict_blocks = original_drain, original_evict
        sched._restore_block = original_restore_block
        kv_transfer.restore_page, kv_transfer.fetch_page = original_restore, original_fetch


WAVE_ENV = {
    **{k: v for k, v in SERVE_ENV.items() if not k.startswith(("SCHED_", "SPEC_"))},
    "SCHED_MODE": "wave",
    "DECODE_BLOCK": "4",
    "PIPELINE_DEPTH": "2",
}


def phase_wave(results: dict, kernel_modules: dict, phases: set, selector: str) -> dict:
    """The wave path at full width through the HTTP server: flash prefill
    on, the decode-kernel selector at ``selector``, a new engine.  Returns
    the kernels' launch counts over this drive."""
    import torch

    from operator_tpu_torch.ops import flash_prefill as fp
    from operator_tpu_torch.ops import paged_attention as pa
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine

    saved = {k: os.environ.get(k) for k in ("OPERATOR_TPU_FLASH_PREFILL", "OPERATOR_TPU_PAGED_KERNEL")}
    os.environ["OPERATOR_TPU_FLASH_PREFILL"] = "1"
    os.environ["OPERATOR_TPU_PAGED_KERNEL"] = selector
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, model_id = build_serving_engine(
        "cuda", {**WAVE_ENV, "OPERATOR_TPU_PAGED_KERNEL": selector}, seed=0
    )
    g = engine.generator
    config = g.config
    try:
        if (config.num_layers, config.hidden_size, config.num_heads) != (22, 2048, 32):
            raise fail(f"not tinyllama-1.1b at full width: {config}")
        if engine.scheduler is not None or (g.decode_block, g.pipeline_depth) != (4, 2):
            raise fail("SCHED_MODE=wave did not build the wave engine (block 4, depth 2)")
        engine.warmup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
        http = HttpLoop(server)
        url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
        try:
            _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
            bodies = request_bodies()
            for module in kernel_modules.values():
                module.launches = 0
            waves0, blocks0, ms0 = g.prefill_waves, g.blocks_dispatched, len(g.block_ms)
            completion, wall = drive_requests(url, bodies)
            launches = {name: m.launches for name, m in kernel_modules.items()}
            waves = g.prefill_waves - waves0
            blocks = g.blocks_dispatched - blocks0
            deadline = time.time() + 30
            while (g.num_active or g._inflight_blocks) and time.time() < deadline:
                time.sleep(0.05)
            block_ms = g.block_ms[ms0:]
            free_pages = g.allocator.available
            if free_pages != g.allocator.num_pages - 1 or len(g.free_slots()) != g.max_slots:
                raise fail(
                    f"pages or slots held after the drive: {free_pages} of "
                    f"{g.allocator.num_pages - 1} pages free, "
                    f"{len(g.free_slots())} of {g.max_slots} slots"
                )
            layers = config.num_layers
            want = {
                "flash_prefill_attention": layers * waves,
                "paged_decode_attention": layers * g.decode_block * blocks,
                "ragged_paged_attention": 0,
                "best_window_similarity": 0,
            }
            if waves == 0 or blocks == 0 or launches != want:
                raise fail(
                    f"wave launches {launches} over {waves} prefill waves and "
                    f"{blocks} decode blocks; want {want}"
                )
            if "profile" in phases and selector == "v1":
                results["wave_profile"] = profile_drive(url, bodies)
            held = held_drive_calls(url, fp, "flash_prefill_attention", HeldToPlain(
                fp.flash_prefill_attention, fp.flash_prefill_reference, layers,
                prefill_drive_limit,
            ), LOG_LINE * 3)
            # a prompt over two splits long, held on its first decode step
            # (the first call whose longest row reaches past the prompt)
            prompt = LOG_LINE * 5
            prompt_tokens = len(prompt.encode()) + 1
            held_decode = held_drive_calls(url, pa, "paged_attention", HeldToPlain(
                pa.paged_attention, pa.paged_attention_reference, layers,
                lambda dtype, _: WAVE_TOL[dtype],
                select=lambda q, k, v, table, lengths: lengths.max().item() > prompt_tokens,
                note=k2_split_note,
            ), prompt)
            if held_decode["splits_with_keys"] < 3:
                raise fail(f"the held K2/K3 step's long row had keys in "
                           f"{held_decode['splits_with_keys']} splits, want >= 3")
            load = healthz(server.bound_port)["load"]
        finally:
            http.stop()
        wave = {
            "model": model_id, "layers": layers, "weights": "int8",
            "slots": g.max_slots, "decode_block": g.decode_block,
            "pipeline_depth": g.pipeline_depth, "flash_prefill": True,
            "paged_kernel": selector, "requests": len(bodies),
            "prompt_chars": PROMPT_CHARS, "max_tokens": MAX_TOKENS,
            "completion_tokens": completion, "wall_s": wall,
            "tokens_per_s": completion / wall, "prefill_waves": waves,
            "decode_blocks": blocks,
            "stream_ms_per_block": sum(block_ms) / len(block_ms) if block_ms else None,
            "launches": launches, "setup_s": setup_s,
            "pages_free": free_pages, "held_calls": held, "held_decode_calls": held_decode,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "healthz_load": load,
        }
        print(json.dumps({"wave": wave}), flush=True)
        results["wave" if selector == "v1" else f"wave_{selector}"] = wave
        return launches
    finally:
        engine.close()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def profile_drive(url: str, bodies: list) -> dict:
    """Drive the same requests again under ``torch.profiler`` (see
    :func:`profile_call`)."""
    def drive() -> None:
        threads = [threading.Thread(target=_post, args=(url, body)) for body in bodies]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(900)

    return profile_call(drive)


def device_times(events) -> list:
    """(name, device ms, count) of the profiler's device-side events
    (kernels, copies, memsets), largest first.  A host-side operator
    (``aten::mm``) also carries the device time of the kernels it
    launched, so only device-side events are counted: summing both
    would count each kernel twice."""
    from torch.autograd import DeviceType

    def device_us(event) -> float:
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, name):
                return float(getattr(event, name))
        return 0.0

    rows = [(e.key, device_us(e) / 1e3, e.count) for e in events
            if e.device_type != DeviceType.CPU and device_us(e) > 0]
    return sorted(rows, key=lambda item: -item[1])


def profile_call(drive) -> dict:
    """Run ``drive()`` under ``torch.profiler``: device time by kernel,
    the device's busy share of the wall, and the host time of the
    heaviest operators.  Opt-in (``--phases ...,profile``): tracing slows
    the host, so no other number is taken in this drive."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - started) * 1e3

    events = prof.key_averages()
    kernels = device_times(events)
    device_ms = sum(ms for _, ms, _ in kernels)
    host = sorted(
        ((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events),
        key=lambda item: -item[1],
    )
    out = {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "top_device": [{"name": k[:90], "ms": ms, "count": n} for k, ms, n in kernels[:15]],
        "top_host": [{"name": k[:90], "ms": ms, "count": n} for k, ms, n in host[:12]],
    }
    print(json.dumps({"profile": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5: the semantic analysis path (MiniLM encoder + K5)
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
#: the long drive's log: enough lines for max_windows = 4,096 windows of 16
#: lines at stride 8 (32,776 lines), with the OOM signature at the tail
LONG_LOG_LINES = 33_000
RECALL_INCIDENTS = 2048
RECALL_QUERIES = [
    "java.lang.OutOfMemoryError: Java heap space",
    "Back-off restarting failed container app in pod web-7d9f8c",
    "dial tcp 10.0.0.12:5432: connect: connection refused",
    "x509: certificate has expired or is not yet valid",
]


def fixture_lines(name: str) -> list:
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        return fh.read().splitlines()


def crash_loop_log() -> str:
    """Every fixture log's lines, repeated, then ``oom_java.log`` whole."""
    body = [line for name in sorted(os.listdir(FIXTURES)) if name.endswith(".log")
            for line in fixture_lines(name)]
    tail = fixture_lines("oom_java.log")
    lines = [body[i % len(body)] for i in range(LONG_LOG_LINES - len(tail))] + tail
    return "\n".join(lines)


def byte_ids(text: str) -> list:
    """Token ids of the drives: the text's bytes (the real WordPiece
    tokenizer comes with the checkpoint loader)."""
    return list(text.encode())


class StreamSpans:
    """Records the stream span (CUDA events) of each call of ``fn``, and
    the call's arguments and result."""

    def __init__(self, fn):
        self.fn = fn
        self.calls: list = []

    def __call__(self, *args):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args)
        end.record()
        self.calls.append((start, end, args, out))
        return out

    def spans_ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end, _, _ in self.calls]


class TimedEmbedder:
    """An embedder that records the stream span of each ``embed``."""

    def __init__(self, inner):
        self.inner = inner
        self.dim = inner.dim
        self.embed = StreamSpans(inner.embed)


def phase_analysis(results: dict, kernel_modules: dict, phases: set) -> dict:
    """``PatternEngine.analyze`` with the MiniLM encoder and K5 on the card
    (a long and a short log), then ``IncidentIndex.query``.  Returns the
    kernels' launch counts summed over the drives.  With ``profile`` in
    ``phases``, the long drive runs again under ``torch.profiler``."""
    import numpy as np
    import torch

    from operator_tpu_torch.memory import Incident, IncidentIndex
    from operator_tpu_torch.memory import index as index_module
    from operator_tpu_torch.models.encoder import MINILM_L6, init_encoder_params
    from operator_tpu_torch.patterns import semantic as semantic_module
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, SemanticMatcher
    from operator_tpu_torch.schema.analysis import PodFailureData

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_encoder_params(MINILM_L6, torch.Generator(device="cuda").manual_seed(0),
                                 torch.float32, device="cuda")
    embedder = NeuralEmbedder(params, MINILM_L6, byte_ids, device="cuda")
    if (embedder.max_tokens, embedder.batch_size, embedder.dim) != (256, 32, 384):
        raise fail("not MiniLM-L6 at full width with buckets of 32 x 256")
    matcher = SemanticMatcher(embedder, device="cuda")
    engine = PatternEngine(semantic=matcher)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timed = TimedEmbedder(embedder)
    matcher.embedder = timed
    k5 = StreamSpans(semantic_module.best_window_scores)
    semantic_module.best_window_scores = k5
    index_module.best_window_scores = k5
    total = {name: 0 for name in kernel_modules}
    out: dict = {"model": MINILM_L6.name, "weights": "float32", "setup_s": setup_s,
                 "patterns": matcher.num_patterns}

    def counted(drive):
        for module in kernel_modules.values():
            module.launches = 0
        result = drive()
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for name, n in launches.items():
            total[name] += n
        return result, launches

    try:
        engine.analyze(PodFailureData(logs="\n".join(fixture_lines("oom_java.log"))))  # warm up
        for drive_name, logs in (("long", crash_loop_log()), ("short", "\n".join(
                fixture_lines("oom_java.log")))):
            embeds0, k50 = len(timed.embed.calls), len(k5.calls)
            started = time.perf_counter()
            result, launches = counted(lambda: engine.analyze(PodFailureData(logs=logs)))
            wall_ms = (time.perf_counter() - started) * 1e3
            lines = len(logs.splitlines())
            windows = min(matcher.max_windows, max(1, -(-(lines - matcher.window_lines) // matcher.stride) + 1))
            want = {name: 0 for name in kernel_modules}
            want["best_window_similarity"] = 1
            if launches != want:
                raise fail(f"analysis {drive_name}: launches {launches}, want {want}")
            [(_, _, (w_emb, p_emb), (scores, idx))] = k5.calls[k50:]
            err = check_similarity(w_emb, p_emb, scores, idx)
            events = [(e.source, e.matched_pattern.id, e.score) for e in result.events]
            ids = {pid for _, pid, _ in events}
            sane = all(np.isfinite(score) and (src != "semantic" or abs(score) <= 1.0 + SIM_TOL)
                       for src, _, score in events)
            if w_emb.shape != (windows, 384) or not err <= SIM_TOL or not sane:
                raise fail(f"analysis {drive_name}: windows {tuple(w_emb.shape)} (want {windows}), "
                           f"K5 error {err}, events {events}")
            if "java-heap-oom" not in ids:  # the OOM signature at the tail
                raise fail(f"analysis {drive_name}: the tail's OOM was not found: {events}")
            embed_spans = timed.embed.spans_ms()[embeds0:]
            record = {
                "log_lines": lines, "windows": windows, "buckets": -(-windows // 32),
                "wall_ms": wall_ms, "encoder_stream_ms": sum(embed_spans),
                "k5_stream_ms": k5.spans_ms()[k50], "k5_max_abs_err": err,
                "launches": launches, "events": len(events),
                "semantic_events": sum(1 for src, _, _ in events if src == "semantic"),
                "top_events": events[:5],
            }
            print(json.dumps({"analysis": {drive_name: record}}), flush=True)
            out[drive_name] = record
            if "profile" in phases and drive_name == "long":
                out["profile"] = profile_call(
                    lambda: engine.analyze(PodFailureData(logs=logs)))

        # incident recall: 2,048 incidents built from fixture lines
        lines = [line for name in sorted(os.listdir(FIXTURES)) if name.endswith(".log")
                 for line in fixture_lines(name)]
        incidents = [
            Incident(fingerprint=f"incident-{i:04d}", template=f"{lines[i % len(lines)]} #{i}",
                     pattern_ids=[f"p{i % 19}"], exit_code=i % 256)
            for i in range(RECALL_INCIDENTS)
        ]
        index = IncidentIndex(embedder, device="cuda")
        started = time.perf_counter()
        index.rebuild(incidents)
        torch.cuda.synchronize()
        rebuild_ms = (time.perf_counter() - started) * 1e3
        queries = RECALL_QUERIES + [IncidentIndex._incident_text(incidents[7])]
        k50 = len(k5.calls)
        started = time.perf_counter()
        answers, launches = counted(lambda: [index.query(text, k=3) for text in queries])
        query_ms = (time.perf_counter() - started) * 1e3 / len(queries)
        want = {name: 0 for name in kernel_modules}
        want["best_window_similarity"] = len(queries)
        if launches != want or any(len(a) != 3 for a in answers):
            raise fail(f"recall: launches {launches} (want {want}), answers {answers}")
        worst = max(check_similarity(*args, *res) for _, _, args, res in k5.calls[k50:])
        if not worst <= SIM_TOL or not answers[-1][0][1] >= 1.0 - SIM_TOL:
            raise fail(f"recall: K5 error {worst}, self-query {answers[-1]}")
        recall = {
            "incidents": RECALL_INCIDENTS, "queries": len(queries),
            "rebuild_ms": rebuild_ms, "query_wall_ms": query_ms,
            "k5_stream_ms": k5.spans_ms()[k50:], "k5_max_abs_err": worst,
            "launches": launches, "self_query_top": answers[-1][0],
        }
        print(json.dumps({"analysis": {"recall": recall}}), flush=True)
        out["recall"] = recall
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        results["analysis"] = out
        return total
    finally:
        semantic_module.best_window_scores = k5.fn
        index_module.best_window_scores = k5.fn


# ---------------------------------------------------------------------------
# phase 6: serve a checkpoint from disk (loader, tokenizers, provider)
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the committed SentencePiece-style tokenizer (1,405 ids) the LLM
#: checkpoint is written with
TOKENIZER_FIXTURE = os.path.join(ROOT, "tests", "torch_tokenizers", "llama_sp")
#: the provider drive: one request per fixture log, half greedy
CHECKPOINT_REQUESTS = 10
CHECKPOINT_ENV = {k: v for k, v in SERVE_ENV.items() if k != "ALLOW_RANDOM_WEIGHTS"}
#: all-MiniLM-L6-v2's HF config, the fields the loader reads
MINILM_CONFIG_JSON = {
    "model_type": "bert", "vocab_size": 30522, "hidden_size": 384,
    "intermediate_size": 1536, "num_hidden_layers": 6, "num_attention_heads": 12,
    "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
}


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def trees_equal(a, b) -> bool:
    """Byte-for-byte equality of two param trees."""
    import torch

    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(trees_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def provider_requests() -> list:
    """One ``AnalysisRequest`` per fixture log (the first ten by name):
    the regex analysis, the pod and its logs; even ones greedy."""
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.schema.analysis import (
        AIProviderConfig,
        AnalysisRequest,
        PodFailureData,
    )

    engine = PatternEngine()
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))[:CHECKPOINT_REQUESTS]
    requests = []
    for i, name in enumerate(names):
        failure = PodFailureData.parse({
            "logs": "\n".join(fixture_lines(name)),
            "pod": {"metadata": {"name": name[:-4].replace("_", "-"), "namespace": "prod"}},
        })
        requests.append(AnalysisRequest(
            analysis_result=engine.analyze(failure), failure_data=failure,
            provider_config=AIProviderConfig(
                provider_id="tpu-native", max_tokens=MAX_TOKENS,
                temperature=0.0 if i % 2 == 0 else 0.7),
        ))
    return requests


def wordpiece_vocab(size: int = 30522) -> list:
    """A MiniLM-sized ``vocab.txt``, built deterministically from the
    fixture logs and the built-in patterns' embedding texts: the specials,
    every character, its ``##`` piece, the words by frequency (ties by
    spelling), then ``[unusedN]`` filler."""
    from operator_tpu_torch.patterns.loader import load_builtin_library
    from operator_tpu_torch.patterns.semantic import embedding_text

    texts = [line for name in sorted(os.listdir(FIXTURES)) if name.endswith(".log")
             for line in fixture_lines(name)]
    texts += [embedding_text(p) for p in load_builtin_library().patterns]
    lowered = [t.lower() for t in texts]
    chars = sorted({c for t in lowered for c in t if not c.isspace()})
    counts: dict = {}
    for text in lowered:
        for word in re.findall(r"[a-z0-9]+", text):
            counts[word] = counts.get(word, 0) + 1
    words = sorted(counts, key=lambda w: (-counts[w], w))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars + ["##" + c for c in chars]
    vocab = list(dict.fromkeys(vocab + words))
    return vocab + [f"[unused{i}]" for i in range(size - len(vocab))]


def gated_drive(provider, requests: list) -> list:
    """Every request through ``provider.generate`` at once, the engine's
    admission held until all are queued, so two engines driven this way
    take the same steps (a prefill chunk's split over K1's tiles, and so
    its rounding, follows the step's mix)."""
    import asyncio

    engine = provider.engine
    gate = threading.Lock()
    admit = engine._admit_submissions

    def gated(block: bool) -> None:
        with gate:
            admit(block)

    async def drive():
        with gate:
            # the worker's idle wait for a submission (50 ms) runs out, so
            # it reads the gated admission before the first one arrives
            # (else it takes the first requests ungated, and the rest wait
            # on a gate that waits for them)
            await asyncio.sleep(0.2)
            base = engine._submissions.qsize()
            tasks = [asyncio.ensure_future(provider.generate(r)) for r in requests]
            by = time.monotonic() + 120
            while (engine._submissions.qsize() < base + len(requests)
                   and not any(t.done() for t in tasks)):
                if time.monotonic() > by:
                    raise fail(f"gated drive: {engine._submissions.qsize() - base} of "
                               f"{len(requests)} requests queued in 120 s")
                await asyncio.sleep(0)
        return await asyncio.gather(*tasks)

    engine._admit_submissions = gated
    try:
        return asyncio.run(drive())
    finally:
        engine._admit_submissions = admit


def write_encoder_checkpoint(params, path: str) -> None:
    """The encoder tree under HF BERT names (projections back to
    ``[out, in]``), one f32 ``model.safetensors``, with ``config.json``,
    ``vocab.txt`` and a lower-casing ``tokenizer_config.json``."""
    from operator_tpu_torch.models import encoder
    from operator_tpu_torch.models.loader import write_safetensors

    tensors = {hf: params[ours].cpu() for hf, ours in encoder._BERT_TOP_MAP.items()}
    for sub, (ours, transpose) in encoder._BERT_LAYER_MAP.items():
        stacked = params["layers"][ours]
        stacked = (stacked.transpose(-1, -2) if transpose else stacked).contiguous().cpu()
        for i in range(stacked.shape[0]):
            tensors[f"encoder.layer.{i}.{sub}"] = stacked[i]
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(MINILM_CONFIG_JSON, fh)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(wordpiece_vocab()) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as fh:
        json.dump({"do_lower_case": True, "tokenizer_class": "BertTokenizer"}, fh)


def phase_checkpoint(results: dict, kernel_modules: dict, keep: bool = False) -> tuple:
    """A tinyllama-1.1b checkpoint written at full width from the serve
    phase's seeded weights, loaded back with int8 weights through
    ``build_tpu_native_provider`` and driven with ten analysis requests;
    then a MiniLM-width encoder checkpoint through ``build_embedder`` and
    ``PatternEngine.analyze``.  Returns the kernels' launch counts summed
    over the provider drive and the long analysis, and the checkpoints'
    directories (``workdir``, ``llm``, ``encoder``); with ``keep`` the
    caller deletes ``workdir``, else it is gone already."""
    import asyncio
    import tempfile

    import torch

    from operator_tpu_torch.models.configs import get_config
    from operator_tpu_torch.models.encoder import MINILM_L6, init_encoder_params
    from operator_tpu_torch.models.llama import init_params
    from operator_tpu_torch.models.loader import save_params
    from operator_tpu_torch.models.quant import quantize_params
    from operator_tpu_torch.models.tokenizer import HFTokenizer
    from operator_tpu_torch.models.wordpiece import WordPieceTokenizer
    from operator_tpu_torch.ops import ragged_attention as ra
    from operator_tpu_torch.patterns import semantic as semantic_module
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, SemanticMatcher, build_embedder
    from operator_tpu_torch.schema.analysis import PodFailureData
    from operator_tpu_torch.serving import provider as provider_module
    from operator_tpu_torch.serving.sched import mixed as mixed_module

    config = get_config(SERVE_ENV["OPERATOR_TPU_MODEL"])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="checkpoint-", dir=os.path.join(ROOT, "build"))
    total = {name: 0 for name in kernel_modules}
    out: dict = {"card": card_line(), "model": config.name, "layers": config.num_layers}

    def counted(drive):
        for module in kernel_modules.values():
            module.launches = 0
        result = drive()
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for name, n in launches.items():
            total[name] += n
        return result, launches

    try:
        # 1. the LLM checkpoint: the serve phase's seeded tree, in bf16
        ckpt = os.path.join(workdir, "tinyllama")
        seeded = init_params(config, torch.Generator(device="cuda").manual_seed(0),
                             torch.bfloat16, device="cuda")
        if (config.num_layers, config.hidden_size, config.num_heads, config.num_kv_heads,
                config.vocab_size) != (22, 2048, 32, 4, 32000):
            raise fail(f"not tinyllama-1.1b at full width: {config}")
        torch.cuda.synchronize()
        started = time.perf_counter()
        files = save_params(seeded, ckpt, config, shard_bytes=1 << 30)
        write_s = time.perf_counter() - started
        for name in ("tokenizer.json", "tokenizer_config.json"):
            shutil.copy(os.path.join(TOKENIZER_FIXTURE, name), os.path.join(ckpt, name))
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
        want = quantize_params(seeded, config)
        del seeded
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        # 2. load and serve: the weight stream's handle is kept for its time
        handles = []
        stream = provider_module.load_params_async

        def recorded(*args, **kwargs):
            handles.append(stream(*args, **kwargs))
            return handles[-1]

        provider_module.load_params_async = recorded
        torch.cuda.reset_peak_memory_stats()
        memory0 = torch.cuda.memory_allocated()
        started = time.perf_counter()
        try:
            provider = provider_module.build_tpu_native_provider(
                "cuda", {**CHECKPOINT_ENV, "CHECKPOINT_DIR": ckpt})
        finally:
            provider_module.load_params_async = stream
        torch.cuda.synchronize()
        build_s = time.perf_counter() - started
        load_s = handles[0].seconds
        engine = provider.engine
        g = engine.generator
        out["checkpoint"] = {
            "files": len(files), "bytes": ckpt_bytes, "write_s": write_s,
            "write_gb_per_s": ckpt_bytes / write_s / 1e9, "load_s": load_s,
            "load_gb_per_s": ckpt_bytes / load_s / 1e9, "provider_build_s": build_s,
            "weights_gib": tree_bytes(g.params) / 2**30,
            "memory_after_load_gib": (torch.cuda.memory_allocated() - memory0) / 2**30,
            "peak_memory_during_load_gib": (torch.cuda.max_memory_allocated() - memory0) / 2**30,
        }
        print(json.dumps({"checkpoint": out["checkpoint"], "card": out["card"]}), flush=True)
        if not isinstance(g.tokenizer, HFTokenizer):
            raise fail(f"the checkpoint's tokenizer fell back to {type(g.tokenizer).__name__}")
        if not trees_equal(g.params, want):
            raise fail("the loaded int8 tree is not the seeded tree's quantize_params, byte for byte")
        del want

        # 3. the provider drive: ten requests at once, K1 counted
        sched = engine.scheduler
        requests = provider_requests()
        engine.warmup()
        asyncio.run(provider.generate(requests[0]))  # not a cold start
        steps0, dev0 = sched.steps, len(sched.device_ms)
        started = time.perf_counter()
        responses, launches = counted(lambda: gated_drive(provider, requests))
        wall = time.perf_counter() - started
        steps = sched.steps - steps0
        wait_idle(sched)
        stream_ms = sched.device_ms[dev0:]
        accounting = balanced(sched, "after the provider drive")
        bad = [r.to_dict() for r in responses if r.error or not r.completion_tokens]
        if bad:
            raise fail(f"provider responses without an explanation: {bad}")
        if launches["ragged_paged_attention"] != config.num_layers * steps or steps == 0:
            raise fail(f"provider drive: ragged kernel launched {launches} over {steps} steps")
        if any(n for k, n in launches.items() if k != "ragged_paged_attention"):
            raise fail(f"other kernels launched on the provider drive: {launches}")
        completion = sum(r.completion_tokens for r in responses)
        # K1 held to its plain version on one more request's first 22 calls
        held = HeldToPlain(
            mixed_module.ragged_paged_attention, ra.ragged_attention_reference,
            config.num_layers, lambda dtype, _: TOL[dtype],
            valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
            note=k1_split_note,
        )
        mixed_module.ragged_paged_attention = held
        try:
            asyncio.run(provider.generate(requests[1]))
        finally:
            mixed_module.ragged_paged_attention = held.fn
        bad_held = [c for c in held.held if not c["finite"] or not c["excess"] <= 0]
        if len(held.held) != config.num_layers or bad_held:
            raise fail(f"provider drive: {len(held.held)} K1 calls held, outside tolerance: {bad_held}")
        tokenizer = g.tokenizer
        engine.close()

        # the same drive on an engine built in memory from the same seeded
        # tree (the serve phase's), with the checkpoint's tokenizer: the
        # greedy half must give the same tokens
        reference, model_id = provider_module.build_serving_engine("cuda", SERVE_ENV, seed=0)
        reference.generator.tokenizer = tokenizer
        in_memory = provider_module.TPUNativeProvider(reference, model_id=model_id)
        try:
            reference.warmup()
            asyncio.run(in_memory.generate(requests[0]))
            want_responses = gated_drive(in_memory, requests)
        finally:
            reference.close()
        greedy = [i for i, r in enumerate(requests) if r.provider_config.temperature == 0.0]
        mismatched = [i for i in greedy
                      if responses[i].to_dict() != want_responses[i].to_dict()]
        if mismatched:
            raise fail(f"greedy requests {mismatched} differ from the in-memory engine's: "
                       f"{[responses[i].to_dict() for i in mismatched]} != "
                       f"{[want_responses[i].to_dict() for i in mismatched]}")
        out["provider"] = {
            "requests": len(requests), "greedy": len(greedy), "max_tokens": MAX_TOKENS,
            "prompt_tokens": [r.prompt_tokens for r in responses],
            "completion_tokens": completion, "wall_s": wall, "tokens_per_s": completion / wall,
            "steps": steps, "launches": launches, "page_accounting": accounting,
            "stream_ms_per_step": sum(stream_ms) / len(stream_ms) if stream_ms else None,
            "held_k1_calls": len(held.held),
            "held_k1_max_abs_err": max(c["max_abs_err"] for c in held.held),
            "held_k1_splits_with_keys": max(c["splits_with_keys"] for c in held.held),
            "greedy_equal_in_memory": True,
            "sampled_equal_in_memory": all(
                a.to_dict() == b.to_dict() for a, b in zip(responses, want_responses)),
        }
        print(json.dumps({"checkpoint_provider": out["provider"], "card": out["card"]}), flush=True)
        torch.cuda.empty_cache()

        # 4. the encoder checkpoint at all-MiniLM-L6-v2's width
        enc_dir = os.path.join(workdir, "minilm")
        enc_params = init_encoder_params(MINILM_L6, torch.Generator(device="cuda").manual_seed(0),
                                         torch.float32, device="cuda")
        write_encoder_checkpoint(enc_params, enc_dir)
        started = time.perf_counter()
        loaded = build_embedder(enc_dir, device="cuda")
        torch.cuda.synchronize()
        embedder_build_s = time.perf_counter() - started
        if not isinstance(loaded, NeuralEmbedder):
            raise fail(f"build_embedder fell back to {type(loaded).__name__}")
        if loaded.dim != 384 or not trees_equal(loaded.params, enc_params):
            raise fail("the loaded encoder is not the seeded MiniLM-width tree")
        wordpiece = WordPieceTokenizer.from_dir(enc_dir)
        in_memory = NeuralEmbedder(enc_params, MINILM_L6, wordpiece.encode, device="cuda")
        logs = crash_loop_log()
        runs = {}
        for name, emb in (("loaded", loaded), ("in_memory", in_memory)):
            matcher = SemanticMatcher(emb, device="cuda")
            engine_ = PatternEngine(semantic=matcher)
            engine_.analyze(PodFailureData(logs="\n".join(fixture_lines("oom_java.log"))))
            timed = TimedEmbedder(emb)
            matcher.embedder = timed
            k5 = StreamSpans(semantic_module.best_window_scores)
            semantic_module.best_window_scores = k5
            try:
                started = time.perf_counter()
                result, launches_a = counted(lambda: engine_.analyze(PodFailureData(logs=logs)))
                wall_ms = (time.perf_counter() - started) * 1e3
            finally:
                semantic_module.best_window_scores = k5.fn
            [(_, _, (w_emb, p_emb), (scores, idx))] = k5.calls
            runs[name] = {
                "events": [(e.source, e.matched_pattern.id, e.context.line_number, e.score)
                           for e in result.events],
                "launches": launches_a, "wall_ms": wall_ms,
                "encoder_stream_ms": sum(timed.embed.spans_ms()),
                "k5_stream_ms": k5.spans_ms()[0],
                "k5_max_abs_err": check_similarity(w_emb, p_emb, scores, idx),
                "windows": int(w_emb.shape[0]),
            }
        want_launch = {name: 0 for name in kernel_modules}
        want_launch["best_window_similarity"] = 1
        got = runs["loaded"]
        if got["launches"] != want_launch or not got["k5_max_abs_err"] <= SIM_TOL:
            raise fail(f"checkpoint analysis: launches {got['launches']}, K5 error {got['k5_max_abs_err']}")
        if got["events"] != runs["in_memory"]["events"]:
            raise fail(f"the loaded encoder's events {got['events']} differ from the "
                       f"in-memory encoder's {runs['in_memory']['events']}")
        # the in-memory run's counts are a comparison, not the path's
        for name, n in runs["in_memory"]["launches"].items():
            total[name] -= n
        out["analysis"] = {
            "embedder_build_s": embedder_build_s, "log_lines": LONG_LOG_LINES,
            "vocab": len(wordpiece.vocab), **{k: v for k, v in got.items() if k != "events"},
            "events": len(got["events"]),
            "semantic_events": sum(1 for src, *_ in got["events"] if src == "semantic"),
            "top_events": got["events"][:5],
            "in_memory_wall_ms": runs["in_memory"]["wall_ms"],
        }
        print(json.dumps({"checkpoint_analysis": out["analysis"], "card": out["card"]}), flush=True)
        results["checkpoint"] = out
        return total, {"workdir": workdir, "llm": ckpt, "encoder": enc_dir}
    except BaseException:
        keep = False
        raise
    finally:
        if not keep:
            shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 7: the operator control plane over the fake apiserver
# ---------------------------------------------------------------------------

#: the operator phase's pods: one per fixture log (the first ten by name),
#: even ones on the greedy AIProvider
OPERATOR_PODS = 10
#: how long the drive may take to queue its ten requests
OPERATOR_QUEUE_S = 120.0
#: the logs the recurrences may repeat, in order: each one's evidence
#: carries numbers the fingerprint keeps (memory figures, addresses,
#: versions), so changing them changes its identity.  The first whose pod
#: stored a generated explanation is taken (random weights can decode to
#: an empty one, which is never reused)
OPERATOR_RECURRENT_LOGS = ("eviction.log", "go_panic.log", "image_pull_backoff.log",
                           "init_container_config.log", "oom_java.log")


def operator_pod(name: str, variant: str, finished_at: str) -> dict:
    """A pod of ``app=payment`` in CrashLoopBackOff after exit code 1."""
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": "prod",
                     "labels": {"app": "payment", "variant": variant}},
        "status": {"phase": "Running", "containerStatuses": [{
            "name": "app", "restartCount": 3,
            "state": {"waiting": {"reason": "CrashLoopBackOff"}},
            "lastState": {"terminated": {"exitCode": 1, "finishedAt": finished_at}},
        }]},
    }


def operator_resources(model_name: str) -> list:
    """Two AIProviders on the one ``tpu-native`` engine, greedy and at the
    default temperature (0.3), and a Podmortem for each selecting
    ``app=payment`` pods of its variant (a Podmortem names one
    AIProvider)."""
    out = []
    for variant, temperature in (("greedy", 0.0), ("sampled", None)):
        spec = {"providerId": "tpu-native", "modelId": model_name, "maxTokens": MAX_TOKENS}
        if temperature is not None:
            spec["temperature"] = temperature
        out.append(("AIProvider", {"metadata": {"name": variant, "namespace": "ops"}, "spec": spec}))
        out.append(("Podmortem", {
            "metadata": {"name": f"watch-payment-{variant}", "namespace": "ops"},
            "spec": {"podSelector": {"matchLabels": {"app": "payment"}, "matchExpressions": [
                         {"key": "variant", "operator": "In", "values": [variant]}]},
                     "aiProviderRef": {"name": variant, "namespace": "ops"},
                     "aiAnalysisEnabled": True}}))
    return out


def phase_operator(results: dict, kernel_modules: dict, dirs: dict) -> dict:
    """The port's ``Operator`` on the card over ``FakeKubeApi``, with the
    checkpoint phase's tinyllama-1.1b checkpoint through ``providerId:
    tpu-native`` and its MiniLM-width encoder as ``ENCODER_CHECKPOINT_DIR``.
    Ten failing pods (the fixture logs; half on the greedy AIProvider;
    admission held until all ten are queued), then the recurrences: an
    earlier pod's log (a recall hit) and changed logs until one is near or
    miss.  Returns the kernels' launch counts over the drive and the
    recurrences."""
    import asyncio

    import torch

    from operator_tpu_torch.operator import FakeKubeApi, Operator
    from operator_tpu_torch.operator.storage import ANNOTATION_ANALYSIS
    from operator_tpu_torch.ops import ragged_attention as ra
    from operator_tpu_torch.patterns import semantic as semantic_module
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder
    from operator_tpu_torch.schema.analysis import PodFailureData
    from operator_tpu_torch.serving import provider as provider_module
    from operator_tpu_torch.serving.sched import mixed as mixed_module
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    env = {**CHECKPOINT_ENV, "MODEL_ID": CHECKPOINT_ENV["OPERATOR_TPU_MODEL"],
           "CHECKPOINT_DIR": dirs["llm"], "ENCODER_CHECKPOINT_DIR": dirs["encoder"],
           "PATTERN_CACHE_DIRECTORY": os.path.join(dirs["workdir"], "no-pattern-cache"),
           "HEALTH_PORT": "0", "HEALTH_HOST": "127.0.0.1"}
    config = OperatorConfig.from_env(env)
    out: dict = {"card": card_line(), "pods": OPERATOR_PODS}
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))[:OPERATOR_PODS]
    pods = [(f"payment-{i}", ("greedy", "sampled")[i % 2], "\n".join(fixture_lines(name)))
            for i, name in enumerate(names)]

    # the operator's default device is cuda: no device argument
    operator = Operator(FakeKubeApi(), config=config, metrics=MetricsRegistry())
    api, semantic, index = operator.api, operator.engine.semantic, operator.memory.index
    if semantic is None or not isinstance(semantic.embedder, NeuralEmbedder):
        raise fail("the operator did not mount the encoder checkpoint")
    provider = operator.providers.resolve("tpu-native")
    engine = provider.engine
    sched, model = engine.scheduler, engine.generator.config
    # what the drives ask of K5: semantic analyses, and recall queries over
    # a non-empty index (each one launch)
    k5_calls = {"analyze": 0, "query": 0}
    match, query, generate = semantic.match, index.query, provider.generate

    def counted_match(lines):
        k5_calls["analyze"] += bool(lines) and semantic.num_patterns > 0
        return match(lines)

    def counted_query(text, k=3):
        k5_calls["query"] += len(index) > 0 and bool(text.strip())
        return query(text, k)

    # the requests the pipeline hands the provider, in call order, and
    # their responses
    exchanged: list = []

    async def captured(request):
        pair = [request, None]
        exchanged.append(pair)
        pair[1] = await generate(request)
        return pair[1]

    gate = threading.Lock()
    admit = engine._admit_submissions

    def gated(block: bool) -> None:
        with gate:
            admit(block)

    # what the drive queued: each prompt's absolute deadline and the
    # engine's clock at its submit (admission is earliest deadline first)
    submitted: dict = {}
    submit = engine.submit

    def recorded(prompt, params=None, **kw):
        submitted[prompt] = (params.deadline if params else None, engine.generator._clock())
        return submit(prompt, params, **kw)

    def counts() -> dict:
        """The counts since the last call; then every count is 0."""
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for module in kernel_modules.values():
            module.launches = 0
        return launches

    async def poke(name: str, variant: str, log: str, finished_at: str) -> int:
        api.set_pod_log("prod", name, log, previous=True)
        await asyncio.wait_for(api.create("Pod", operator_pod(name, variant, finished_at)),
                               timeout=config.kube_call_timeout_s)
        poked = time.monotonic_ns()
        # the watcher reacts to MODIFIED (as run_demo pokes its pod)
        await asyncio.wait_for(
            api.patch("Pod", name, "prod", {"metadata": {"labels": {"poked": "1"}}}),
            timeout=config.kube_call_timeout_s)
        return poked

    async def drive() -> dict:
        for kind, obj in operator_resources(model.name):
            await asyncio.wait_for(api.create(kind, obj), timeout=config.kube_call_timeout_s)
        await operator.start()
        await asyncio.sleep(0.05)  # the watches register, the caches prime
        # not a cold start: the engine's programs and the template's head
        engine.warmup()
        await generate(provider_requests()[0])
        wait_idle(sched)
        poked: dict = {}
        counts()
        steps0, dev0 = sched.steps, len(sched.device_ms)
        # the sampler's state as the drive's first step will find it
        drive_rng.append(engine.generator._rng.get_state())
        engine._admit_submissions, engine.submit = gated, recorded
        gate.acquire()
        try:
            # the worker's idle wait for a submission (50 ms) runs out, so
            # it reads the gated admission before the first one arrives
            await asyncio.sleep(0.2)
            started = time.monotonic_ns()
            for i, (name, variant, log) in enumerate(pods):
                poked[name] = await poke(name, variant, log, f"2026-07-28T09:{i:02d}:00Z")
            queued_by = time.monotonic() + OPERATOR_QUEUE_S
            while engine._submissions.qsize() < OPERATOR_PODS:
                if time.monotonic() > queued_by:
                    handed = [r.failure_data.pod.metadata.name for r, _ in exchanged]
                    events = [(e["regarding"]["name"], e["reason"], e.get("note"))
                              for e in await api.list("Event")]
                    raise fail(f"operator drive: {engine._submissions.qsize()} of "
                               f"{OPERATOR_PODS} requests queued in {OPERATOR_QUEUE_S} s "
                               f"(handed to the provider: {handed}; events {events})")
                await asyncio.sleep(0.001)
        finally:
            gate.release()
        await asyncio.sleep(0.01)
        await operator.watcher.drain()
        wall_s = (time.monotonic_ns() - started) / 1e9
        wait_idle(sched)
        engine._admit_submissions, engine.submit = admit, submit
        steps, launches = sched.steps - steps0, counts()
        stream_ms = sched.device_ms[dev0:]
        # the recurrences, each on its pod's AIProvider: a new pod with a
        # drive pod's log (a hit), then that log with its numbers changed,
        # and the next candidate's, until one changes the fingerprint (the
        # normalised evidence keeps a number only where it is part of a
        # token, and the strongest evidence may carry none)
        stored = {f["podName"]: f for cr in await api.list("Podmortem", "ops")
                  for f in (cr.get("status") or {}).get("recentFailures") or []}
        candidates = [pods[names.index(n)] for n in OPERATOR_RECURRENT_LOGS
                      if stored[pods[names.index(n)][0]]["analysisStatus"] == "Analyzed"]
        if not candidates:
            raise fail(f"operator: no candidate for the recurrences stored an explanation: {stored}")
        recurrence: dict = {}

        async def recur(name: str, variant: str, log: str) -> dict:
            poked[name] = await poke(name, variant, log,
                                     f"2026-07-28T10:{len(recurrence):02d}:00Z")
            await asyncio.sleep(0.05)
            await operator.watcher.drain()
            wait_idle(sched)
            recurrence[name] = counts()
            recurrences.append((name, variant, log))
            failures = {f["podName"]: f for cr in await api.list("Podmortem", "ops")
                        for f in (cr.get("status") or {}).get("recentFailures") or []}
            return failures[name].get("recurrence") or {}

        first, variant, log = candidates[0]
        await recur("payment-hit", variant, log)
        for i, (first, variant, log) in enumerate(candidates):
            changed = re.sub(r"\d+", lambda m: str(int(m.group()) + 7), log)
            got = await recur(f"payment-changed-{i}", variant, changed)
            if got.get("fingerprint") != stored[first]["recurrence"]["fingerprint"]:
                break
        url = f"http://127.0.0.1:{operator.health_server.bound_port}"
        scraped = {path: await asyncio.to_thread(
            lambda p=path: urllib.request.urlopen(url + p, timeout=30).read().decode())
            for path in ("/metrics", "/readyz")}
        pods_now = {p["metadata"]["name"]: p for p in await api.list("Pod", "prod")}
        failures = {f["podName"]: f for cr in await api.list("Podmortem", "ops")
                    for f in (cr.get("status") or {}).get("recentFailures") or []}
        events = await api.list("Event")
        await operator.stop()
        return {"poked": poked, "wall_s": wall_s, "steps": steps, "launches": launches,
                "stream_ms_per_step": sum(stream_ms) / len(stream_ms) if stream_ms else None,
                "recurrence": recurrence, "scraped": scraped, "pods": pods_now,
                "failures": failures, "events": events}

    semantic.match, index.query, provider.generate = counted_match, counted_query, captured
    #: (pod, variant, log) of each recurrence, in poke order
    recurrences: list = []
    drive_rng: list = []
    try:
        run = asyncio.run(drive())
    finally:
        semantic.match, index.query, provider.generate = match, query, generate
        engine._admit_submissions, engine.submit = admit, submit
    analysed = [name for name, _, _ in pods + recurrences]
    failures, pod_events = run["failures"], {}
    for e in run["events"]:
        regarding = e.get("regarding") or {}
        if regarding.get("kind") == "Pod":
            pod_events.setdefault(regarding.get("name"), set()).add(e.get("reason"))
    responses = {r.failure_data.pod.metadata.name: a for r, a in exchanged}
    counters = operator.metrics.snapshot()["counters"]
    reused = {name for name in analysed
              if (failures.get(name, {}).get("recurrence") or {}).get("reusedAnalysis")}
    # the stored status follows the answer: "Analyzed" with a generated
    # explanation or a reused one, "PatternOnly" when the tokens decode to
    # nothing but blanks.  A pod without its own provider call and no
    # reuse was served by the pipeline's response cache (the same evidence
    # lines as an earlier pod's)
    want_status = {name: ("Analyzed" if responses[name].explanation else "PatternOnly")
                   if name in responses else ("Analyzed",) if name in reused
                   else ("Analyzed", "PatternOnly") for name in analysed}
    bad_answers = [(name, a.to_dict()) for name, a in responses.items()
                   if a.error or not a.completion_tokens]
    missing = [name for name in analysed
               if not (run["pods"][name]["metadata"].get("annotations") or {}).get(ANNOTATION_ANALYSIS)
               or failures.get(name, {}).get("analysisStatus") not in want_status[name]
               or pod_events.get(name) != {"PodFailureDetected", "PodmortemAnalysisComplete"}]
    cache_served = [n for n in analysed if n not in responses and n not in reused]
    if (missing or bad_answers or reused & set(responses)
            or len(cache_served) != counters.get("ai_cache_hits", 0)):
        raise fail(f"operator: pods without their annotations, status entry or events: "
                   f"{[(n, failures.get(n), pod_events.get(n)) for n in missing]}; "
                   f"provider answers without tokens: {bad_answers}; reused {reused}, "
                   f"served from the response cache {cache_served}, counters {counters}")
    ledger = operator.pipeline.slo_ledger
    records = ledger.records
    if (len(records) != len(analysed) or len({r.trace_id for r in records}) != len(records)
            or ledger.pending or any(r.outcome != "completed" for r in records)):
        raise fail(f"operator: the SLO ledger {ledger.snapshot()} over {len(analysed)} analyses")
    hit, near = (failures[name].get("recurrence") or {} for name in ("payment-hit", recurrences[-1][0]))
    if (not hit.get("reusedAnalysis") or near.get("reusedAnalysis")
            or near.get("fingerprint") == hit.get("fingerprint")
            or counters.get("recall_hit") != len(reused)):
        raise fail(f"operator: recall hit {hit}, changed logs "
                   f"{[failures[n].get('recurrence') for n, _, _ in recurrences[1:]]}, "
                   f"counters {counters}")
    launches, steps = run["launches"], run["steps"]
    if launches["ragged_paged_attention"] != model.num_layers * steps or steps == 0:
        raise fail(f"operator drive: K1 launched {launches} over {steps} steps")
    if run["recurrence"]["payment-hit"]["ragged_paged_attention"]:
        raise fail(f"operator: the recall hit launched K1: {run['recurrence']}")
    every = [launches, *run["recurrence"].values()]
    k5 = sum(c["best_window_similarity"] for c in every)
    if k5 != k5_calls["analyze"] + k5_calls["query"] or k5_calls["analyze"] != len(analysed):
        raise fail(f"operator: K5 launched {k5} times for {k5_calls}")
    if any(c["paged_decode_attention"] or c["flash_prefill_attention"] for c in every):
        raise fail(f"operator: wave kernels launched: {every}")
    if f"podmortem_recall_hit_total {len(reused)}" not in run["scraped"]["/metrics"]:
        raise fail("operator: /metrics lacks the recall hit")

    # per pod: poke to stored status, and the stage split from its trace
    traces = {r.trace_id: r.trace["spans"] for r in operator.recorder.traces()}
    per_pod: dict = {}
    for record in records:
        spans = traces[record.trace_id]
        root = next(sp for sp in spans if "parentId" not in sp)
        name = root["attributes"]["pod"].split("/")[-1]
        store = next(sp for sp in spans if sp["name"] == "store"
                     and sp.get("parentId") == root["spanId"])
        stages = record.stages
        per_pod[name] = {
            "poke_to_stored_ms": (store["endNs"] - run["poked"][name]) / 1e6,
            "analysis_ms": record.latency_s * 1e3,
            "stages_ms": {"collect": stages.get("collect"), "analyze": stages.get("parse"),
                          "recall": stages.get("recall"), "generate": stages.get("explain"),
                          "store": stages.get("store")},
            "host_outside_engine_ms": record.latency_s * 1e3 - stages.get("explain", 0.0),
        }
    drive_pods = [name for name, _, _ in pods]
    completion = sum(responses[name].completion_tokens for name in drive_pods)
    out.update({
        "steps": steps, "launches": launches, "recurrence_launches": run["recurrence"],
        "k5_calls": k5_calls, "recall": {"hit": hit, "changed_log": near},
        "drive_wall_s": run["wall_s"], "completion_tokens": completion,
        "prompt_tokens": [responses[n].prompt_tokens for n in drive_pods],
        "stream_ms_per_step": run["stream_ms_per_step"],
        "recurrent_log": names[[log for _, _, log in pods].index(recurrences[0][2])],
        "changed_logs": {n: failures[n].get("recurrence") for n, _, _ in recurrences[1:]},
        "served_from_response_cache": cache_served,
        "blank_explanations": sorted(n for n in drive_pods if not responses[n].explanation),
        "tokens_per_s": completion / run["wall_s"],
        "poke_to_stored_ms": {n: per_pod[n]["poke_to_stored_ms"] for n in analysed},
        "stages_ms": {n: per_pod[n]["stages_ms"] for n in analysed},
        "host_outside_engine_ms": {n: per_pod[n]["host_outside_engine_ms"] for n in analysed},
        "recall_hit_wall_ms": per_pod["payment-hit"]["poke_to_stored_ms"],
        "changed_log_wall_ms": per_pod[recurrences[-1][0]]["poke_to_stored_ms"],
        "readyz": run["scraped"]["/readyz"],
    })
    print(json.dumps({"operator": {k: v for k, v in out.items() if k not in (
        "poke_to_stored_ms", "stages_ms", "host_outside_engine_ms")}}), flush=True)
    print(json.dumps({"operator_per_pod": per_pod, "card": out["card"]}), flush=True)

    # one more request's 22 K1 calls and one analyze()'s K5 call, held
    held = HeldToPlain(
        mixed_module.ragged_paged_attention, ra.ragged_attention_reference,
        model.num_layers, lambda dtype, _: TOL[dtype],
        valid=lambda q, *args: torch.arange(q.shape[1], device=q.device)[None] < args[4][:, None],
        note=k1_split_note,
    )
    k5_held = StreamSpans(semantic_module.best_window_scores)
    mixed_module.ragged_paged_attention = held
    semantic_module.best_window_scores = k5_held
    try:
        asyncio.run(generate(exchanged[0][0]))
        operator.engine.analyze(PodFailureData(logs=pods[1][2]))
    finally:
        mixed_module.ragged_paged_attention = held.fn
        semantic_module.best_window_scores = k5_held.fn
    counts()  # the comparisons' launches are not the path's
    bad = [c for c in held.held if not c["finite"] or not c["excess"] <= 0]
    [(_, _, (w_emb, p_emb), (scores, idx))] = k5_held.calls
    k5_err = check_similarity(w_emb, p_emb, scores, idx)
    if len(held.held) != model.num_layers or bad or not k5_err <= SIM_TOL:
        raise fail(f"operator: {len(held.held)} K1 calls held, outside tolerance: {bad}; "
                   f"K5 error {k5_err}")
    out["held"] = {"k1_calls": len(held.held),
                   "k1_max_abs_err": max(c["max_abs_err"] for c in held.held),
                   "k5_max_abs_err": k5_err}
    engine.close()

    # the greedy pods' stored explanations against a direct provider drive
    # of the same captured requests, on an engine of the same weights.
    # The two drives must take the same steps (K1's rounding follows a
    # row's place in the step): the direct engine's sampler starts where
    # the operator's did, and each request keeps its operator deadline,
    # moved by one constant, so earliest-deadline-first admission orders
    # the rows as it did there (the pipeline hands the provider the budget
    # left after each pod's own collect and match, not a common one)
    direct = provider_module.build_tpu_native_provider(
        "cuda", {**CHECKPOINT_ENV, "CHECKPOINT_DIR": dirs["llm"]})
    direct_submit = direct.engine.submit
    moved: dict = {}

    def replayed(prompt, params=None, **kw):
        deadline, at = submitted[prompt]
        shift = moved.setdefault("s", direct.engine.generator._clock() - at)
        if deadline is not None:
            params = dataclasses.replace(params, deadline=deadline + shift)
        return direct_submit(prompt, params, **kw)

    try:
        direct.engine.warmup()
        asyncio.run(direct.generate(provider_requests()[0]))
        wait_idle(direct.engine.scheduler)
        drive_requests = [r for r, _ in exchanged[:OPERATOR_PODS]]
        direct.engine.generator._rng.set_state(drive_rng[0])
        direct.engine.submit = replayed
        want = gated_drive(direct, drive_requests)
    finally:
        direct.engine.submit = direct_submit
        direct.engine.close()
    greedy = [(r.failure_data.pod.metadata.name, w) for r, w in zip(drive_requests, want)
              if r.provider_config.temperature == 0.0]
    unequal = [(name, responses[name].to_dict(), w.to_dict()) for name, w in greedy
               if (responses[name].explanation, responses[name].completion_tokens,
                   responses[name].prompt_tokens)
               != (w.explanation, w.completion_tokens, w.prompt_tokens)]
    if len(greedy) != OPERATOR_PODS // 2 or unequal:
        raise fail(f"operator: greedy explanations differ from the direct drive's: {unequal}")
    out["greedy_equal_direct"] = len(greedy)
    out["sampled_equal_direct"] = all(
        responses[r.failure_data.pod.metadata.name].explanation == w.explanation
        for r, w in zip(drive_requests, want))
    provider_drive = (results.get("checkpoint") or {}).get("provider") or {}
    if provider_drive.get("tokens_per_s"):
        out["tokens_per_s_vs_provider_drive"] = out["tokens_per_s"] / provider_drive["tokens_per_s"]
    print(json.dumps({"operator_checks": {k: out.get(k) for k in (
        "held", "greedy_equal_direct", "sampled_equal_direct", "tokens_per_s",
        "tokens_per_s_vs_provider_drive")}, "card": out["card"]}), flush=True)
    results["operator"] = out
    return {name: sum(c[name] for c in every) for name in kernel_modules}


# ---------------------------------------------------------------------------
# phase 8: the serving front as a service, and the operator's remote path
# ---------------------------------------------------------------------------

#: the remote phase's two replicas, each a CompletionServer over one engine
REMOTE_REPLICAS = ("replica-a", "replica-b")
#: pods per batch of the remote operator drive (the ten are two batches)
REMOTE_BATCH = 5
#: the cancelled stream's budget: far past the steps its release may take
CANCEL_MAX_TOKENS = 256


def held_sends(engine, sends: list, timeout_s: float = 120.0) -> tuple:
    """Run every ``send()`` on its own thread, each queued at the engine in
    list order, the engine's admission held until all are queued — so two
    drives of the same requests take the same steps.  Returns (results in
    list order, the sampler's state the first step will find)."""
    gate = threading.Lock()
    admit = engine._admit_submissions
    results: list = [None] * len(sends)
    errors: list = []

    def gated(block: bool) -> None:
        with gate:
            admit(block)

    def call(i: int) -> None:
        try:
            results[i] = sends[i]()
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(f"send {i}: {exc!r}")

    engine._admit_submissions = gated
    threads = []
    try:
        with gate:
            # the worker's idle wait for a submission (50 ms) runs out, so
            # it reads the gated admission before the first one arrives
            time.sleep(0.2)
            base = engine._submissions.qsize()
            for i in range(len(sends)):
                thread = threading.Thread(target=call, args=(i,), daemon=True)
                thread.start()
                threads.append(thread)
                by = time.monotonic() + timeout_s
                while engine._submissions.qsize() < base + i + 1 and not errors:
                    if time.monotonic() > by:
                        raise fail(f"held drive: request {i} not queued in {timeout_s} s")
                    time.sleep(0.0005)
            rng = engine.generator._rng.get_state()
        for thread in threads:
            thread.join(900)
    finally:
        engine._admit_submissions = admit
    if errors or any(t.is_alive() for t in threads):
        raise fail(f"held drive: {errors or 'a request did not finish'}")
    return results, rng


def sse_request(port: int, path: str, body: dict, *, close_after_first: bool = False,
                timeout: float = 600.0) -> dict:
    """POST ``body`` with ``stream: true``; read the Server-Sent Events:
    the chunks' texts, time to the first chunk and the wall.  With
    ``close_after_first`` the socket is closed after the first chunk."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    started = time.perf_counter()
    try:
        conn.request("POST", path, json.dumps({**body, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200 or "text/event-stream" not in (resp.getheader("Content-Type") or ""):
            raise fail(f"stream {path}: status {resp.status}: {resp.read()[:300]!r}")
        out = {"texts": [], "finish": None, "first_chunk_s": None}
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):]
            if data == b"[DONE]":
                break
            event = json.loads(data)
            if "error" in event:
                raise fail(f"stream {path}: in-stream error {event}")
            choice = event["choices"][0]
            delta = choice.get("delta", {}).get("content") if "delta" in choice else choice.get("text")
            if out["first_chunk_s"] is None:
                out["first_chunk_s"] = time.perf_counter() - started
            if choice.get("finish_reason"):
                out["finish"] = choice["finish_reason"]
            if delta:
                out["texts"].append(delta)
            if close_after_first:
                break
        out["wall_s"] = time.perf_counter() - started
        return out
    finally:
        conn.close()


def parse_prometheus(text: str, openmetrics: bool) -> int:
    """Every sample line is ``name{labels} value [timestamp]`` (an
    OpenMetrics exemplar after `` # `` stripped); OpenMetrics ends with
    ``# EOF``.  Returns the number of samples."""
    samples = 0
    lines = text.rstrip("\n").splitlines()
    if openmetrics and lines[-1] != "# EOF":
        raise fail("the OpenMetrics exposition does not end with # EOF")
    for line in lines:
        if not line or line.startswith("#"):
            continue
        if openmetrics:
            line = line.split(" # ", 1)[0]
        match = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)( \S+)?", line)
        if match is None:
            raise fail(f"not a Prometheus sample line: {line!r}")
        float(match.group(3))
        samples += 1
    return samples


def http_get(port: int, path: str, headers: "dict | None" = None) -> tuple:
    request = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers or {})
    with urllib.request.urlopen(request, timeout=60) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def remote_resources(model_name: str, api_url: str) -> list:
    """The operator phase's two AIProviders and Podmortems, with
    ``providerId: openai-compatible`` naming both replicas."""
    out = []
    for kind, obj in operator_resources(model_name):
        if kind == "AIProvider":
            obj = {**obj, "spec": {**obj["spec"], "providerId": "openai-compatible",
                                   "apiUrl": api_url, "maxRetries": 3,
                                   "timeoutSeconds": 300}}
        out.append((kind, obj))
    return out


def phase_remote(results: dict, kernel_modules: dict, dirs: dict) -> dict:
    """The serving front as a service and the operator's remote path, on
    the checkpoint phase's two checkpoints.  Two ``CompletionServer``s
    (replicas A and B) over one engine on the card: (a) ten streamed and
    ten plain chat completions, held; (b) a stream closed after its first
    chunk; (c) three ``AnalysisRequest``s through the analyze route
    against the provider; (d) the port's ``Operator`` with ``providerId:
    openai-compatible`` over both replicas, B stopped between two batches
    of five pods; (e) ``/v1/embeddings``; (f) ``/metrics`` and a
    ``/profile`` capture.  Returns the launch counts over the drives."""
    import asyncio

    import numpy as np

    from operator_tpu_torch.obs import FlightRecorder, Tracer
    from operator_tpu_torch.operator import FakeKubeApi, Operator
    from operator_tpu_torch.operator.providers import replica_set
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, build_embedder
    from operator_tpu_torch.router import EngineRouter
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.prompts import build_prompt
    from operator_tpu_torch.serving.provider import TPUNativeProvider, build_serving_engine
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    out: dict = {"card": card_line()}
    env = {**CHECKPOINT_ENV, "CHECKPOINT_DIR": dirs["llm"]}
    engine, model_id = build_serving_engine("cuda", env)
    sched, g, layers = engine.scheduler, engine.generator, engine.generator.config.num_layers
    embedder = build_embedder(dirs["encoder"], fallback=False, device="cuda")
    if not isinstance(embedder, NeuralEmbedder):
        raise fail("remote: the encoder checkpoint did not load as a NeuralEmbedder")
    provider = TPUNativeProvider(engine, model_id=model_id)
    server_recorder = FlightRecorder(capacity=256)
    profile_dir = os.path.join(dirs["workdir"], "profile")
    servers = [CompletionServer(
        engine, model_id=model_id, host="127.0.0.1", port=0, embedder=embedder,
        analysis_backend=provider, tracer=Tracer(recorder=server_recorder),
        replica_id=rid, profile_enabled=True, profile_dir=profile_dir,
    ) for rid in REMOTE_REPLICAS]
    engine.warmup()
    http = HttpLoop(*servers)
    ports = [s.bound_port for s in servers]
    #: the launches of the drives' checked windows (not the comparisons')
    launches_total = {name: 0 for name in kernel_modules}

    def counts(path: bool = False) -> dict:
        """The counts since the last call, added to the path's total when
        ``path``; then every count is 0."""
        launches = {name: m.launches for name, m in kernel_modules.items()}
        for module in kernel_modules.values():
            module.launches = 0
        for name, n in launches.items():
            launches_total[name] += n if path else 0
        return launches

    def k1_per_step(where: str, steps0: int, k5: "int | None" = 0) -> dict:
        """The counts since ``steps0``: K1 once per layer per step, K5 as
        given (``None``: the caller counts it), the wave kernels never."""
        steps, launches = sched.steps - steps0, counts(path=True)
        want = {"ragged_paged_attention": layers * steps,
                "best_window_similarity": launches["best_window_similarity"] if k5 is None else k5,
                "paged_decode_attention": 0, "flash_prefill_attention": 0}
        if launches != want or steps == 0:
            raise fail(f"remote {where}: launches {launches} over {steps} steps; want {want}")
        return {"steps": steps, "launches": launches}

    try:
        requests = provider_requests()
        prompts = [build_prompt(r) for r in requests]
        # (a) ten chat completions streamed, then the same ten plain: both
        # held, each on an empty prefix cache from the same sampler state
        chat = [{"messages": [{"role": "user", "content": p}], "max_tokens": MAX_TOKENS,
                 "temperature": r.provider_config.temperature, "top_p": 0.95}
                for p, r in zip(prompts, requests)]
        wait_idle(sched)
        sched.spill_cache()
        rng0 = g._rng.get_state()
        counts()
        steps0 = sched.steps
        started = time.perf_counter()
        streamed, _ = held_sends(engine, [
            lambda b=b, i=i: sse_request(ports[i % 2], "/v1/chat/completions", b)
            for i, b in enumerate(chat)])
        stream_wall = time.perf_counter() - started
        stream_launches = k1_per_step("streamed drive", steps0)
        wait_idle(sched)
        sched.spill_cache()
        g._rng.set_state(rng0)
        steps0 = sched.steps
        started = time.perf_counter()
        plain, _ = held_sends(engine, [
            lambda b=b, i=i: _post(f"http://127.0.0.1:{ports[i % 2]}/v1/chat/completions", b)
            for i, b in enumerate(chat)])
        plain_wall = time.perf_counter() - started
        plain_launches = k1_per_step("plain drive", steps0)
        greedy = [i for i, b in enumerate(chat) if b["temperature"] == 0.0]
        unequal = [(i, "".join(streamed[i]["texts"]), plain[i]["choices"][0]["message"]["content"])
                   for i in greedy
                   if "".join(streamed[i]["texts"]) != plain[i]["choices"][0]["message"]["content"]]
        if unequal or not greedy:
            raise fail(f"remote: streamed greedy text differs from the plain text: {unequal}")
        completion = sum(p["usage"]["completion_tokens"] for p in plain)
        out["streaming"] = {
            "requests": len(chat), "greedy_equal": len(greedy),
            "sampled_equal": all("".join(streamed[i]["texts"])
                                 == plain[i]["choices"][0]["message"]["content"]
                                 for i in range(len(chat))),
            "first_chunk_s": [s["first_chunk_s"] for s in streamed],
            "chunks": [len(s["texts"]) for s in streamed],
            "completion_tokens": [p["usage"]["completion_tokens"] for p in plain],
            "stream_wall_s": stream_wall, "plain_wall_s": plain_wall,
            "stream_tokens_per_s": completion / stream_wall,
            "plain_tokens_per_s": completion / plain_wall,
            "stream_steps": stream_launches["steps"], "plain_steps": plain_launches["steps"],
        }
        print(json.dumps({"remote_streaming": out["streaming"], "card": out["card"]}), flush=True)

        # (b) a long stream closed after its first chunk: its row and pages
        # return within pipeline depth + 2 steps of the close
        wait_idle(sched)
        steps0 = sched.steps
        first = sse_request(ports[0], "/v1/chat/completions",
                            {**chat[0], "max_tokens": CANCEL_MAX_TOKENS}, close_after_first=True)
        closed_at = sched.steps
        by = time.monotonic() + 60
        while sched.total_work and time.monotonic() < by:
            time.sleep(0.0005)
        released_at = sched.steps
        cancel_launches = k1_per_step("cancelled stream", steps0)
        accounting = balanced(sched, "after the cancelled stream")
        load = healthz(ports[0])["load"]
        if (sched.total_work or accounting["row_pages"] or load["inflight"] != 0
                or released_at - closed_at > sched.depth + 2):
            raise fail(f"remote: the closed stream was not released: work {sched.total_work}, "
                       f"steps close -> release {released_at - closed_at}, {accounting}, "
                       f"inflight {load['inflight']}")
        out["cancel"] = {"first_chunk_s": first["first_chunk_s"],
                         "steps_close_to_release": released_at - closed_at,
                         "steps_in_all": cancel_launches["steps"],
                         "page_accounting": accounting}
        print(json.dumps({"remote_cancel": out["cancel"], "card": out["card"]}), flush=True)

        # (c) the reference contract: three AnalysisRequests through the
        # analyze route, then the provider directly, both held
        three = requests[:3]
        wait_idle(sched)
        sched.spill_cache()
        rng0 = g._rng.get_state()
        steps0 = sched.steps
        routed, _ = held_sends(engine, [
            lambda r=r: _post(f"http://127.0.0.1:{ports[1]}/api/v1/analysis/analyze",
                              r.to_dict()) for r in three])
        analyze_launches = k1_per_step("analyze route", steps0)
        wait_idle(sched)
        sched.spill_cache()
        g._rng.set_state(rng0)
        direct, _ = held_sends(engine, [
            lambda r=r: asyncio.run(provider.generate(r)).to_dict() for r in three])
        counts()
        greedy = [i for i, r in enumerate(three) if r.provider_config.temperature == 0.0]
        unequal = [(i, routed[i], direct[i]) for i in greedy if routed[i] != direct[i]]
        if unequal or not greedy or any(r.get("error") for r in routed):
            raise fail(f"remote: the analyze route differs from the provider: {unequal or routed}")
        out["analyze"] = {"requests": len(three), "greedy_equal": len(greedy),
                          "steps": analyze_launches["steps"],
                          "completion_tokens": [r["completionTokens"] for r in routed]}
        print(json.dumps({"remote_analyze": out["analyze"], "card": out["card"]}), flush=True)

        out["operator"] = remote_operator(
            dirs, engine, model_id, servers, http, ports, counts, k1_per_step, out["card"])
        # the replica still listening serves (e) and (f)
        [live] = [s.bound_port for s in servers if s.bound_port is not None]

        # (e) /v1/embeddings: the encoder on the card, bit for bit
        lines = fixture_lines(sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))[0])[:8]
        counts()
        embedded = _post(f"http://127.0.0.1:{live}/v1/embeddings", {"input": lines})
        got = np.asarray([d["embedding"] for d in embedded["data"]], np.float32)
        want = embedder.embed(lines)
        launches = counts()
        if got.shape != want.shape or not np.array_equal(got, want) or any(launches.values()):
            raise fail(f"remote: /v1/embeddings differs from embedder.embed "
                       f"(max {float(np.abs(got - want).max()) if got.shape == want.shape else got.shape}), "
                       f"launches {launches}")
        out["embeddings"] = {"lines": len(lines), "dim": int(want.shape[1]), "bit_equal": True}

        # (f) /metrics as Prometheus text and under OpenMetrics, and a
        # one-second /profile capture during a short drive that names K1
        _, ctype, text = http_get(live, "/metrics")
        _, om_ctype, om_text = http_get(live, "/metrics", {
            "Accept": "application/openmetrics-text; version=1.0.0"})
        if "text/plain" not in ctype or "openmetrics-text" not in om_ctype:
            raise fail(f"remote: /metrics content types {ctype!r}, {om_ctype!r}")
        samples = (parse_prometheus(text.decode(), False),
                   parse_prometheus(om_text.decode(), True))
        wait_idle(sched)
        steps0 = sched.steps
        captured: dict = {}
        capture = threading.Thread(target=lambda: captured.update(
            _post(f"http://127.0.0.1:{live}/profile?seconds=1", {})), daemon=True)
        capture.start()
        time.sleep(0.2)
        short = [threading.Thread(target=_post, args=(
            f"http://127.0.0.1:{live}/v1/completions",
            {"prompt": LOG_LINE[:200 + 50 * i], "max_tokens": 16, "temperature": 0.0}))
            for i in range(4)]
        for thread in short:
            thread.start()
        for thread in short + [capture]:
            thread.join(300)
        wait_idle(sched)
        profile_launches = k1_per_step("profiled drive", steps0)
        trace = os.path.join(captured.get("artifact", ""), "trace.json")
        if not os.path.exists(trace):
            raise fail(f"remote: /profile wrote no trace: {captured}")
        with open(trace, encoding="utf-8") as fh:
            names = {e.get("name", "") for e in json.load(fh).get("traceEvents", [])}
        k1_names = sorted(n for n in names if "ragged_attention" in n)
        if not k1_names:
            raise fail("remote: the /profile trace names no K1 kernel")
        out["metrics"] = {"samples": samples[0], "openmetrics_samples": samples[1]}
        out["profile"] = {"seconds": captured["seconds"], "k1_kernels": k1_names,
                          "steps": profile_launches["steps"]}
    finally:
        http.stop()
        engine.close()
    out["launches"] = launches_total
    print(json.dumps({"remote": {k: out[k] for k in (
        "embeddings", "metrics", "profile", "launches")}, "card": out["card"]}), flush=True)
    results["remote"] = out
    return launches_total


def remote_operator(dirs: dict, engine, model_id: str, servers: list, http, ports: list,
                    counts, k1_per_step, card: str) -> dict:
    """(d) of the remote phase: the port's ``Operator`` over ``FakeKubeApi``
    with ``providerId: openai-compatible`` naming both replicas and the
    encoder checkpoint as ``ENCODER_CHECKPOINT_DIR``.  The operator
    phase's ten pods are poked at once; each analysis is held at the
    provider until all ten have their fingerprints, so the drive knows
    every pod's affinity owner.  The replica that owns enough pods is
    stopped between two batches of five: the first batch holds pods of
    both owners, the second at least ``router_replica_failure_threshold``
    of the stopped replica's, which fail there, requeue once and land on
    the other replica while its breaker opens.  Each batch's engine
    admission is held until its five requests are queued; the drive's
    greedy explanations must equal a held replay of the captured engine
    requests on the same engine, from each batch's sampler state."""
    import asyncio

    from operator_tpu_torch.operator import FakeKubeApi, Operator
    from operator_tpu_torch.operator.providers import replica_set
    from operator_tpu_torch.router import EngineRouter
    from operator_tpu_torch.serving.prompts import build_prompt
    from operator_tpu_torch.utils.config import OperatorConfig
    from operator_tpu_torch.utils.timing import MetricsRegistry

    sched, g = engine.scheduler, engine.generator
    api_url = ",".join(f"http://127.0.0.1:{p}" for p in ports)
    env = {"ENCODER_CHECKPOINT_DIR": dirs["encoder"],
           "PATTERN_CACHE_DIRECTORY": os.path.join(dirs["workdir"], "no-pattern-cache"),
           "HEALTH_PORT": "0", "HEALTH_HOST": "127.0.0.1", "INCIDENTS_API_TOKEN": "remote",
           # the drive polls /healthz itself, after the failover
           "ROUTER_HEALTH_POLL_S": "0"}
    config = OperatorConfig.from_env(env)
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))[:OPERATOR_PODS]
    pods = [(f"payment-{i}", ("greedy", "sampled")[i % 2], "\n".join(fixture_lines(name)))
            for i, name in enumerate(names)]
    operator = Operator(FakeKubeApi(), config=config, metrics=MetricsRegistry())
    api, semantic, index = operator.api, operator.engine.semantic, operator.memory.index
    backend = operator._http_backend
    k5_calls = {"analyze": 0, "query": 0}
    match, query, generate = semantic.match, index.query, backend.generate

    def counted_match(lines):
        k5_calls["analyze"] += bool(lines) and semantic.num_patterns > 0
        return match(lines)

    def counted_query(text, k=3):
        k5_calls["query"] += len(index) > 0 and bool(text.strip())
        return query(text, k)

    # each pod's analysis waits at the provider until its batch is let go
    owners: dict = {}
    release: dict = {}
    held_ns: dict = {}
    responses: dict = {}

    async def held_generate(request):
        pod = request.failure_data.pod.metadata.name
        router = backend.router_for(replica_set(request.provider_config.api_url))
        key = EngineRouter.affinity_key(prefix=build_prompt(request),
                                        fingerprint=request.fingerprint)
        owners[pod] = router.route(key).affinity_owner
        release.setdefault(pod, asyncio.Event())
        arrived = time.monotonic_ns()
        await release[pod].wait()
        held_ns[pod] = time.monotonic_ns() - arrived
        responses[pod] = await generate(request)
        return responses[pod]

    # the engine side: every submission, in queue order, per batch
    captured: list = []
    submit = engine.submit

    def recorded(prompt, params=None, **kw):
        future = submit(prompt, params, **kw)
        captured.append((prompt, params, kw, future))
        return future

    async def wait_for(predicate, what: str, timeout_s: float = 300.0) -> None:
        by = time.monotonic() + timeout_s
        while not predicate():
            if time.monotonic() > by:
                raise fail(f"remote operator: {what} not within {timeout_s} s")
            await asyncio.sleep(0.002)

    async def stored(names_: list) -> dict:
        return {f["podName"]: f for cr in await api.list("Podmortem", "ops")
                for f in (cr.get("status") or {}).get("recentFailures") or []
                if f["podName"] in names_}

    async def drive() -> dict:
        for kind, obj in remote_resources(model_id, api_url):
            await asyncio.wait_for(api.create(kind, obj), timeout=config.kube_call_timeout_s)
        await operator.start()
        await asyncio.sleep(0.05)
        poked: dict = {}
        counts()
        started = time.monotonic_ns()
        for i, (name, variant, log) in enumerate(pods):
            api.set_pod_log("prod", name, log, previous=True)
            await asyncio.wait_for(api.create("Pod", operator_pod(
                name, variant, f"2026-07-28T09:{i:02d}:00Z")), timeout=config.kube_call_timeout_s)
            poked[name] = time.monotonic_ns()
            await asyncio.wait_for(
                api.patch("Pod", name, "prod", {"metadata": {"labels": {"poked": "1"}}}),
                timeout=config.kube_call_timeout_s)
        await wait_for(lambda: len(owners) == len(pods), "ten analyses at the provider")
        # the analyses' K5 launches; K1 none, every answer is held
        analyses = counts(path=True)
        by_owner: dict = {}
        for name, _, _ in pods:
            by_owner.setdefault(owners[name], []).append(name)
        threshold = config.router_replica_failure_threshold
        # the replica to stop: one owning at least threshold + 1 pods while
        # the other owns one (B, if that will do)
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        order = [urls[1], urls[0]]
        stop_url = next((u for u in order if len(by_owner.get(u, [])) >= threshold + 1
                         and len(pods) - len(by_owner.get(u, [])) >= 1), None)
        if stop_url is None:
            raise fail(f"remote operator: every pod is owned by one replica: {owners}")
        keep_url = urls[1 - urls.index(stop_url)]
        doomed = by_owner[stop_url]
        second = doomed[:min(len(doomed) - 1, REMOTE_BATCH)]
        second += [n for n, _, _ in pods if n not in second][:REMOTE_BATCH - len(second)]
        first = [n for n, _, _ in pods if n not in second]
        batches = []
        for batch_no, batch in enumerate((first, second)):
            if batch_no == 1:
                # the replica goes away between the batches
                stopped = servers[urls.index(stop_url)]
                await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    stopped.stop(), http.loop))
            wait_idle(sched)
            sched.spill_cache()
            counts()
            steps0 = sched.steps
            gate = threading.Lock()
            admit = engine._admit_submissions

            def gated(block: bool, admit=admit, gate=gate) -> None:
                with gate:
                    admit(block)

            engine._admit_submissions = gated
            gate.acquire()
            try:
                await asyncio.sleep(0.2)
                before = len(captured)
                released = time.monotonic_ns()
                for name in batch:
                    release.setdefault(name, asyncio.Event()).set()
                await wait_for(lambda: engine._submissions.qsize() >= len(batch),
                               f"batch {batch_no + 1}'s requests queued")
                rng = g._rng.get_state()
            finally:
                gate.release()
                engine._admit_submissions = admit
            await wait_for(lambda: all(n in responses for n in batch),
                           f"batch {batch_no + 1}'s answers")
            wait_idle(sched)
            done = time.monotonic_ns()
            batches.append({"pods": batch, "captured": (before, before + len(batch)),
                            "rng": rng, "released_ns": released, "done_ns": done,
                            **k1_per_step(f"operator batch {batch_no + 1}", steps0,
                                          k5=None)})
        await operator.watcher.drain()
        wall_s = (time.monotonic_ns() - started) / 1e9
        polled = await backend.poll_replica_health(timeout_s=30.0)
        url = f"http://127.0.0.1:{operator.health_server.bound_port}"

        def fleet_get():
            request = urllib.request.Request(url + "/fleet",
                                             headers={"Authorization": "Bearer remote"})
            with urllib.request.urlopen(request, timeout=30) as resp:
                return json.loads(resp.read())

        fleet = await asyncio.to_thread(fleet_get)
        failures = await stored([n for n, _, _ in pods])
        events = await api.list("Event")
        await operator.stop()
        return {"poked": poked, "wall_s": wall_s, "batches": batches, "stop_url": stop_url,
                "analyses": analyses,
                "keep_url": keep_url, "polled": polled, "fleet": fleet,
                "failures": failures, "events": events}

    semantic.match, index.query, backend.generate = counted_match, counted_query, held_generate
    engine.submit = recorded
    try:
        run = asyncio.run(drive())
    finally:
        semantic.match, index.query, backend.generate = match, query, generate
        engine.submit = submit
    stop_url, keep_url = run["stop_url"], run["keep_url"]
    names_all = [n for n, _, _ in pods]
    failures = run["failures"]
    pod_events: dict = {}
    for e in run["events"]:
        regarding = e.get("regarding") or {}
        if regarding.get("kind") == "Pod":
            pod_events.setdefault(regarding.get("name"), set()).add(e.get("reason"))
    bad = [(n, failures.get(n), responses.get(n) and responses[n].to_dict())
           for n in names_all
           if n not in failures or not responses.get(n) or responses[n].error
           or not responses[n].completion_tokens
           or failures[n]["analysisStatus"] != (
               "Analyzed" if responses[n].explanation else "PatternOnly")
           or (responses[n].explanation and failures[n].get("explanation")
               != responses[n].explanation)
           or pod_events.get(n) != {"PodFailureDetected", "PodmortemAnalysisComplete"}]
    if bad:
        raise fail(f"remote operator: pods without a stored answer: {bad}")
    first, second = run["batches"][0]["pods"], run["batches"][1]["pods"]
    served = {n: responses[n].replica_id for n in names_all}
    requeues = {n: responses[n].requeues for n in names_all}
    first_replicas = {served[n] for n in first}
    failed_over = [n for n in second if owners[n] == stop_url and requeues[n] >= 1]
    stopped_health = run["fleet"]["replicas"].get(stop_url, {})
    backend_router = backend.router_for(replica_set(",".join(
        f"http://127.0.0.1:{p}" for p in ports)))
    breaker = backend_router.health.breakers.for_key(stop_url).state
    stop_errors = backend_router.health.for_replica(stop_url).total_errors
    threshold = config.router_replica_failure_threshold
    if (len(first_replicas) != 2 or any(served[n] != owners[n] for n in first)
            or any(served[n] != keep_url for n in second) or not failed_over
            or breaker != "open" or stop_errors < threshold
            or sorted(run["fleet"]["replicas"]) != sorted([stop_url, keep_url])
            or stopped_health.get("ready") is not False):
        raise fail(f"remote operator: first batch on {first_replicas}, served {served}, "
                   f"owners {owners}, requeues {requeues}, stopped {stop_url} breaker "
                   f"{breaker} after {stop_errors} errors, fleet {run['fleet']}")
    # K1 per step was held per batch; K5 is the operator's: one per
    # semantic analyze() and one per recall query over a non-empty index
    every = [run["analyses"], *(b["launches"] for b in run["batches"])]
    k5 = sum(c["best_window_similarity"] for c in every)
    if (k5 != k5_calls["analyze"] + k5_calls["query"] or k5_calls["analyze"] != len(pods)
            or any(c["paged_decode_attention"] or c["flash_prefill_attention"] for c in every)
            or run["analyses"]["ragged_paged_attention"]):
        raise fail(f"remote operator: launches {every} for {k5_calls}")

    # the greedy explanations against a held replay of the captured engine
    # requests, batch by batch, on the same engine from the same state
    replay: list = []
    for batch in run["batches"]:
        lo, hi = batch["captured"]
        wait_idle(sched)
        sched.spill_cache()
        g._rng.set_state(batch["rng"])
        results_, _ = held_sends(engine, [
            lambda c=c: submit(c[0], c[1], **c[2]).result(timeout=600)
            for c in captured[lo:hi]])
        replay.extend(results_)
    counts()
    drive_results = [c[3].result() for c in captured]
    greedy = [i for i, c in enumerate(captured) if c[1].temperature == 0.0]
    unequal = [(i, drive_results[i].text, replay[i].text) for i in greedy
               if drive_results[i].token_ids != replay[i].token_ids]
    if len(captured) != len(pods) or unequal or not greedy:
        raise fail(f"remote operator: {len(captured)} engine requests; greedy ones differ "
                   f"from the replay: {unequal}")

    # per pod: the stage split, the provider's gate wait taken out of the
    # explain stage, and the HTTP overhead: the successful dispatch span
    # less the serving replica's own request span for the same trace
    server_spans = {}
    for server in servers:
        for record in server.tracer.recorder.traces():
            root = next(sp for sp in record.trace["spans"] if sp["name"].startswith("http "))
            server_spans[record.trace_id] = (root["endNs"] - root["startNs"]) / 1e6
    per_pod: dict = {}
    traces = {r.trace_id: r.trace["spans"] for r in operator.recorder.traces()}
    for record in operator.pipeline.slo_ledger.records:
        spans = traces[record.trace_id]
        root = next(sp for sp in spans if "parentId" not in sp)
        name = root["attributes"]["pod"].split("/")[-1]
        dispatch = [sp for sp in spans if sp["name"] == "router.dispatch"]
        ok = [sp for sp in dispatch if sp["status"] == "ok"][-1]
        stages = record.stages
        store = next(sp for sp in spans if sp["name"] == "store"
                     and sp.get("parentId") == root["spanId"])
        per_pod[name] = {
            "poke_to_stored_ms": (store["endNs"] - run["poked"][name]) / 1e6,
            "held_at_provider_ms": held_ns[name] / 1e6,
            "stages_ms": {"collect": stages.get("collect"), "analyze": stages.get("parse"),
                          "recall": stages.get("recall"),
                          "generate_less_hold": stages.get("explain", 0.0) - held_ns[name] / 1e6,
                          "store": stages.get("store")},
            "dispatch_attempts": len(dispatch),
            "http_overhead_ms": ((ok["endNs"] - ok["startNs"]) / 1e6
                                 - server_spans[record.trace_id]),
        }
    completion = sum(responses[n].completion_tokens for n in names_all)
    active_s = sum((b["done_ns"] - b["released_ns"]) / 1e9 for b in run["batches"])
    out = {
        "pods": len(pods), "owners": owners, "stopped": stop_url, "served": served,
        "requeues": requeues, "failed_over": failed_over, "breaker": breaker,
        "stopped_replica_errors": stop_errors, "fleet_replicas": sorted(run["fleet"]["replicas"]),
        "batches": [{"pods": b["pods"], "steps": b["steps"], "launches": b["launches"],
                     "wall_s": (b["done_ns"] - b["released_ns"]) / 1e9}
                    for b in run["batches"]],
        "k5_calls": k5_calls, "completion_tokens": completion,
        "first_poke_to_drain_s": run["wall_s"],
        "tokens_per_s": completion / run["wall_s"],
        "tokens_per_s_released": completion / active_s,
        "greedy_equal_replay": len(greedy),
        "sampled_equal_replay": all(drive_results[i].token_ids == replay[i].token_ids
                                    for i in range(len(captured))),
        "http_overhead_ms": sorted(p["http_overhead_ms"] for p in per_pod.values()),
        "launches": {"analyses": run["analyses"]},
    }
    print(json.dumps({"remote_operator": out, "card": card}), flush=True)
    print(json.dumps({"remote_operator_per_pod": per_pod, "card": card}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: card vs CPU on a small engine
# ---------------------------------------------------------------------------


def phase_parity(results: dict, kernel_modules: dict) -> None:
    import torch

    from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, init_params
    from operator_tpu_torch.serving.engine import Generator, ServingEngine
    from operator_tpu_torch.serving.sched import Scheduler
    from operator_tpu_torch.serving.types import SamplingParams

    gen = torch.Generator(device="cpu").manual_seed(0)
    params_cpu = init_params(TINY_TEST, gen, torch.float32, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        return tree.to(device)

    prompts = [LOG_LINE[:30], LOG_LINE * 3, "OOMKilled OOMKilled OOMKilled"]
    sampling = SamplingParams(max_tokens=16, temperature=0.0)

    def run(device, wave):
        generator = Generator(
            to(params_cpu, device), TINY_TEST, ByteTokenizer(), max_slots=4,
            max_seq=256, page_size=16, cache_dtype=torch.float32, device=device,
            decode_block=4 if wave else 1, pipeline_depth=2 if wave else 1,
        )
        sched = None if wave else Scheduler(
            generator, chunk=16, token_budget=32, pipeline_depth=2, spec_decode=True,
        )
        engine = ServingEngine(generator, sched)
        try:
            return [r.token_ids for r in engine.generate_batch(prompts, sampling)]
        finally:
            engine.close()

    tokens = {device: run(device, wave=False) for device in ("cuda", "cpu")}
    if tokens["cuda"] != tokens["cpu"]:
        raise fail(f"greedy tokens differ card vs CPU: {tokens}")
    results["parity"] = {"prompts": len(prompts), "tokens": tokens["cuda"]}
    print(json.dumps({"parity": "ok", "tokens": tokens["cuda"]}), flush=True)
    results["store_parity"] = store_parity(to(params_cpu, "cuda"), params_cpu)

    saved = {k: os.environ.get(k) for k in ("OPERATOR_TPU_FLASH_PREFILL", "OPERATOR_TPU_PAGED_KERNEL")}
    wave_parity = []
    try:
        for version in ("v1", "v2"):
            for flash in ("0", "1"):
                os.environ["OPERATOR_TPU_PAGED_KERNEL"] = version
                os.environ["OPERATOR_TPU_FLASH_PREFILL"] = flash
                for module in kernel_modules.values():
                    module.launches = 0
                card = run("cuda", wave=True)
                launches = {name: m.launches for name, m in kernel_modules.items()}
                cpu = run("cpu", wave=True)
                ok = (
                    card == cpu
                    and launches["paged_decode_attention"] > 0
                    and (launches["flash_prefill_attention"] > 0) == (flash == "1")
                    and launches["ragged_paged_attention"] == 0
                    and launches["best_window_similarity"] == 0
                )
                wave_parity.append({"paged_kernel": version, "flash_prefill": flash == "1",
                                    "launches": launches, "tokens_equal": card == cpu})
                print(json.dumps({"wave_parity": wave_parity[-1]}), flush=True)
                if not ok:
                    raise fail(f"wave parity {version}/flash={flash}: card {card} cpu {cpu} "
                               f"launches {launches}")
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    results["wave_parity"] = wave_parity
    results["analysis_parity"] = analysis_parity(kernel_modules)


def store_parity(params_cuda, params_cpu) -> dict:
    """The continuous scheduler with the prefix cache and an 8 MB host
    pool, f32 ``tiny-test``: prompts sharing a prefix arrive in two waves
    with a ``spill_cache()`` and one short request (whose commit window
    puts the spilled pages into the pool) between them, so the second
    wave restores from pinned host memory.  The card must give the CPU's
    tokens, and on the card the warm wave the cold one's."""
    import torch

    from operator_tpu_torch.models import TINY_TEST, ByteTokenizer
    from operator_tpu_torch.ops.kv_transfer import HostKVPool
    from operator_tpu_torch.serving.engine import Generator, ServingEngine
    from operator_tpu_torch.serving.kvstore import PrefixKVStore
    from operator_tpu_torch.serving.sched import Scheduler
    from operator_tpu_torch.serving.types import SamplingParams

    head = LOG_LINE * 2
    prompts = [head + "pod a", head + "pod b restarted", head[:100], LOG_LINE[:50]]
    sampling = SamplingParams(max_tokens=12, temperature=0.0, stop_on_eos=False)

    def run(device, params):
        generator = Generator(
            params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=256, page_size=16,
            cache_dtype=torch.float32, device=device,
        )
        store = PrefixKVStore(16, host_pool=HostKVPool(8), metrics=generator.metrics)
        sched = Scheduler(generator, chunk=16, token_budget=32, pipeline_depth=2,
                          spec_decode=True, kvstore=store)
        engine = ServingEngine(generator, sched)
        try:
            cold = [r.token_ids for r in engine.generate_batch(prompts, sampling)]
            spilled = sched.spill_cache()
            engine.generate_batch(["drain"], SamplingParams(max_tokens=1, temperature=0.0))
            warm = [r.token_ids for r in engine.generate_batch(prompts, sampling)]
            acc = sched.page_accounting()
            if sum(acc[k] for k in ("available", "row_pages", "store_pages", "prefix_pages")) != acc["total"]:
                raise fail(f"store parity on {device}: pages do not balance {acc}")
            counter = generator.metrics.counter
            return {"cold": cold, "warm": warm, "spilled": spilled,
                    "offloads": counter("kv_offload"), "restores": counter("kv_restore"),
                    "saved": counter("kv_prefill_tokens_saved")}
        finally:
            engine.close()

    card, cpu = run("cuda", params_cuda), run("cpu", params_cpu)
    if card != cpu:
        raise fail(f"store parity: the card's run differs from the CPU's: {card} vs {cpu}")
    if card["warm"] != card["cold"] or not card["restores"] or not card["offloads"]:
        raise fail(f"store parity on the card: warm != cold or no pool round trip: {card}")
    out = {k: v for k, v in card.items() if k not in ("cold", "warm")}
    print(json.dumps({"store_parity": "ok", **out}), flush=True)
    return out


def analysis_parity(kernel_modules: dict) -> dict:
    """``PatternEngine.analyze`` with one tiny f32 ``NeuralEmbedder`` on the
    card and on the CPU over the 12 fixture logs: the same events (pattern,
    source, context), scores within 1e-4 (one step of the 4-digit rounding
    of an event's score; compared by pattern, since a rounding step can
    reorder events of equal score), K5 once per analysis on the card."""
    import torch

    from operator_tpu_torch.models.encoder import ENCODER_TINY_TEST, init_encoder_params
    from operator_tpu_torch.patterns.engine import PatternEngine
    from operator_tpu_torch.patterns.semantic import NeuralEmbedder, SemanticMatcher
    from operator_tpu_torch.schema.analysis import PodFailureData

    params = init_encoder_params(ENCODER_TINY_TEST, torch.Generator().manual_seed(0),
                                 torch.float32, device="cpu")

    def tokenize(text):
        return [b % ENCODER_TINY_TEST.vocab_size for b in text.encode()]

    def engine(device):
        embedder = NeuralEmbedder(params, ENCODER_TINY_TEST, tokenize, max_tokens=64,
                                  batch_size=8, device=device)
        return PatternEngine(semantic=SemanticMatcher(embedder, device=device))

    def events(result):
        return {e.matched_pattern.id: (e.source, e.context.line_number, e.context.matched_line,
                                       e.context.lines_before, e.context.lines_after, e.score)
                for e in result.events}

    card, cpu = engine("cuda"), engine("cpu")
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".log"))
    for module in kernel_modules.values():
        module.launches = 0
    found = 0
    for name in names:
        failure = PodFailureData(logs="\n".join(fixture_lines(name)))
        got, want = events(card.analyze(failure)), events(cpu.analyze(failure))
        same = got.keys() == want.keys() and all(
            got[k][:-1] == want[k][:-1] and abs(got[k][-1] - want[k][-1]) <= 1e-4 + 1e-9
            for k in got)
        if not same:
            raise fail(f"analysis parity {name}: card {got} cpu {want}")
        found += len(got)
    launches = {name: m.launches for name, m in kernel_modules.items()}
    want_launches = {name: 0 for name in kernel_modules}
    want_launches["best_window_similarity"] = len(names)
    if launches != want_launches:
        raise fail(f"analysis parity launches {launches}, want {want_launches}")
    out = {"logs": len(names), "events": found, "launches": launches}
    print(json.dumps({"analysis_parity": out}), flush=True)
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every result to this JSON file")
    parser.add_argument("--phases",
                        default="device,kernels,serve,wave,analysis,checkpoint,operator,remote,"
                                "parity")
    args = parser.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from operator_tpu_torch.ops import _build
        from operator_tpu_torch.ops import (
            flash_prefill,
            paged_attention,
            ragged_attention,
            similarity,
        )
    except ImportError as exc:
        print(f"chip_smoke: the operator_tpu_torch package is missing: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernel_modules = {
        "ragged_paged_attention": ragged_attention,
        "paged_decode_attention": paged_attention,
        "flash_prefill_attention": flash_prefill,
        "best_window_similarity": similarity,
    }
    card = card_line()
    print(card, flush=True)
    results: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    started = time.perf_counter()
    _build.build_all()
    results["build_s"] = time.perf_counter() - started
    print(json.dumps({"build_s": results["build_s"], "sources": _build.source_names()}), flush=True)
    results["tensor_core_instructions"] = tensor_core_instructions(_build)
    print(json.dumps({"tensor_core_instructions": results["tensor_core_instructions"]}), flush=True)
    no_mma = [name for name in ("ragged_attention", "paged_attention", "flash_prefill")
              if not results["tensor_core_instructions"][name]]
    if no_mma:
        raise fail(f"no tensor-core instruction (HMMA/HGMMA) in {no_mma}")

    records = []
    if "kernels" in phases:
        records = ([phase_kernels(results)] + phase_wave_kernels(results)
                   + [phase_similarity_kernels(results, phases)])
    launches = phase_serve(results, kernel_modules, phases) if "serve" in phases else {}
    if "serve" in phases:
        phase_serve_pool(results, kernel_modules)
    wave_launches = {
        selector: phase_wave(results, kernel_modules, phases, selector)
        for selector in (("v1", "v2") if "wave" in phases else ())
    }
    analysis = phase_analysis(results, kernel_modules, phases) if "analysis" in phases else {}
    served = phases & {"operator", "remote"}
    if served and "checkpoint" not in phases:
        raise fail(f"the {', '.join(sorted(served))} phase serves the checkpoint phase's "
                   f"checkpoints: add checkpoint")
    checkpoint, dirs = (phase_checkpoint(results, kernel_modules, keep=bool(served))
                        if "checkpoint" in phases else ({}, None))
    operator, remote = {}, {}
    if served:
        try:
            if "operator" in phases:
                operator = phase_operator(results, kernel_modules, dirs)
            if "remote" in phases:
                remote = phase_remote(results, kernel_modules, dirs)
        finally:
            shutil.rmtree(dirs["workdir"], ignore_errors=True)
    if "parity" in phases:
        phase_parity(results, kernel_modules)
    # each kernel's count from the drive of the path it serves: K1 the
    # continuous serve phase, the decode kernel the wave drive under its
    # own selector value, the prefill kernel the default (v1) wave drive,
    # K5 the analysis phase's drives (two analyses and the recall queries)
    v1, v2 = wave_launches.get("v1", {}), wave_launches.get("v2", {})
    path_launches = {
        "ragged_paged_attention": launches.get("ragged_paged_attention"),
        "paged_decode_attention_v1": v1.get("paged_decode_attention"),
        "paged_decode_attention_v2": v2.get("paged_decode_attention"),
        "flash_prefill_attention": v1.get("flash_prefill_attention"),
        "best_window_similarity": analysis.get("best_window_similarity"),
    }
    for record in records:
        record["launches"] = path_launches[record["name"]]
        # the same kernel's launches on the checkpoint and operator phases' paths
        base = re.sub(r"_v[12]$", "", record["name"])
        record["launches_checkpoint"] = checkpoint.get(base)
        record["launches_operator"] = operator.get(base)
        record["launches_remote"] = remote.get(base)
    kernels = records
    results["kernels"] = kernels
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    results["device"] = device
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
