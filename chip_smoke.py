#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``operator_tpu_torch``).

    python3 chip_smoke.py [--out results.json]
        [--phases device,kernels,serve,wave,analysis,checkpoint,parity]

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
   query x 2,048 incidents; D = 384), scores and the plain score at the
   chosen window, and exact first indices where window rows repeat; and
   the K5 wrapper's host time per call, part by part.
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
7. parity: small f32 ``tiny-test`` engines on the card (kernels) and on
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
    server.start()
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
        }
        print(json.dumps({"serve": serve}), flush=True)
        results["serve"] = serve
        return launches
    finally:
        server.stop()
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
    server.start()
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
        server.stop()
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
        server.start()
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
        finally:
            server.stop()
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
            tasks = [asyncio.ensure_future(provider.generate(r)) for r in requests]
            while (engine._submissions.qsize() < len(requests)
                   and not any(t.done() for t in tasks)):
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


def phase_checkpoint(results: dict, kernel_modules: dict) -> dict:
    """A tinyllama-1.1b checkpoint written at full width from the serve
    phase's seeded weights, loaded back with int8 weights through
    ``build_tpu_native_provider`` and driven with ten analysis requests;
    then a MiniLM-width encoder checkpoint through ``build_embedder`` and
    ``PatternEngine.analyze``.  Returns the kernels' launch counts summed
    over the provider drive and the long analysis."""
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
        steps0 = sched.steps
        started = time.perf_counter()
        responses, launches = counted(lambda: gated_drive(provider, requests))
        wall = time.perf_counter() - started
        steps = sched.steps - steps0
        wait_idle(sched)
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
        return total
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 7: card vs CPU on a small engine
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
    parser.add_argument("--phases", default="device,kernels,serve,wave,analysis,checkpoint,parity")
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
    checkpoint = phase_checkpoint(results, kernel_modules) if "checkpoint" in phases else {}
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
        # the same kernel's launches on the checkpoint phase's path
        record["launches_checkpoint"] = checkpoint.get(re.sub(r"_v[12]$", "", record["name"]))
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
