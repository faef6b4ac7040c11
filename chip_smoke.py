#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``operator_tpu_torch``).

    python3 chip_smoke.py [--out results.json]
        [--phases device,kernels,serve,wave,parity]

Runs on one CUDA card, from the root of a checkout; exits non-zero, and
prints no result, when no card is present or the package is missing.
Phases, in order — any failure stops the run:

1. device: the card's name and power limit (``nvidia-smi``), and the
   build of every kernel of the port from the checkout's sources (one
   ``nvcc`` per source, all started together);
2. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (tinyllama-1.1b: QH=32, KH=4, D=64, page 64,
   32 rows), bf16 and f32, tolerances stated below.  The ragged kernel
   (K1) over every geometry the scheduler produces, chunk 64, valid rows
   only; the paged decode kernel (K2/K3) at mixed lengths with full
   pages, length-1 rows, a window and released (all-zero table) rows,
   every row; the flash-prefill kernel (K4) at T in {64, 512, 2048}, B in
   {1, 8}, ragged lengths and a window, every row (bf16 tolerance about
   twice their largest measured error, not K1's looser one).  Times each kernel,
   its plain version and one PyTorch library call computing the same
   function (``scaled_dot_product_attention`` over the gathered KV, or
   with the causal+length mask; timed here only, never called by the
   port), beside the least time the card could take (``bound``);
3. serve: the continuous path at full width — tinyllama-1.1b, 22
   layers, int8 weights from a seed, 32 slots, page 64, chunk 64,
   pipeline depth 2, speculative decoding on — through the port's HTTP
   server on localhost, with concurrent ``/v1/completions`` requests of
   mixed prompt lengths, greedy and sampled.  Every kernel's launch count
   is set to 0 just before and read just after: the ragged kernel must
   have launched exactly once per layer per step, the wave kernels never;
4. wave: the wave path (``SCHED_MODE=wave``, ``DECODE_BLOCK=4``,
   ``PIPELINE_DEPTH=2``, ``OPERATOR_TPU_FLASH_PREFILL=1``) at the same
   width through the HTTP server with the same requests, driven twice,
   once with each decode-kernel selector (``OPERATOR_TPU_PAGED_KERNEL``
   ``v1``, the default, then ``v2``), each engine built anew and the
   counts set to 0 before each drive: the prefill kernel must have
   launched 22 times per prefill wave, the decode kernel 22 x 4 times per
   decode block, the ragged kernel never; every request finishes and
   every page comes back free;
5. parity: small f32 ``tiny-test`` engines on the card (kernels) and on
   the CPU (plain versions) must give the same greedy tokens — the
   continuous engine, and the wave engine with the decode selector at
   ``v1`` and ``v2`` and flash prefill on and off.

``--phases device,kernels,serve,profile`` (or ``...,wave,profile``, the
``v1`` drive) also drives that phase's requests again under
``torch.profiler`` and
prints the device time by kernel and the device's busy share (not part of
the default run).

The line before the last is one JSON object with a record per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
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

#: the serve and wave phases' requests: prompt lengths in characters and
#: the completion budget
PROMPT_CHARS = [16, 40, 100, 220, 400, 700, 1000, 1500, 64, 300]
MAX_TOKENS = 32

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


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` with a cold L2: each call is preceded by
    a write of twice the card's 50 MB L2 (outside the timed events), as
    the serving step finds a layer's pages after 21 other layers.  All
    calls are enqueued before the one synchronise, so the device does not
    wait on the host between them."""
    import torch

    flush = torch.empty(100 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
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
        "wave_decode", "wave_mixed", "wave_prefill",
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
    # the serve phase's waves in bf16; the mixed one is the record
    timings = {}
    for name in ("wave_decode", "wave_mixed", "wave_prefill"):
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
    }
    results["kernel_checks"] = checks
    results["kernel_timings"] = timings
    return record


#: the serve and wave phases' prompts in tokens (byte tokenizer: chars + BOS)
PROMPT_TOKENS = [n + 1 for n in PROMPT_CHARS]


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
            checks.append({"kernel": kind, "geometry": name, "dtype": dname,
                           "max_abs_err": err, "tol": WAVE_TOL[dname], "finite": finite})
            print(json.dumps({"kernel_check": checks[-1]}), flush=True)
            if not finite or not err <= WAVE_TOL[dname]:
                raise fail(
                    f"{kind} kernel {name}/{dname}: max_abs_err={err} (tol {WAVE_TOL[dname]})"
                )
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


def phase_serve(results: dict, kernel_modules: dict, phases: set) -> dict:
    import torch

    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine

    t0 = time.perf_counter()
    engine, model_id = build_serving_engine("cuda", SERVE_ENV, seed=0)
    config = engine.generator.config
    if (config.num_layers, config.hidden_size, config.num_heads) != (22, 2048, 32):
        raise fail(f"not tinyllama-1.1b at full width: {config}")
    engine.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
    server.start()
    sched = engine.scheduler
    url = f"http://127.0.0.1:{server.bound_port}/v1/completions"
    try:
        # one short request first so the timed drive is not a cold start
        _post(url, {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0})
        bodies = request_bodies()
        for module in kernel_modules.values():
            module.launches = 0
        steps0, dev0 = sched.steps, len(sched.device_ms)
        completion, wall = drive_requests(url, bodies)
        launches = {name: m.launches for name, m in kernel_modules.items()}
        steps = sched.steps - steps0
        device_ms = sched.device_ms[dev0:]
        # every request finished: the scheduler holds no row and no page
        deadline = time.time() + 30
        while sched.num_active and time.time() < deadline:
            time.sleep(0.05)
        accounting = sched.page_accounting()
        if accounting["row_pages"] or accounting["available"] != accounting["total"]:
            raise fail(f"page accounting not clean: {accounting}")
        if launches["ragged_paged_attention"] != config.num_layers * steps or steps == 0:
            raise fail(
                f"ragged kernel launched {launches['ragged_paged_attention']} times "
                f"over {steps} steps of {config.num_layers} layers"
            )
        others = {k: n for k, n in launches.items() if k != "ragged_paged_attention"}
        if any(others.values()):
            raise fail(f"wave kernels launched on the continuous path: {others}")
        stats = sched.stats()
        if "profile" in phases:
            results["profile"] = profile_drive(url, bodies)
        serve = {
            "model": model_id, "layers": config.num_layers, "weights": "int8",
            "slots": engine.generator.max_slots, "requests": len(bodies),
            "prompt_chars": PROMPT_CHARS, "max_tokens": MAX_TOKENS,
            "completion_tokens": completion, "wall_s": wall,
            "tokens_per_s": completion / wall, "steps": steps,
            "device_ms_per_step": sum(device_ms) / len(device_ms) if device_ms else None,
            "launches": launches, "setup_s": setup_s,
            "page_accounting": accounting,
            "spec_decode": stats["spec_decode"],
            "decode_tokens_per_host_sync": stats["decode_tokens_per_host_sync"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
        print(json.dumps({"serve": serve}), flush=True)
        results["serve"] = serve
        return launches
    finally:
        server.stop()
        engine.close()


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
            }
            if waves == 0 or blocks == 0 or launches != want:
                raise fail(
                    f"wave launches {launches} over {waves} prefill waves and "
                    f"{blocks} decode blocks; want {want}"
                )
            if "profile" in phases and selector == "v1":
                results["wave_profile"] = profile_drive(url, bodies)
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
            "pages_free": free_pages,
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
    """Drive the same requests again under ``torch.profiler``: device
    time by kernel, the device's busy share of the wall, and the host
    time of the heaviest operators.  Opt-in (``--phases ...,profile``):
    tracing slows the host, so no other number is taken in this drive."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    threads = [threading.Thread(target=_post, args=(url, body)) for body in bodies]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(900)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - started) * 1e3

    def device_us(event) -> float:
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, name):
                return float(getattr(event, name))
        return 0.0

    events = prof.key_averages()
    kernels = sorted(
        ((e.key, device_us(e) / 1e3, e.count) for e in events if device_us(e) > 0),
        key=lambda item: -item[1],
    )
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
# phase 4: card vs CPU on a small engine
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
            return [r.token_ids for r in engine.generate(prompts, sampling)]
        finally:
            engine.close()

    tokens = {device: run(device, wave=False) for device in ("cuda", "cpu")}
    if tokens["cuda"] != tokens["cpu"]:
        raise fail(f"greedy tokens differ card vs CPU: {tokens}")
    results["parity"] = {"prompts": len(prompts), "tokens": tokens["cuda"]}
    print(json.dumps({"parity": "ok", "tokens": tokens["cuda"]}), flush=True)

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


# ---------------------------------------------------------------------------


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every result to this JSON file")
    parser.add_argument("--phases", default="device,kernels,serve,wave,parity")
    args = parser.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from operator_tpu_torch.ops import _build
        from operator_tpu_torch.ops import flash_prefill, paged_attention, ragged_attention
    except ImportError as exc:
        print(f"chip_smoke: the operator_tpu_torch package is missing: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernel_modules = {
        "ragged_paged_attention": ragged_attention,
        "paged_decode_attention": paged_attention,
        "flash_prefill_attention": flash_prefill,
    }
    card = card_line()
    print(card, flush=True)
    results: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    started = time.perf_counter()
    _build.build_all()
    results["build_s"] = time.perf_counter() - started
    print(json.dumps({"build_s": results["build_s"], "sources": _build.source_names()}), flush=True)

    records = []
    if "kernels" in phases:
        records = [phase_kernels(results)] + phase_wave_kernels(results)
    launches = phase_serve(results, kernel_modules, phases) if "serve" in phases else {}
    wave_launches = {
        selector: phase_wave(results, kernel_modules, phases, selector)
        for selector in (("v1", "v2") if "wave" in phases else ())
    }
    if "parity" in phases:
        phase_parity(results, kernel_modules)
    # each kernel's count from the drive of the path it serves: K1 the
    # continuous serve phase, the decode kernel the wave drive under its
    # own selector value, the prefill kernel the default (v1) wave drive
    v1, v2 = wave_launches.get("v1", {}), wave_launches.get("v2", {})
    path_launches = {
        "ragged_paged_attention": launches.get("ragged_paged_attention"),
        "paged_decode_attention_v1": v1.get("paged_decode_attention"),
        "paged_decode_attention_v2": v2.get("paged_decode_attention"),
        "flash_prefill_attention": v1.get("flash_prefill_attention"),
    }
    for record in records:
        record["launches"] = path_launches[record["name"]]
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
