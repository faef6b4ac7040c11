"""The PyTorch port's attention ops against the JAX package's.

Inputs are drawn once with numpy from a seed and fed to both packages.
The port's ``ragged_attention_reference`` (its CPU path and the oracle of
the CUDA kernel) is held to the JAX Pallas kernel run in interpret mode
and to the JAX dense reference, across every geometry the scheduler
produces; decode rows also to both packages' ``paged_attention_reference``;
``write_tokens`` to the JAX scatter.  f32 throughout, atol 1e-5 (the two
packages sum in different orders), valid rows only (padding rows are
don't-care by contract).  A numpy model of the bf16 CUDA kernel's
split-KV arithmetic (its stages, its split rule, the -1e30 mask and the
merge by exp2(m_s - m_max)) is held to the JAX dense reference on the
same geometries and on long rows cut into the kernel's 8 splits.

The wave engine's ops: the port's ``paged_attention`` (the plain version
on the CPU) against both JAX Pallas decode kernels (v1 and v2) in
interpret mode, with windows and in bf16; ``flash_prefill_reference``
against the JAX Pallas prefill kernel in interpret mode on every row,
padded query rows included, with windows and non-default JAX blocks;
``flash_prefill_supported`` against the JAX gate.

The semantic path's similarity: the port's ``best_window_scores`` (the
plain version on the CPU) against the JAX dense reference and the JAX
Pallas best-window kernel in interpret mode, at ``tests/test_ops.py``'s
shapes, one query against many patterns, duplicated window rows and in
bf16; ``top_k_windows`` against JAX.  Tolerances are stated per test.
The CUDA kernels themselves are compared with the plain versions on the
card by ``tests/test_torch_kernels.py``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

# operator_tpu.ops re-exports functions under the modules' names
jax_paged = importlib.import_module("operator_tpu.ops.paged_attention")
jax_ragged = importlib.import_module("operator_tpu.ops.ragged_attention")
jax_flash = importlib.import_module("operator_tpu.ops.flash_prefill")
jax_similarity = importlib.import_module("operator_tpu.ops.similarity")
from operator_tpu_torch.ops import flash_prefill  # noqa: E402
# the module: the package's ``paged_attention`` is the function, as in JAX
paged = importlib.import_module("operator_tpu_torch.ops.paged_attention")
from operator_tpu_torch.ops import ragged_attention as ragged  # noqa: E402
from operator_tpu_torch.ops import similarity  # noqa: E402

ATOL = 1e-5
B, C, QH, KH, D, PAGE, PPS = 4, 8, 4, 2, 16, 8, 6

#: name -> (kv_len, q_count, sliding_window), the tests/test_sched.py cases
#: plus spec-verify rows, idle rows and kv lengths off the page grid
GEOMETRIES = {
    "prefill_only": ([8, 5, 8, 3], [8, 5, 8, 3], None),
    "decode_only": ([17, 30, 9, 1], [1, 1, 1, 1], None),
    "mixed": ([17, 20, 8, 0], [1, 6, 8, 0], None),
    "window": ([33, 20, 8, 12], [1, 6, 8, 1], 7),
    "spec_verify": ([21, 14, 40, 6], [5, 3, 2, 5], None),
    "q_count_0": ([17, 30, 9, 25], [0, 1, 0, 4], None),
    "ragged_kv_len": ([13, 27, 46, 7], [3, 1, 8, 7], 11),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    num_pages = B * PPS + 1
    q = rng.normal(size=(B, C, QH, D)).astype(np.float32)
    k_pages = rng.normal(size=(num_pages, PAGE, KH, D)).astype(np.float32)
    v_pages = rng.normal(size=(num_pages, PAGE, KH, D)).astype(np.float32)
    table = (1 + rng.permutation(num_pages - 1)[: B * PPS]).reshape(B, PPS).astype(np.int32)
    return q, k_pages, v_pages, table


def _assert_valid_rows_close(got, want, q_count):
    for row, n in enumerate(q_count):
        np.testing.assert_allclose(got[row, :n], want[row, :n], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_ragged_reference_matches_jax_kernel_and_reference(name):
    kv_len, q_count, window = GEOMETRIES[name]
    q, k_pages, v_pages, table = _inputs(sum(map(ord, name)))
    kv = np.asarray(kv_len, np.int32)
    cnt = np.asarray(q_count, np.int32)
    jax_args = tuple(jnp.asarray(a) for a in (q, k_pages, v_pages, table, kv, cnt))
    pallas = np.asarray(jax_ragged._ragged_attention_pallas(
        *jax_args, interpret=True, sliding_window=window,
    ))
    dense = np.asarray(jax_ragged.ragged_attention_reference(
        *jax_args, sliding_window=window,
    ))
    ours = ragged.ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, k_pages, v_pages, table, kv, cnt)),
        sliding_window=window,
    )
    assert ours.dtype == torch.float32 and ours.shape == (B, C, QH, D)
    assert torch.isfinite(ours).all()
    ours = ours.numpy()
    _assert_valid_rows_close(ours, pallas, q_count)
    _assert_valid_rows_close(ours, dense, q_count)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_rows_match_paged_attention_references(window):
    """A q_count == 1 ragged row is the decode case: equal to both
    packages' dedicated decode oracle."""
    q, k_pages, v_pages, table = _inputs(11)
    kv = np.asarray([17, 30, 9, 2], np.int32)
    cnt = np.ones(B, np.int32)
    t = [torch.from_numpy(a) for a in (q, k_pages, v_pages, table, kv, cnt)]
    ours_ragged = ragged.ragged_attention_reference(*t, sliding_window=window).numpy()
    ours_decode = paged.paged_attention_reference(
        t[0][:, 0], t[1], t[2], t[3], t[4], sliding_window=window,
    ).numpy()
    jax_decode = np.asarray(jax_paged.paged_attention_reference(
        jnp.asarray(q[:, 0]), jnp.asarray(k_pages), jnp.asarray(v_pages),
        jnp.asarray(table), jnp.asarray(kv), sliding_window=window,
    ))
    np.testing.assert_allclose(ours_decode, jax_decode, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours_ragged[:, 0], jax_decode, rtol=0, atol=ATOL)


_NEG_INF = np.float32(-1e30)


def _walk(q_rows, pos, keys, values, begin, end, window, stage):
    """One block's walk of KV positions [begin, end) in stages, as the bf16
    kernel walks them: scores in base 2, masked entries at -1e30 (positions
    past ``end`` in the last stage are zero rows, masked), the online
    softmax state per row.  Returns the partial (m, l, acc)."""
    rows, d = q_rows.shape
    scale_log2 = np.float32(d ** -0.5 * np.log2(np.e))
    m = np.full(rows, _NEG_INF, np.float32)
    l = np.zeros(rows, np.float32)
    acc = np.zeros((rows, d), np.float32)
    for start in range(begin, end, stage):
        t = np.arange(start, start + stage)
        inside = t < end
        k = np.where(inside[:, None], keys[np.minimum(t, len(keys) - 1)], 0)
        v = np.where(inside[:, None], values[np.minimum(t, len(values) - 1)], 0)
        live = (t[None] <= pos[:, None]) & inside[None]
        if window is not None:
            live &= t[None] > pos[:, None] - window
        s = np.where(live, (q_rows @ k.T) * scale_log2, _NEG_INF).astype(np.float32)
        m_new = np.maximum(m, s.max(axis=1))
        alpha = np.exp2(m - m_new)
        p = np.exp2(s - m_new[:, None])
        l = alpha * l + p.sum(axis=1)
        acc = alpha[:, None] * acc + p @ v
        m = m_new
    return m, l, acc


def split_merge_model(q, k_pages, v_pages, table, kv_len, q_count, window,
                      n_splits, split_keys, stage=ragged.STAGE_KEYS,
                      tile_rows=ragged.TILE_ROWS):
    """The bf16 ragged kernel's arithmetic in f32 numpy: tiles of
    ``tile_rows`` flash rows, each tile's span (window start aligned down
    to a stage, causal and kv_len end), tile 0 cut into ``n_splits`` spans
    of ``split_keys`` (the last unbounded, empty ones skipped), and the
    merge weighting each split by exp2(m_s - m_max)."""
    b_, c, qh, d = q.shape
    kh = k_pages.shape[2]
    g = qh // kh
    out = np.zeros_like(q)
    for b in range(b_):
        count, seq = int(q_count[b]), int(kv_len[b])
        if count <= 0:
            continue
        q_base = seq - count
        keys = k_pages[table[b]].reshape(-1, kh, d)
        values = v_pages[table[b]].reshape(-1, kh, d)
        for row0 in range(0, min(count * g, c * g), tile_rows):
            rows = np.arange(row0, min(row0 + tile_rows, count * g, c * g))
            tok0, tok_last = row0 // g, min((row0 + tile_rows - 1) // g, count - 1)
            end = min(seq, q_base + tok_last + 1)
            begin = 0 if window is None else max(q_base + tok0 - window + 1, 0)
            begin -= begin % stage
            spans = [(begin, end)]
            if row0 == 0 and n_splits > 1:
                spans = [(max(begin, s * split_keys),
                          min(end, (s + 1) * split_keys) if s + 1 < n_splits else end)
                         for s in range(n_splits)]
                spans = [(lo, hi) for lo, hi in spans if hi > lo]
            pos = q_base + rows // g
            for h in range(kh):
                q_rows = q[b, rows // g, h * g + rows % g]
                parts = [_walk(q_rows, pos, keys[:, h], values[:, h], lo, hi, window, stage)
                         for lo, hi in spans]
                m_max = np.max([m for m, _, _ in parts], axis=0)
                l = np.zeros(len(rows), np.float32)
                acc = np.zeros((len(rows), d), np.float32)
                for m_s, l_s, acc_s in parts:
                    w = np.exp2(m_s - m_max)
                    l += w * l_s
                    acc += w[:, None] * acc_s
                out[b, rows // g, h * g + rows % g] = acc / np.maximum(l, 1e-30)[:, None]
    return out


#: (stage, split_keys): the kernel's constants, and small ones that cut the
#: seven geometries' short rows into many stages and splits (with tiles of
#: 4 flash rows, so tiles past tile 0 are walked whole beside the splits)
SPLIT_RULES = [(ragged.STAGE_KEYS, ragged.SPLIT_KEYS), (4, 8), (8, 8)]


@pytest.mark.parametrize("rule", SPLIT_RULES, ids=lambda r: f"stage{r[0]}_split{r[1]}")
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_split_merge_model_matches_jax_reference(name, rule):
    """The split-and-merge arithmetic of the bf16 kernel (in f32, P not
    rounded) equals the JAX dense reference on the valid rows: splitting
    tile 0 and merging by exp2(m_s - m_max) changes nothing but the
    order of the sums."""
    stage, split_keys = rule
    kv_len, q_count, window = GEOMETRIES[name]
    q, k_pages, v_pages, table = _inputs(sum(map(ord, name)))
    n_splits = -(-PPS * PAGE // split_keys)
    got = split_merge_model(q, k_pages, v_pages, table, np.asarray(kv_len),
                            np.asarray(q_count), window, n_splits, split_keys,
                            stage=stage, tile_rows=4)
    want = np.asarray(jax_ragged.ragged_attention_reference(
        *(jnp.asarray(a) for a in (q, k_pages, v_pages, table,
                                   np.asarray(kv_len, np.int32), np.asarray(q_count, np.int32))),
        sliding_window=window,
    ))
    _assert_valid_rows_close(got, want, q_count)


#: one long row per case at page 16 and 128 pages (2,048 positions; the
#: kernel's plan: 8 splits of 256): a decode row filling the cache, a
#: verify row whose first query sits at the last position of split 3 (split
#: 4 is all masked for it: m = -1e30 with l > 0), a verify row whose window
#: empties splits 0-5, and a row one past a split edge
LONG_ROWS = {
    "decode_2048": (2048, 1, None),
    "verify_masked_split": (1024 + 3, 4, None),
    "window_empties_splits": (2048, 5, 300),
    "split_edge_plus_one": (257, 2, None),
}


@pytest.mark.parametrize("name", list(LONG_ROWS))
def test_split_merge_model_matches_jax_reference_on_a_long_row(name):
    seq, count, window = LONG_ROWS[name]
    page, pps, c, qh, kh, d = 16, 128, 8, 8, 2, 16
    rng = np.random.default_rng(seq + count)
    q = rng.normal(size=(1, c, qh, d)).astype(np.float32)
    k_pages = rng.normal(size=(pps + 1, page, kh, d)).astype(np.float32)
    v_pages = rng.normal(size=(pps + 1, page, kh, d)).astype(np.float32)
    table = (1 + rng.permutation(pps))[None].astype(np.int32)
    kv_len, q_count = np.asarray([seq], np.int32), np.asarray([count], np.int32)
    plan = ragged.launch_plan(
        torch.empty((1, c, qh, d), dtype=torch.bfloat16, device="meta"),
        torch.empty(k_pages.shape, dtype=torch.bfloat16, device="meta"),
        torch.empty(table.shape, dtype=torch.int32, device="meta"),
    )
    assert (plan.n_splits, plan.split_keys) == (8, 256)
    got = split_merge_model(q, k_pages, v_pages, table, kv_len, q_count, window,
                            plan.n_splits, plan.split_keys)
    want = np.asarray(jax_ragged.ragged_attention_reference(
        *(jnp.asarray(a) for a in (q, k_pages, v_pages, table, kv_len, q_count)),
        sliding_window=window,
    ))
    _assert_valid_rows_close(got, want, q_count)


@pytest.mark.parametrize("with_valid_len", [False, True])
@pytest.mark.parametrize("past_table", [False, True], ids=["in_table", "past_table"])
def test_write_tokens_matches_jax(with_valid_len, past_table):
    """``past_table``: row 3's writes run past the end of its page table
    (positions 46..50 of a 48-slot table), as a finished wave slot's
    decode-ahead can; JAX drops them, the port sends them to the trash
    page, and every real page ends the same."""
    rng = np.random.default_rng(3)
    num_pages = B * PPS + 1
    pages = rng.normal(size=(num_pages, PAGE, KH, D)).astype(np.float32)
    _, _, _, table = _inputs(4)
    new = rng.normal(size=(B, 5, KH, D)).astype(np.float32)
    start = np.asarray([0, 7, 13, 46 if past_table else 30], np.int32)
    valid_len = np.asarray([5, 2, 0, 4], np.int32) if with_valid_len else None
    want = np.asarray(jax_paged.write_tokens(
        jnp.asarray(pages), jnp.asarray(table), jnp.asarray(new),
        jnp.asarray(start),
        None if valid_len is None else jnp.asarray(valid_len),
    ))
    ours = torch.from_numpy(pages.copy())
    out = paged.write_tokens(
        ours, torch.from_numpy(table), torch.from_numpy(new),
        torch.from_numpy(start),
        None if valid_len is None else torch.from_numpy(valid_len),
    )
    assert out is ours  # in place
    # the trash page 0 takes every padding write in an unspecified order
    np.testing.assert_array_equal(ours.numpy()[1:], want[1:])
    if not (with_valid_len or past_table):
        np.testing.assert_array_equal(ours.numpy()[0], want[0])


def test_paged_cache_layout():
    cache = paged.PagedKVCache.create(3, 9, PAGE, KH, D, B, PPS, dtype=torch.float32,
                                      device="cpu")
    assert cache.k_pages.shape == (3, 9, PAGE, KH, D)
    assert cache.page_table.dtype == torch.int32 and cache.page_table.shape == (B, PPS)
    assert cache.lengths.shape == (B,) and cache.page_size == PAGE



# ---------------------------------------------------------------------------
# the wave engine's decode attention and flash prefill
# ---------------------------------------------------------------------------

#: name -> (batch, qh, kh, d, page, pages_per_seq, lengths, window); the
#: tests/test_ops.py decode shapes plus windows, a length-1 row, full pages
#: and a released slot (row 2: an all-zero table row at length 1)
DECODE_CASES = {
    "gqa4": (2, 8, 2, 32, 16, 4, [10, 64], None),
    "mha": (3, 4, 4, 32, 8, 3, [1, 24, 17], None),
    "gqa8_released": (3, 16, 2, 16, 8, 4, [5, 32, 1], None),
    "window8": (3, 8, 2, 32, 16, 4, [10, 40, 64], 8),
    "window24": (3, 8, 2, 32, 16, 4, [10, 40, 64], 24),
    "window_mid_split": (3, 8, 2, 32, 16, 4, [37, 61, 1], 13),
}


def _decode_inputs(name, dtype=np.float32):
    batch, qh, kh, d, page, pps, lengths, window = DECODE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    num_pages = batch * pps + 1
    q = rng.normal(size=(batch, qh, d)).astype(np.float32)
    k_pages = rng.normal(size=(num_pages, page, kh, d)).astype(np.float32)
    v_pages = rng.normal(size=(num_pages, page, kh, d)).astype(np.float32)
    table = (1 + np.arange(batch * pps, dtype=np.int32)).reshape(batch, pps)
    if name.endswith("_released"):
        table[2] = 0
    lens = np.asarray(lengths, np.int32)
    return (q, k_pages, v_pages, table, lens), window


@pytest.mark.parametrize("impl", ["v1", "v2"])
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_paged_attention_matches_jax_decode_kernels(name, impl):
    """f32, atol 1e-5: the two packages sum in different orders."""
    arrays, window = _decode_inputs(name)
    kernel = {
        "v1": jax_paged._paged_attention_pallas,
        "v2": jax_paged._paged_attention_pallas_v2,
    }[impl]
    want = np.asarray(kernel(*map(jnp.asarray, arrays), interpret=True,
                             sliding_window=window))
    before = paged.launches
    got = paged.paged_attention(*map(torch.from_numpy, arrays), sliding_window=window)
    assert paged.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and got.shape == arrays[0].shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    reference = np.asarray(jax_paged.paged_attention_reference(
        *map(jnp.asarray, arrays), sliding_window=window))
    np.testing.assert_allclose(got.numpy(), reference, rtol=0, atol=ATOL)


@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_paged_attention_bf16_matches_jax_decode_kernels(impl):
    """bf16 q and pages, atol 5e-2 (the JAX tests' bf16 tolerance): the
    plain version rounds the probabilities to bf16 before P.V, the
    Pallas kernels keep them in f32 until the end."""
    arrays, window = _decode_inputs("gqa4")
    bf16 = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:3]] + [
        jnp.asarray(a) for a in arrays[3:]
    ]
    kernel = {
        "v1": jax_paged._paged_attention_pallas,
        "v2": jax_paged._paged_attention_pallas_v2,
    }[impl]
    want = np.asarray(kernel(*bf16, interpret=True), np.float32)
    t = [torch.from_numpy(a) for a in arrays]
    got = paged.paged_attention(
        *(x.to(torch.bfloat16) for x in t[:3]), *t[3:], sliding_window=window
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=5e-2)


def decode_split_model(q, k_pages, v_pages, table, lengths, window, n_splits,
                       split_keys, stage=ragged.STAGE_KEYS):
    """The bf16 decode kernel's arithmetic in f32 numpy (P not rounded):
    each row's live span (the window's start aligned down to a stage, the
    row's length clipped to the table), cut into ``n_splits`` spans of
    ``split_keys``; the splits holding keys each walked in stages with the
    -1e30 mask (``_walk``: a decode row is a query at position length - 1),
    then merged in split order by exp2(m_s - m_max), or, for a row whose
    span lies in one split, normalised directly."""
    b_, qh, d = q.shape
    page, kh = k_pages.shape[1], k_pages.shape[2]
    g = qh // kh
    end_max = table.shape[1] * page
    out = np.zeros_like(q)
    for b in range(b_):
        seq = int(lengths[b])
        end = min(seq, end_max)
        window_lo = max(seq - window, 0) if window else 0
        begin = window_lo - window_lo % stage
        if n_splits > 1:
            s_lo = min(min(begin, end) // split_keys, n_splits - 1)
            s_hi = min((end - 1) // split_keys, n_splits - 1) if end > begin else s_lo
            spans = [(max(begin, s * split_keys), min(end, (s + 1) * split_keys))
                     for s in range(s_lo, s_hi + 1)]
        else:
            spans = [(begin, end)]
        keys = k_pages[table[b]].reshape(-1, kh, d)
        values = v_pages[table[b]].reshape(-1, kh, d)
        pos = np.full(g, seq - 1)
        for h in range(kh):
            q_rows = q[b, h * g:(h + 1) * g]
            parts = [_walk(q_rows, pos, keys[:, h], values[:, h], lo, hi, window, stage)
                     for lo, hi in spans]
            m_max = np.max([m for m, _, _ in parts], axis=0)
            l = np.zeros(g, np.float32)
            acc = np.zeros((g, d), np.float32)
            for m_s, l_s, acc_s in parts:
                w = np.float32(1) if len(parts) == 1 else np.exp2(m_s - m_max)
                l += w * l_s
                acc += w * acc_s if np.ndim(w) == 0 else w[:, None] * acc_s
            out[b, h * g:(h + 1) * g] = acc / np.maximum(l, 1e-30)[:, None]
    return out


def _decode_split_rules(max_seq):
    """(stage, n_splits, split_keys): the kernel's own plan for this table,
    and small rules that cut short rows into many stages and splits."""
    return [(ragged.STAGE_KEYS, *ragged.split_plan(max_seq)),
            (4, -(-max_seq // 8), 8), (8, -(-max_seq // 8), 8), (4, -(-max_seq // 12), 12)]


@pytest.mark.parametrize("rule", [0, 1, 2, 3], ids=["kernel", "stage4_split8",
                                                    "stage8_split8", "stage4_split12"])
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_split_model_matches_jax_decode_kernels(name, rule):
    """The bf16 decode kernel's split-and-merge arithmetic (in f32, P not
    rounded) equals both JAX Pallas decode kernels in interpret mode and
    the JAX reference, atol 1e-5: splitting a row and merging by
    exp2(m_s - m_max) changes only the order of the sums.  The cases hold
    rows of length 1, a released row, full pages and windows starting
    inside a split."""
    arrays, window = _decode_inputs(name)
    max_seq = arrays[3].shape[1] * arrays[1].shape[1]
    stage, n_splits, split_keys = _decode_split_rules(max_seq)[rule]
    got = decode_split_model(*arrays, window, n_splits, split_keys, stage=stage)
    for kernel in (jax_paged._paged_attention_pallas, jax_paged._paged_attention_pallas_v2):
        want = np.asarray(kernel(*map(jnp.asarray, arrays), interpret=True,
                                 sliding_window=window))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    reference = np.asarray(jax_paged.paged_attention_reference(
        *map(jnp.asarray, arrays), sliding_window=window))
    np.testing.assert_allclose(got, reference, rtol=0, atol=ATOL)


#: long decode rows at page 16 and 128 pages (2,048 positions; the
#: kernel's plan: 8 splits of 256): name -> (lengths, window).  Rows fill
#: the cache, sit one past and at a split edge, hold one key, and (with
#: the window) start inside split 6, 4 and 0
LONG_DECODE_ROWS = {
    "no_window": ([2048, 257, 256, 1, 1000, 1537], None),
    "window300": ([2048, 1300, 700, 1, 260, 1024], 300),
}


@pytest.mark.parametrize("name", list(LONG_DECODE_ROWS))
def test_decode_split_model_matches_jax_reference_on_long_rows(name):
    lengths, window = LONG_DECODE_ROWS[name]
    b, page, pps, qh, kh, d = len(lengths), 16, 128, 8, 2, 16
    rng = np.random.default_rng(len(name))
    q = rng.normal(size=(b, qh, d)).astype(np.float32)
    k_pages = rng.normal(size=(b * pps + 1, page, kh, d)).astype(np.float32)
    v_pages = rng.normal(size=(b * pps + 1, page, kh, d)).astype(np.float32)
    table = (1 + rng.permutation(b * pps)).reshape(b, pps).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    plan = paged.launch_plan(
        torch.empty(q.shape, dtype=torch.bfloat16, device="meta"),
        torch.empty(k_pages.shape, dtype=torch.bfloat16, device="meta"),
        torch.empty(table.shape, dtype=torch.int32, device="meta"),
    )
    assert (plan.n_splits, plan.split_keys) == (8, 256)
    got = decode_split_model(q, k_pages, v_pages, table, lens, window,
                             plan.n_splits, plan.split_keys)
    want = np.asarray(jax_paged.paged_attention_reference(
        *map(jnp.asarray, (q, k_pages, v_pages, table, lens)), sliding_window=window))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_decode_launch_plan_is_a_function_of_shapes():
    """The decode kernel's split plan reads shapes and dtype only: meta
    tensors (no data, nothing to read) give it, and tinyllama's wave
    shapes (B=32, QH=32, KH=4, D=64, 32 pages of 64) give 8 splits of 256
    positions, 2.1 MB of scratch and one counter per (row, KV head)."""
    bf16, i32 = torch.bfloat16, torch.int32
    plan = paged.launch_plan(_meta((32, 32, 64), bf16), _meta((1025, 64, 4, 64), bf16),
                             _meta((32, 32), i32))
    assert plan == paged.LaunchPlan(8, 256, (32, 4, 8, 8, 64), (32, 4, 8, 8, 2), 128)
    assert 4 * (np.prod(plan.acc_shape) + np.prod(plan.ml_shape)) == 2_162_688
    # the same shapes with data, whatever lengths holds: the same plan
    arrays, _ = _decode_inputs("gqa4")
    t = [torch.from_numpy(a) for a in arrays]
    q, k_pages = t[0].to(bf16), t[1].to(bf16)
    for pps in (4, 128):
        table = torch.zeros((q.shape[0], pps), dtype=i32)
        want = paged.launch_plan(_meta(q.shape, bf16), _meta(k_pages.shape, bf16),
                                 _meta(table.shape, i32))
        assert paged.launch_plan(q, k_pages, table) == want
    # K1's rule: page 16 x 128 pages 8 splits; page 96 x 22 pages 9;
    # short tables and f32 not cut; at most 16 splits
    split = paged.launch_plan(q, k_pages, torch.zeros((2, 128), dtype=i32))
    assert (split.n_splits, split.split_keys) == (8, 256)
    split = paged.launch_plan(q, _meta((9, 96, 2, 32), bf16), _meta((2, 22), i32))
    assert (split.n_splits, split.split_keys) == (9, 256)
    assert paged.launch_plan(q, k_pages, torch.zeros((2, 16), dtype=i32)) == paged.LaunchPlan(1, 0)
    assert paged.launch_plan(q.float(), k_pages.float(),
                             torch.zeros((2, 128), dtype=i32)) == paged.LaunchPlan(1, 0)
    long = paged.launch_plan(q, k_pages, _meta((2, 4096), i32))
    assert (long.n_splits, long.split_keys) == (16, 4096)
    assert (long.n_splits, long.split_keys) == ragged.split_plan(4096 * 16)


def test_kernel_version_selector(monkeypatch):
    monkeypatch.delenv("OPERATOR_TPU_PAGED_KERNEL", raising=False)
    assert paged._kernel_version() == jax_paged._kernel_version() == "v1"
    for value in ("v2", " V1 "):
        monkeypatch.setenv("OPERATOR_TPU_PAGED_KERNEL", value)
        assert paged._kernel_version() == jax_paged._kernel_version()
    monkeypatch.setenv("OPERATOR_TPU_PAGED_KERNEL", "v3")
    with pytest.raises(ValueError, match="v3"):
        paged._kernel_version()
    assert paged._kernel_version({"OPERATOR_TPU_PAGED_KERNEL": "v2"}) == "v2"


#: name -> (b, t, qh, kh, d, lengths, window, jax q_block, jax kv_block)
PREFILL_CASES = {
    "ragged": (2, 128, 8, 2, 32, [128, 40], None, 128, 128),
    "len1": (3, 64, 4, 4, 16, [1, 50, 64], None, 128, 128),
    "gqa8": (1, 64, 16, 2, 16, [50], None, 128, 128),
    "window16": (2, 128, 8, 2, 16, [128, 90], 16, 128, 128),
    "window100": (2, 128, 8, 2, 16, [128, 90], 100, 128, 128),
    "small_blocks": (2, 128, 8, 4, 16, [77, 128], None, 32, 64),
    "window_small_blocks": (2, 128, 4, 2, 16, [128, 70], 24, 32, 32),
}


def _prefill_inputs(name):
    b, t, qh, kh, d, lengths, *_ = PREFILL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return (
        rng.normal(size=(b, t, qh, d)).astype(np.float32),
        rng.normal(size=(b, t, kh, d)).astype(np.float32),
        rng.normal(size=(b, t, kh, d)).astype(np.float32),
        np.asarray(lengths, np.int32),
    )


def _rows_with_a_live_key(lengths, t, window):
    """[B, T] bool: query rows whose mask admits at least one key.  A
    padded row past ``length + window - 1`` has none; there the plain
    versions of both packages give the uniform softmax over all T keys,
    while the Pallas kernel averages only the key blocks it walked, so
    the kernel is compared on the other rows only."""
    q_pos = np.arange(t)[None, :]
    lengths = np.asarray(lengths)[:, None]
    live = lengths > 0
    if window is not None:
        live = live & (q_pos < lengths + window - 1)
    return np.broadcast_to(live, (lengths.shape[0], t))


@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_flash_prefill_reference_matches_jax_kernel(name):
    """f32, atol 2e-4 (the JAX test's tolerance for its kernel against its
    reference) on every row with a live key, padded query rows included;
    atol 1e-5 against the JAX reference on every row."""
    *_, window, q_block, kv_block = PREFILL_CASES[name]
    arrays = _prefill_inputs(name)
    want = np.asarray(jax_flash._flash_prefill_pallas(
        *map(jnp.asarray, arrays), sliding_window=window, q_block=q_block,
        kv_block=kv_block, interpret=True,
    ))
    jax_reference = np.asarray(jax_flash.flash_prefill_reference(
        *map(jnp.asarray, arrays), sliding_window=window))
    before = flash_prefill.launches
    got = flash_prefill.flash_prefill_attention(
        *map(torch.from_numpy, arrays), sliding_window=window
    )
    assert flash_prefill.launches == before  # CPU tensors take the plain version
    b, t, qh, _, d = PREFILL_CASES[name][:5]
    assert got.shape == (b, t, qh * d) and got.dtype == torch.float32
    live = _rows_with_a_live_key(arrays[3], t, window)
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), jax_reference, rtol=0, atol=1e-5)


def test_flash_prefill_reference_bf16_matches_jax_kernel():
    """bf16, JAX blocks 32/64, atol 5e-2 (the JAX test's bf16 tolerance)."""
    arrays = _prefill_inputs("small_blocks")
    bf16 = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:3]]
    want = np.asarray(jax_flash._flash_prefill_pallas(
        *bf16, jnp.asarray(arrays[3]), q_block=32, kv_block=64, interpret=True,
    ), np.float32)
    t = [torch.from_numpy(a) for a in arrays]
    got = flash_prefill.flash_prefill_attention(
        *(x.to(torch.bfloat16) for x in t[:3]), t[3]
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=5e-2)


@pytest.mark.parametrize("t,s,offset", [
    (128, 128, 0), (64, 64, 0), (100, 100, 0), (2048, 2048, 0), (128, 1024, 0),
    (1, 1, 0), (2, 2, 0), (192, 192, 0), (256, 256, 1), (128, 128, "tensor"),
])
def test_flash_prefill_supported_matches_jax_gate(t, s, offset):
    jax_offset = jnp.zeros((2,), jnp.int32) if offset == "tensor" else offset
    ours_offset = torch.zeros(2, dtype=torch.int32) if offset == "tensor" else offset
    assert flash_prefill.flash_prefill_supported(t, s, ours_offset) == (
        jax_flash.flash_prefill_supported(t, s, jax_offset)
    )


def test_flash_prefill_enabled_reads_the_jax_gate(monkeypatch):
    monkeypatch.delenv("OPERATOR_TPU_FLASH_PREFILL", raising=False)
    assert not flash_prefill.flash_prefill_enabled()
    for value in ("1", "0", "true", " 1 "):
        monkeypatch.setenv("OPERATOR_TPU_FLASH_PREFILL", value)
        assert flash_prefill.flash_prefill_enabled() == jax_flash.flash_prefill_enabled()


# ---------------------------------------------------------------------------
# best-window similarity (the semantic path and incident recall)
# ---------------------------------------------------------------------------

#: name -> (windows, patterns, dim): tests/test_ops.py's shapes, one query
#: against many incidents (W = 1), and windows off the 64-row tile
SIMILARITY_CASES = {
    "tiny": (7, 5, 128),
    "two_blocks": (300, 64, 128),
    "wide": (513, 200, 384),
    "one": (1, 1, 128),
    "recall": (1, 300, 128),
    "duplicated": (300, 30, 64),
}


def _unit_rows(rng, rows, dim):
    x = rng.normal(size=(rows, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _similarity_inputs(name):
    w, p, d = SIMILARITY_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    windows, patterns = _unit_rows(rng, w, d), _unit_rows(rng, p, d)
    if name == "duplicated":
        # pattern j is a copy of window 7 j, which appears again at 7 j + 1
        # and at 299 - j: the first copy is the only right answer
        for j in range(p):
            windows[7 * j + 1] = windows[299 - j] = windows[7 * j]
            patterns[j] = windows[7 * j]
    return windows, patterns


@pytest.mark.parametrize("name", list(SIMILARITY_CASES))
def test_best_window_scores_match_jax_kernel_and_reference(name):
    """f32: scores within 1e-5 of the JAX reference and of the Pallas kernel
    in interpret mode (the packages sum in different orders); indices
    equal to the JAX reference's (its first match)."""
    windows, patterns = _similarity_inputs(name)
    ref_s, ref_i = jax_similarity.best_window_scores_reference(
        jnp.asarray(windows), jnp.asarray(patterns))
    pallas_s, pallas_i = jax_similarity._best_window_pallas(
        jnp.asarray(windows), jnp.asarray(patterns), interpret=True)
    before = similarity.launches
    got_s, got_i = similarity.best_window_scores(
        torch.from_numpy(windows), torch.from_numpy(patterns))
    assert similarity.launches == before  # CPU tensors take the plain version
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    assert got_s.shape == got_i.shape == (patterns.shape[0],)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(pallas_s), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    if name == "duplicated":
        np.testing.assert_array_equal(got_i.numpy(), 7 * np.arange(patterns.shape[0]))
        np.testing.assert_array_equal(np.asarray(pallas_i), got_i.numpy())


def test_best_window_scores_bf16_match_jax_kernel():
    """bf16 windows and patterns (tests/test_ops.py's bf16 case), scores
    within 2e-2 (its tolerance) of the Pallas kernel and the reference."""
    rng = np.random.default_rng(4)
    windows, patterns = _unit_rows(rng, 100, 256), _unit_rows(rng, 33, 256)
    jw = jnp.asarray(windows).astype(jnp.bfloat16)
    jp = jnp.asarray(patterns).astype(jnp.bfloat16)
    ref_s, _ = jax_similarity.best_window_scores_reference(jw, jp)
    pallas_s, _ = jax_similarity._best_window_pallas(jw, jp, interpret=True)
    got_s, _ = similarity.best_window_scores(
        torch.from_numpy(windows).to(torch.bfloat16), torch.from_numpy(patterns).to(torch.bfloat16))
    assert got_s.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s, np.float32), rtol=0, atol=2e-2)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(pallas_s, np.float32), rtol=0, atol=2e-2)


def _take_better(best, candidate):
    """K5's merge rule on (score, index): the larger score, then the
    smaller index."""
    (s, i), (s2, i2) = best, candidate
    return candidate if s2 > s or (s2 == s and i2 < i) else best


def best_window_walk_model(windows, patterns, plan):
    """K5's walk in numpy, f32: every (window, pattern) dot product summed
    over d = 0 .. D-1 in one order; the windows cut into the plan's shares,
    each walked in tiles of the layout's window rows, in order, with the
    rows of a tile dealt to window lanes (row r to lane r % lanes: 32 and
    16 for the large tiles, configs 5 and 6, where each thread folds its
    own windows; one for the small tiles, folded a window a lane into the
    pattern's running best, and for the rows layout) that each keep their
    first strictly greater score; the lanes merged, then the shares, by
    "larger score, then smaller index"."""
    lanes_w = {5: 32, 6: 16, 7: 16}.get(plan.config, 1)
    w_count, d = windows.shape
    dots = np.zeros((w_count, patterns.shape[0]), np.float32)
    for k in range(d):  # one fixed order of the sum for every window
        dots += windows[:, k:k + 1] * patterns[None, :, k]
    tile_w = similarity.CONFIGS[plan.config][1]
    results = []
    for p in range(patterns.shape[0]):
        best = (-np.inf, np.iinfo(np.int32).max)
        for share in range(plan.shares):
            lo, hi = share * plan.share_w, min(w_count, (share + 1) * plan.share_w)
            lanes = [(-np.inf, np.iinfo(np.int32).max)] * lanes_w
            for w0 in range(lo, hi, tile_w):
                for r, w in enumerate(range(w0, min(w0 + tile_w, hi))):
                    lane = r % lanes_w
                    if dots[w, p] > lanes[lane][0]:
                        lanes[lane] = (dots[w, p], w)
            part = lanes[0]
            for lane in lanes[1:]:
                part = _take_better(part, lane)
            best = _take_better(best, part)
        results.append(best)
    return (np.asarray([s for s, _ in results], np.float32),
            np.asarray([i for _, i in results], np.int32))


#: name -> (windows, patterns, dim, SM count): P off the pattern tile (19
#: in a tile of 24; 70 in tiles of 64), one window, and SM counts that cut
#: the windows into several shares of several tiles
SIM_WALK_CASES = {
    "p19_shares": (300, 19, 64, 4),
    "p70_two_tiles": (600, 70, 64, 4),
    "p5_one_window_share": (40, 5, 32, 64),
    "w1_rows": (1, 33, 128, 132),
    "w8_rows": (8, 13, 64, 132),
    # any D: off 16-byte vectors (the kernel pads with zeros), and rows
    # wider than 4 KB (the streaming layout, config 7)
    "odd_d": (300, 19, 101, 4),
    "odd_d_rows": (3, 21, 37, 132),
    "wide_d_stream": (300, 19, 1100, 4),
}


@pytest.mark.parametrize("duplicated", [False, True], ids=["random", "duplicated"])
@pytest.mark.parametrize("name", list(SIM_WALK_CASES))
def test_best_window_walk_model_matches_jax_first_match(name, duplicated):
    """The kernel's share, tile, lane and merge order picks the JAX Pallas
    kernel's (interpret mode) first best window, and its scores agree
    within 1e-5.  ``duplicated``: pattern j is a copy of one window row,
    repeated on the other side of a share edge, a tile edge and a lane,
    so only the first copy is right."""
    w, p, d, sms = SIM_WALK_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    windows, patterns = _unit_rows(rng, w, d), _unit_rows(rng, p, d)
    plan = similarity.launch_plan(w, p, d, 4, sms)
    tile_w = similarity.CONFIGS[plan.config][1]
    firsts = []
    if duplicated and w > 1:
        edges = sorted({e for e in range(plan.share_w, w, plan.share_w)}
                       | {e for e in range(tile_w, w, tile_w)}) or [w // 2]
        used: set = set()
        for edge in edges:
            j = len(firsts)
            first = edge - 1 - j % 2
            rows = {first} | {r for r in (first + 1, edge, edge + 1, edge + tile_w)
                              if first < r < w}
            if j == p or first < 0 or rows & used:
                continue  # keep every copied row a copy of one first row
            used |= rows
            windows[sorted(rows)] = windows[first]
            patterns[j] = windows[first]
            firsts.append(first)
    assert plan.shares > 1 or plan.config == 0
    got_s, got_i = best_window_walk_model(windows, patterns, plan)
    pallas_s, pallas_i = jax_similarity._best_window_pallas(
        jnp.asarray(windows), jnp.asarray(patterns), interpret=True)
    np.testing.assert_allclose(got_s, np.asarray(pallas_s), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_i, np.asarray(pallas_i))
    if firsts:
        np.testing.assert_array_equal(got_i[: len(firsts)], firsts)


def test_similarity_launch_plan_fills_the_card():
    """The plan at the semantic path's geometries on 132 SMs: the analysis
    (4,096 windows x 19 patterns) takes the 24-pattern tile and 133 shares
    of 31 windows, at least one block per SM; recall (one query x 2,048
    incidents) the rows layout, 256 blocks of one warp a pattern; the
    1,024-pattern library 16 tiles of 64 x 8 shares of 512 windows.  The
    shares cover the windows exactly; wide rows take the smaller large tile."""
    plan = similarity.launch_plan(4096, 19, 384, 4, 132)
    assert plan == similarity.LaunchPlan(3, 31, 133, 1)
    assert similarity.CONFIGS[plan.config][0] == 24 and plan.p_tiles * plan.shares >= 132
    assert similarity.launch_plan(1, 2048, 384, 4, 132) == similarity.LaunchPlan(0, 1, 1, 256)
    assert similarity.launch_plan(4096, 1024, 384, 4, 132) == similarity.LaunchPlan(5, 512, 8, 16)
    assert similarity.launch_plan(4096, 33, 768, 4, 132).config == 6
    # rows over 4 KB stream their patterns; rows off 16-byte vectors are
    # planned at their padded width
    assert similarity.launch_plan(4096, 19, 1536, 4, 132) == similarity.LaunchPlan(7, 128, 32, 1)
    assert similarity.launch_plan(4096, 1024, 4096, 2, 132) == similarity.LaunchPlan(7, 1024, 4, 32)
    assert similarity.launch_plan(1, 19, 4096, 2, 132).config == 0
    assert similarity.launch_plan(8, 19, 1537, 4, 132).config == 7
    for w, p in ((4096, 19), (1, 2048), (4096, 1024), (300, 64), (513, 200), (9, 3)):
        plan = similarity.launch_plan(w, p, 384, 4, 132)
        assert (plan.shares - 1) * plan.share_w < w <= plan.shares * plan.share_w
        tile_p = similarity.CONFIGS[plan.config][0]
        assert plan.p_tiles == -(-p // tile_p)
        assert plan.config == 0 if w <= 8 else (plan.config >= 5) == (p > 32)


@pytest.mark.parametrize("k", [3, 10])
def test_top_k_windows_matches_jax(k):
    """Patterns copied from windows 3, 17 and 42 lead the ranking; k is
    clamped to the window count (here 50)."""
    rng = np.random.default_rng(8)
    windows = _unit_rows(rng, 50, 128)
    patterns = windows[[3, 17, 42]]
    want_s, want_i = jax_similarity.top_k_windows(jnp.asarray(windows), jnp.asarray(patterns), k)
    got_s, got_i = similarity.top_k_windows(torch.from_numpy(windows), torch.from_numpy(patterns), k)
    assert got_i.dtype == torch.int32 and got_s.shape == (k,)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=ATOL)
    assert set(got_i.numpy()[:3].tolist()) == {3, 17, 42}
