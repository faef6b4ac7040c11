"""The PyTorch port's mixed step against the JAX ``make_mixed_fn``.

Same ``TINY_TEST`` weights (JAX ``init_params``, f32 and int8, carried
over by ``params_from_jax``), same page contents and the same packed
inputs for prefill-only, decode-only, mixed and spec-verify waves,
greedy.  ``toks`` at the scheduled slots' sampled positions, ``accept``,
the new lengths and ``latest_out`` must match exactly; every real KV page
(page 0 is the trash page) within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.quant import quantize_params as jax_quantize_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.ops.paged_attention import PagedKVCache as JaxPagedKVCache  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.sched.mixed import make_mixed_fn  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, params_from_jax  # noqa: E402
from operator_tpu_torch.ops.paged_attention import PagedKVCache  # noqa: E402
from operator_tpu_torch.serving.sched.mixed import make_mixed_step  # noqa: E402

SLOTS, MAX_SEQ, PAGE, T_BUDGET, CHUNK, WIDTH = 4, 64, 8, 16, 8, 3
PPS = MAX_SEQ // PAGE
NUM_PAGES = SLOTS * PPS + 1
KV_ATOL = 1e-5  # f32 projections summed in different orders

#: wave -> per-slot work (slot, kind, pos0, count, n_drafts, from_prev);
#: slots not listed sit the step out
WAVES = {
    "prefill_only": [(0, "prefill", 0, 8, 0, False), (1, "finish", 0, 5, 0, False)],
    "decode_only": [
        (0, "decode", 20, 1, 0, False), (1, "decode", 9, 1, 0, True),
        (2, "decode", 33, 1, 0, False), (3, "decode", 1, 1, 0, False),
    ],
    "mixed": [
        (0, "decode", 20, 1, 0, True), (1, "prefill", 16, 8, 0, False),
        (3, "finish", 8, 3, 0, False),
    ],
    "spec_verify": [
        (0, "verify", 20, 3, 2, False), (1, "decode", 9, 1, 0, False),
        (2, "verify", 12, 2, 1, False),
    ],
}


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


def _pack(wave, rng, first_drafts=None):
    """Pack a wave exactly as the scheduler's _dispatch does."""
    t, b = T_BUDGET, SLOTS
    arrays = {
        name: np.zeros((t,), np.int32)
        for name in ("ids", "rows", "pos", "in_row")
    }
    valid = np.zeros((t,), bool)
    from_prev = np.zeros((t,), bool)
    per_slot = {name: np.zeros((b,), np.int32) for name in (
        "q_start", "q_count", "sample_start", "spec_len")}
    kv_len = rng.integers(0, 30, size=b).astype(np.int32)  # idle slots keep theirs
    cursor = 0
    for slot, kind, pos0, count, n_drafts, chained in wave:
        span = slice(cursor, cursor + count)
        ids = rng.integers(3, 259, size=count).astype(np.int32)
        if kind == "verify" and first_drafts is not None:
            ids[1] = first_drafts[slot]
        arrays["ids"][span] = 0 if chained else ids
        arrays["pos"][span] = np.arange(pos0, pos0 + count)
        arrays["rows"][span] = slot
        arrays["in_row"][span] = np.arange(count)
        valid[span] = True
        from_prev[span] = chained
        per_slot["q_start"][slot] = cursor
        per_slot["q_count"][slot] = count
        per_slot["sample_start"][slot] = cursor + count - 1 - n_drafts
        per_slot["spec_len"][slot] = n_drafts
        kv_len[slot] = pos0 + count
        cursor += count
    return dict(
        ids=arrays["ids"], rows=arrays["rows"], pos=arrays["pos"], valid=valid,
        in_row=arrays["in_row"], q_start=per_slot["q_start"],
        q_count=per_slot["q_count"], kv_len=kv_len,
        latest=rng.integers(3, 259, size=b).astype(np.int32),
        from_prev=from_prev, sample_start=per_slot["sample_start"],
        spec_len=per_slot["spec_len"],
        temp=np.zeros((b,), np.float32), top_p=np.ones((b,), np.float32),
    )


ORDER = ("ids", "rows", "pos", "valid", "in_row", "q_start", "q_count", "kv_len",
         "latest", "from_prev", "sample_start", "spec_len")


def _cache(rng):
    shape = (TINY_TEST.num_layers, NUM_PAGES, PAGE, TINY_TEST.num_kv_heads,
             TINY_TEST.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    table = (1 + rng.permutation(NUM_PAGES - 1)).reshape(SLOTS, PPS).astype(np.int32)
    return k, v, table


def _run_jax(fn, params, cache, packed):
    k, v, table = cache
    paged = JaxPagedKVCache(
        k_pages=jnp.asarray(k), v_pages=jnp.asarray(v),
        page_table=jnp.asarray(table), lengths=jnp.zeros((SLOTS,), jnp.int32),
    )
    args = [jnp.asarray(packed[name]) for name in ORDER]
    new_paged, toks, accept, latest, _ = fn(
        params, paged, *args, jax.random.PRNGKey(0),
        jnp.asarray(packed["temp"]), jnp.asarray(packed["top_p"]),
    )
    return {
        "k": np.asarray(new_paged.k_pages), "v": np.asarray(new_paged.v_pages),
        "lengths": np.asarray(new_paged.lengths), "toks": np.asarray(toks),
        "accept": np.asarray(accept), "latest": np.asarray(latest),
    }


def _run_torch(step, params, cache, packed):
    k, v, table = cache
    paged = PagedKVCache(
        k_pages=torch.from_numpy(k.copy()), v_pages=torch.from_numpy(v.copy()),
        page_table=torch.from_numpy(table.copy()),
        lengths=torch.zeros((SLOTS,), dtype=torch.int32),
    )
    args = [torch.from_numpy(packed[name].copy()) for name in ORDER]
    new_paged, toks, accept, latest, _ = step(
        params, paged, *args, torch.Generator().manual_seed(0),
        torch.from_numpy(packed["temp"]), torch.from_numpy(packed["top_p"]),
    )
    return {
        "k": new_paged.k_pages.numpy(), "v": new_paged.v_pages.numpy(),
        "lengths": new_paged.lengths.numpy(), "toks": toks.numpy(),
        "accept": accept.numpy(), "latest": latest.numpy(),
    }


@pytest.fixture(scope="module")
def programs(jax_params):
    generator = BatchedGenerator(
        jax_params, JAX_TINY_TEST, JaxByteTokenizer(), paged=True,
        cache_dtype=jnp.float32, metrics=MetricsRegistry(),
        max_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
    )
    jax_fn = make_mixed_fn(generator, T_BUDGET, CHUNK, spec_width=WIDTH)
    step = make_mixed_step(
        TINY_TEST, max_slots=SLOTS, t_budget=T_BUDGET, chunk=CHUNK,
        spec_width=WIDTH, device="cpu",
    )
    return jax_fn, step


@pytest.mark.parametrize("weights", ["float32", "int8"])
@pytest.mark.parametrize("wave", list(WAVES))
def test_mixed_step_matches_jax(jax_params, programs, wave, weights):
    jax_fn, step = programs
    params = jax_params
    if weights == "int8":
        params = jax_quantize_params(jax_params, JAX_TINY_TEST)
    torch_params = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    seed = sum(map(ord, wave))
    cache = _cache(np.random.default_rng(seed))
    packed = _pack(WAVES[wave], np.random.default_rng(seed + 1))
    want = _run_jax(jax_fn, params, cache, packed)
    if wave == "spec_verify":
        # make each verify row's first draft the token the model predicts,
        # so the accept path runs with accept > 0
        packed = _pack(WAVES[wave], np.random.default_rng(seed + 1),
                       first_drafts=want["toks"][:, 0])
        want = _run_jax(jax_fn, params, cache, packed)
        assert (want["accept"][[0, 2]] >= 1).all()
    got = _run_torch(step, torch_params, cache, packed)
    # the sampled positions that mean something: a scheduled slot's first
    # and, on a verify row, one per draft (the others read neighbours'
    # or padding tokens)
    meaningful = (packed["q_count"] > 0)[:, None] & (
        np.arange(WIDTH)[None, :] <= packed["spec_len"][:, None]
    )
    np.testing.assert_array_equal(got["toks"][meaningful], want["toks"][meaningful])
    np.testing.assert_array_equal(got["accept"], want["accept"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    np.testing.assert_array_equal(got["latest"], want["latest"])
    np.testing.assert_allclose(got["k"][:, 1:], want["k"][:, 1:], rtol=0, atol=KV_ATOL)
    np.testing.assert_allclose(got["v"][:, 1:], want["v"][:, 1:], rtol=0, atol=KV_ATOL)
