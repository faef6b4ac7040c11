"""The PyTorch port's attention ops against the JAX package's.

Inputs are drawn once with numpy from a seed and fed to both packages.
The port's ``ragged_attention_reference`` (its CPU path and the oracle of
the CUDA kernel) is held to the JAX Pallas kernel run in interpret mode
and to the JAX dense reference, across every geometry the scheduler
produces; decode rows also to both packages' ``paged_attention_reference``;
``write_tokens`` to the JAX scatter.  f32 throughout, atol 1e-5 (the two
packages sum in different orders), valid rows only (padding rows are
don't-care by contract).  The CUDA kernel itself is compared with the
plain version on the card by ``tests/test_torch_kernels.py``.
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
from operator_tpu_torch.ops import paged_attention as paged  # noqa: E402
from operator_tpu_torch.ops import ragged_attention as ragged  # noqa: E402

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


@pytest.mark.parametrize("with_valid_len", [False, True])
def test_write_tokens_matches_jax(with_valid_len):
    rng = np.random.default_rng(3)
    num_pages = B * PPS + 1
    pages = rng.normal(size=(num_pages, PAGE, KH, D)).astype(np.float32)
    _, _, _, table = _inputs(4)
    new = rng.normal(size=(B, 5, KH, D)).astype(np.float32)
    start = np.asarray([0, 7, 13, 30], np.int32)
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
    if not with_valid_len:
        np.testing.assert_array_equal(ours.numpy()[0], want[0])


def test_paged_cache_layout():
    cache = paged.PagedKVCache.create(3, 9, PAGE, KH, D, B, PPS, dtype=torch.float32,
                                      device="cpu")
    assert cache.k_pages.shape == (3, 9, PAGE, KH, D)
    assert cache.page_table.dtype == torch.int32 and cache.page_table.shape == (B, PPS)
    assert cache.lengths.shape == (B,) and cache.page_size == PAGE

