"""The port's block-hash prefix cache and host-RAM pool against the JAX
package's (``serving/kvstore.py``, ``ops/kv_transfer.py`` and the
continuous scheduler's prefix-cache path).

Follows ``tests/test_kv_economy.py``: the same seeds, shapes and prompts,
each case run through both packages.  Greedy tokens, plan traces, the
step records' ``cached_tokens``, ``stats()["kv_economy"]`` and the host
pool's bytes must be the JAX package's; ``page_accounting()`` must
balance in four terms after every case.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.ops import kv_transfer as jax_kv_transfer  # noqa: E402
from operator_tpu.serving import kvstore as jax_kvstore  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu.serving.sched import Scheduler as JaxScheduler  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.ops import kv_transfer  # noqa: E402
from operator_tpu_torch.serving import kvstore  # noqa: E402
from operator_tpu_torch.serving.engine import Generator  # noqa: E402
from operator_tpu_torch.serving.sched import Scheduler  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

PROMPT = "the quick brown fox jumps over the lazy dog " * 3


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


class _Side:
    """One package's objects for a case: how to build a generator, a
    store, a pool, params, and read a pooled block as numpy."""

    def __init__(self, name, params):
        self.name = name
        self.params = params
        jax_side = name == "jax"
        self.kvstore = jax_kvstore if jax_side else kvstore
        self.pool_cls = jax_kv_transfer.HostKVPool if jax_side else kv_transfer.HostKVPool
        self.sampling = JaxSamplingParams if jax_side else SamplingParams

    def generator(self, **kw):
        kw.setdefault("max_slots", 4)
        kw.setdefault("max_seq", 128)
        kw.setdefault("page_size", 16)
        if self.name == "jax":
            return BatchedGenerator(
                self.params, JAX_TINY_TEST, JaxByteTokenizer(), paged=True,
                cache_dtype=jnp.float32, metrics=JaxMetricsRegistry(), **kw,
            )
        return Generator(
            self.params, TINY_TEST, ByteTokenizer(), cache_dtype=torch.float32,
            device="cpu", **kw,
        )

    def sched(self, *, pool_mb=8, store=True, fabric_mirror=False, **kw):
        generator = self.generator(**kw)
        st = None
        if store:
            st = self.kvstore.PrefixKVStore(
                generator.page_size,
                host_pool=self.pool_cls(pool_mb) if pool_mb else None,
                metrics=generator.metrics,
            )
        cls = JaxScheduler if self.name == "jax" else Scheduler
        sched = cls(generator, kvstore=st, fabric_mirror=fabric_mirror)
        sched.plan_log = []
        return sched, generator, st

    def greedy(self, max_tokens):
        return self.sampling(max_tokens=max_tokens, temperature=0.0, stop_on_eos=False)

    def array(self, values):
        if self.name == "jax":
            return np.asarray(values)
        return torch.from_numpy(np.asarray(values))

    @staticmethod
    def host(array):
        """A numpy view of a host tensor or array (copy it to keep it)."""
        return array.numpy() if isinstance(array, torch.Tensor) else np.asarray(array)


@pytest.fixture(scope="module")
def sides(jax_params, torch_params):
    return {"jax": _Side("jax", jax_params), "torch": _Side("torch", torch_params)}


def drain_one(sched, req_id, limit=500):
    for _ in range(limit):
        for outcome in sched.step():
            if outcome.req_id == req_id:
                return outcome
    raise AssertionError(f"request {req_id} never finished")


def run(sched, prompt, params, **kw):
    return list(drain_one(sched, sched.enqueue(prompt, params, **kw)).result.token_ids)


def assert_balanced(sched):
    """Every page is on the free list, in a live row, in the store or in
    the generator's prefix hold — four terms, exactly."""
    acc = sched.page_accounting()
    assert set(acc) == {"available", "row_pages", "store_pages", "prefix_pages", "total"}
    assert (
        acc["available"] + acc["row_pages"] + acc["store_pages"] + acc["prefix_pages"]
        == acc["total"]
    ), acc
    return acc


def observed(sched, generator):
    """What both packages must agree on after a scenario."""
    return {
        "plans": list(sched.plan_log),
        "kv_economy": sched.stats()["kv_economy"],
        "cached_tokens": [r.cached_tokens for r in generator.step_clock.ring.records()],
        "accounting": assert_balanced(sched),
    }


def both(sides, scenario):
    """Run ``scenario(side)`` through both packages; returns (jax, torch)."""
    return scenario(sides["jax"]), scenario(sides["torch"])


# ---------------------------------------------------------------------------
# block hashing and the store (pure host logic, the same calls on both)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens,page_size", [
    (list(range(50)), 16),
    (list(range(48)), 16),
    (list(range(32)) + [999] * 16, 16),
    ([1] + [ord(c) for c in PROMPT], 16),
    ([1] + [ord(c) for c in PROMPT * 4], 64),
    ([7] * 5, 16),
])
def test_block_hashes_bytes_equal_reference(tokens, page_size):
    got = kvstore.block_hashes(tokens, page_size)
    want = jax_kvstore.block_hashes(tokens, page_size)
    assert got == want
    assert len(got) == len(tokens) // page_size
    assert all(isinstance(h, bytes) and len(h) == 16 for h in got)


def _store_match_cap(side):
    store = side.kvstore.PrefixKVStore(16)
    tokens = list(range(32))
    for i, h in enumerate(side.kvstore.block_hashes(tokens, 16)):
        store.insert(h, None, tokens[i * 16 : (i + 1) * 16], page=i + 1)
    return [len(store.match(tokens)), len(store.match(tokens + [99])), store.stats()]


def _store_blocks(side, n=3):
    store = side.kvstore.PrefixKVStore(4)
    tokens = list(range(4 * n))
    hashes = side.kvstore.block_hashes(tokens, 4)
    blocks = [
        store.insert(h, hashes[i - 1] if i else None, tokens[i * 4 : (i + 1) * 4], page=i + 1)
        for i, h in enumerate(hashes)
    ]
    return store, blocks


def _store_refcounts(side):
    store, blocks = _store_blocks(side)
    store.acquire(blocks[:2])
    first = [b.hash for b in store.evictable()]
    store.release([blocks[0].hash, blocks[1].hash])
    return [first, len(store.evictable()), [b.refs for b in blocks]]


def _store_evict_and_adopt(side):
    store, blocks = _store_blocks(side)
    store.acquire([blocks[1]])
    store.release([blocks[1].hash])
    victims = store.evict_lru(2)
    out = [[v.hash for v in victims]]
    store.mark_offloaded(victims[0].hash)
    store.forget(victims[1].hash)
    out.append([store.get(blocks[0].hash).page, store.get(blocks[2].hash)])
    revived = store.insert(blocks[0].hash, None, blocks[0].tokens, page=7)
    out.append([revived is store.get(blocks[0].hash), revived.page])
    with pytest.raises(ValueError):
        store.insert(blocks[1].hash, None, blocks[1].tokens, page=8)
    adopted = store.adopt_host(b"\x01" * 16, None, (1, 2, 3, 4))
    out.append([adopted.page, adopted.refs, store.adopt_host(b"\x01" * 16, None, ()) is adopted])
    out.append([store.inventory(limit=2), len(store), store.device_pages_held])
    return out


def _store_probe(side):
    store, blocks = _store_blocks(side, n=2)
    tokens = list(range(8)) + [42]
    before = store.probe(tokens)
    store.mark_offloaded(blocks[1].hash)
    after = store.probe(tokens)
    store.pending_offload.add(blocks[1].hash)
    pending = store.probe(tokens)
    return [before, after, pending, store.lookups, store.hit_rate()]


def _store_reset(side):
    pool = side.pool_cls(8)
    store = side.kvstore.PrefixKVStore(4, host_pool=pool)
    tokens = list(range(8))
    h0, h1 = side.kvstore.block_hashes(tokens, 4)
    store.insert(h0, None, tokens[:4], page=1)
    store.insert(h1, h0, tokens[4:], page=2)
    zeros = side.array(np.zeros((1, 4, 1, 2), np.float32))
    pool.put(h0, zeros, zeros)
    store.reset()
    return [store.get(h0) is not None and store.get(h0).page, store.get(h1), store.stats()]


def _pool_lru(side):
    block = np.arange(2 * 4 * 1 * 2, dtype=np.float32).reshape(2, 4, 1, 2)
    size = 2 * block.nbytes
    pool = side.pool_cls(1)
    pool.capacity_bytes = 3 * size  # room for three blocks
    out = []
    for i in range(5):
        out.append(pool.put(bytes([i]) * 16, side.array(block + i), side.array(block - i)))
    out.append(pool.put(bytes([4]) * 16, side.array(block), side.array(block)))
    pool.get(bytes([2]) * 16)  # bump
    out.append(pool.put(bytes([9]) * 16, side.array(block), side.array(block)))
    k, v = pool.get(bytes([4]) * 16)
    out.append([side.host(k).tobytes(), side.host(v).tobytes()])
    pool.drop(bytes([4]) * 16)
    out.append([len(pool), pool.bytes_used, pool.dropped, pool.has(bytes([4]) * 16)])
    too_big = side.pool_cls(1)
    huge = side.array(np.zeros((1024 * 1024,), np.float32))
    out.append([too_big.put(b"x" * 16, huge, huge), side.pool_cls(0).put(b"y" * 16, huge, huge)])
    return out


@pytest.mark.parametrize("case", [
    _store_match_cap, _store_refcounts, _store_evict_and_adopt, _store_probe,
    _store_reset, _pool_lru,
], ids=lambda f: f.__name__.lstrip("_"))
def test_store_and_pool_unit_cases_match_reference(sides, case):
    want, got = both(sides, case)
    assert got == want


# ---------------------------------------------------------------------------
# the scheduler with the store on: port vs JAX
# ---------------------------------------------------------------------------


def _repeated_prompts(side):
    sched, generator, _ = side.sched()
    tokens = [
        run(sched, PROMPT, side.greedy(8)),
        run(sched, PROMPT, side.greedy(8)),
        run(sched, PROMPT + "and then some", side.greedy(6)),
        run(sched, PROMPT[:40], side.greedy(5)),
    ]
    # two concurrent readers of the same chain, admitted together
    r1 = sched.enqueue(PROMPT, side.greedy(8))
    r2 = sched.enqueue(PROMPT * 2, side.greedy(4))
    done = {}
    for _ in range(300):
        for outcome in sched.step():
            done[outcome.req_id] = list(outcome.result.token_ids)
        if r1 in done and r2 in done:
            break
    tokens += [done[r1], done[r2]]
    return {"tokens": tokens, **observed(sched, generator)}


def _pooled(side, store):
    """The host pool's blocks as ``{hash hex: (k, v)}`` numpy arrays."""
    pool = store.host_pool
    return {
        h.hex(): tuple(side.host(t) for t in pool.get(h))
        for h in list(store._blocks) if pool.has(h)
    }


def _device_blocks(side, generator, store):
    """The store's device-resident blocks' pages as ``{hash hex: (k, v)}``."""
    paged = generator.paged_cache
    return {
        h.hex(): tuple(
            np.array(side.host(pages[:, b.page])) for pages in (paged.k_pages, paged.v_pages)
        )
        for h, b in store._blocks.items() if b.page >= 0
    }


def _seed_pages(side, generator):
    """Write the same seeded values into every KV page of both packages,
    so the pool's bytes can be compared exactly across them."""
    paged = generator.paged_cache
    rng = np.random.default_rng(7)
    k = rng.standard_normal(tuple(paged.k_pages.shape)).astype(np.float32)
    v = rng.standard_normal(tuple(paged.v_pages.shape)).astype(np.float32)
    if side.name == "jax":
        generator.paged_cache = type(paged)(
            k_pages=jnp.asarray(k), v_pages=jnp.asarray(v),
            page_table=paged.page_table, lengths=paged.lengths,
        )
    else:
        paged.k_pages.copy_(torch.from_numpy(k))
        paged.v_pages.copy_(torch.from_numpy(v))


def _offload_round_trip(side):
    sched, generator, store = side.sched(pool_mb=8)
    cold = run(sched, PROMPT, side.greedy(8))
    spilled = sched.spill_cache()
    assert store.device_pages_held == 0
    # an unrelated request's commit window drains the offloads to the pool
    other = run(sched, "an unrelated prompt", side.greedy(3))
    pooled = _pooled(side, store)
    assert pooled
    restored = run(sched, PROMPT, side.greedy(8))
    assert restored == cold
    assert generator.metrics.counter("kv_restore") > 0
    assert generator.metrics.counter("kv_offload") == len(pooled)
    return {
        "tokens": [cold, other, restored], "spilled": spilled, "pooled_close": pooled,
        **observed(sched, generator),
    }


def _offload_bytes(side):
    """The offload of seeded pages: the pool holds exactly the bytes the
    pages held, in both packages, and a restore writes them back."""
    sched, generator, store = side.sched(pool_mb=8)
    run(sched, PROMPT, side.greedy(4))
    _seed_pages(side, generator)
    gathered = _device_blocks(side, generator, store)
    sched.spill_cache()
    run(sched, "an unrelated prompt", side.greedy(2))  # drains to the pool
    pooled = _pooled(side, store)
    assert pooled.keys() == gathered.keys()
    for h, (k, v) in pooled.items():
        assert k.tobytes() == gathered[h][0].tobytes()
        assert v.tobytes() == gathered[h][1].tobytes()
    # the same prompt again: its match restores the pooled blocks into
    # fresh pages, holding the pooled bytes
    sched.enqueue(PROMPT, side.greedy(4))
    sched.step()
    restored = {
        h: kv for h, kv in _device_blocks(side, generator, store).items() if h in pooled
    }
    assert generator.metrics.counter("kv_restore") == len(restored) > 0
    for h in restored:
        assert restored[h][0].tobytes() == pooled[h][0].tobytes()
        assert restored[h][1].tobytes() == pooled[h][1].tobytes()
    for _ in range(20):
        sched.step()
    return {
        "pooled_exact": {h: [a.tobytes() for a in kv] for h, kv in pooled.items()},
        "tokens": [], **observed(sched, generator),
    }


def _no_pool_recomputes(side):
    sched, generator, _ = side.sched(pool_mb=0)
    cold = run(sched, PROMPT, side.greedy(8))
    sched.spill_cache()
    again = run(sched, PROMPT, side.greedy(8))
    assert again == cold
    assert generator.metrics.counter("kv_restore") == 0
    return {"tokens": [cold, again], **observed(sched, generator)}


def _pressure_never_wedges(side):
    sched, generator, _ = side.sched(pool_mb=4, max_slots=2, max_seq=64)
    prompts = [f"prompt variant {i}: " + "abcdefgh " * 6 for i in range(5)]
    first = [run(sched, p, side.greedy(4)) for p in prompts]
    second = [run(sched, p, side.greedy(4)) for p in prompts]
    assert first == second
    return {"tokens": first, **observed(sched, generator)}


def _resume_tokens(side):
    sched, generator, _ = side.sched()
    full = run(sched, PROMPT, side.greedy(12))
    resumed = run(sched, PROMPT, side.greedy(7), resume_tokens=full[:5])
    assert full[:5] + resumed == full
    return {"tokens": [full, resumed], **observed(sched, generator)}


def _fabric_mirror(side):
    sched, generator, store = side.sched(pool_mb=8, fabric_mirror=True)
    tokens = [run(sched, PROMPT, side.greedy(4)), run(sched, PROMPT * 2, side.greedy(3))]
    mirrored = _pooled(side, store)
    assert mirrored and generator.metrics.counter("fabric_mirror") == len(mirrored)
    # mirroring copies the pages' exact bytes; the pages stay with the store
    assert store.device_pages_held == len(store._blocks)
    device = _device_blocks(side, generator, store)
    for h, (k, v) in mirrored.items():
        assert k.tobytes() == device[h][0].tobytes() and v.tobytes() == device[h][1].tobytes()
    return {"tokens": tokens, "pooled_close": mirrored, **observed(sched, generator)}


SCENARIOS = [
    _repeated_prompts, _offload_round_trip, _offload_bytes, _no_pool_recomputes,
    _pressure_never_wedges, _resume_tokens, _fabric_mirror,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__.lstrip("_"))
def test_scheduler_with_store_matches_jax(sides, scenario):
    want, got = both(sides, scenario)
    assert got["tokens"] == want["tokens"]
    assert got["plans"] == want["plans"]
    assert got["cached_tokens"] == want["cached_tokens"]
    assert got["kv_economy"] == want["kv_economy"]
    assert got["accounting"] == want["accounting"]
    assert got.get("spilled") == want.get("spilled")
    assert got.get("pooled_exact") == want.get("pooled_exact")
    # KV computed by the two packages' f32 models: the same blocks, values
    # within f32 rounding of the projections (1e-5)
    close_got, close_want = got.get("pooled_close", {}), want.get("pooled_close", {})
    assert close_got.keys() == close_want.keys()
    for h in close_want:
        for a, b in zip(close_got[h], close_want[h]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_cache_on_and_off_give_identical_greedy_tokens(sides):
    side = sides["torch"]
    off, _, _ = side.sched(store=False)
    baseline = run(off, PROMPT, side.greedy(8))
    sched, generator, store = side.sched()
    cold = run(sched, PROMPT, side.greedy(8))
    warm = run(sched, PROMPT, side.greedy(8))
    assert baseline == cold == warm
    assert store.hits > 0 and store.hit_rate() == 0.5
    assert generator.metrics.counter("kv_prefill_tokens_saved") > 0
    assert off.stats()["kv_economy"] is None
    assert off.page_accounting()["store_pages"] == 0
    assert_balanced(off)
    assert_balanced(sched)


def test_refcounts_protect_shared_pages_under_spill(sides):
    side = sides["torch"]
    sched, generator, store = side.sched()
    seed = run(sched, PROMPT, side.greedy(8))
    r1 = sched.enqueue(PROMPT, side.greedy(8))
    r2 = sched.enqueue(PROMPT, side.greedy(8))
    sched.step()
    shared = [b for b in store._blocks.values() if b.refs > 0]
    assert shared and all(b.refs == 2 for b in shared)
    acc = assert_balanced(sched)
    assert acc["store_pages"] >= len(shared) and acc["row_pages"] > 0
    # eviction pressure while referenced: shared pages must survive
    sched.spill_cache()
    assert all(b.page >= 0 for b in shared)
    done = {}
    for _ in range(300):
        for outcome in sched.step():
            done[outcome.req_id] = list(outcome.result.token_ids)
        assert_balanced(sched)
        if r1 in done and r2 in done:
            break
    assert done[r1] == seed and done[r2] == seed
    assert all(b.refs == 0 for b in store._blocks.values())
    assert assert_balanced(sched)["row_pages"] == 0


def test_restored_page_bytes_equal_the_gathered_ones(sides):
    """The round trip of one block is exact: the page the restore writes
    holds the bytes the eviction gathered."""
    side = sides["torch"]
    sched, generator, store = side.sched(pool_mb=8)
    run(sched, PROMPT, side.greedy(4))
    before = {
        h: (generator.paged_cache.k_pages[:, b.page].clone(),
            generator.paged_cache.v_pages[:, b.page].clone())
        for h, b in store._blocks.items()
    }
    sched.spill_cache()
    run(sched, "an unrelated prompt", side.greedy(2))  # drains to the pool
    run(sched, PROMPT, side.greedy(4))  # restores from the pool
    restored = [h for h, b in store._blocks.items() if h in before and b.page >= 0]
    assert restored
    for h in restored:
        page = store.get(h).page
        assert torch.equal(generator.paged_cache.k_pages[:, page], before[h][0])
        assert torch.equal(generator.paged_cache.v_pages[:, page], before[h][1])
    assert_balanced(sched)


def test_reset_drops_pending_offloads_and_keeps_host_copies(sides):
    side = sides["torch"]
    sched, generator, store = side.sched(pool_mb=8)
    run(sched, PROMPT, side.greedy(4))
    sched.spill_cache()
    assert sched._pending_offload and store.pending_offload
    sched.reset()
    assert not sched._pending_offload and not store.pending_offload
    assert store.device_pages_held == 0
    # the blocks never reached the pool: nothing is restorable
    assert len(store) == 0


def test_page_size_mismatch_is_refused(sides):
    side = sides["torch"]
    generator = side.generator()
    with pytest.raises(ValueError, match="page_size"):
        Scheduler(generator, kvstore=kvstore.PrefixKVStore(32))
