"""The port's fleet KV fabric (``operator_tpu_torch/fabric``) against the
JAX package's (``operator_tpu/fabric``), on the CPU.

Follows ``tests/test_fabric.py``; every case runs through both packages:

- the PMKV1 wire: for seeded f32, f16, bf16 and fp8 pages the port's
  ``encode_block`` gives the JAX package's bytes (the numpy side is built
  with ``ml_dtypes``), each package decodes the other's to the same bits,
  decoding copies out of the blob, and every corruption case raises
  ``CorruptBlock``;
- the peer poller, the fetch client with its 404 eviction, budget clamp,
  fault seam and consecutive-failure decay, and the two-leg dispatch:
  the same index states and counters;
- mirror and adopt on ``tiny-test`` (the JAX ``init_params`` carried over
  by ``params_from_jax``): a block fetched through an injected transport
  and restored gives the greedy tokens of a local host-pool restore and
  of the JAX package; prefetch adopts only the contiguous prefix and is a
  no-op without a pool; on the port's ``ServingEngine`` the probe and the
  adoption run on the worker, holding its lock;
- ``GET /kv/blocks/{hash}`` on the port's ``CompletionServer`` (200 with
  ``encode_block``'s bytes, 404, 400, 401, as the JAX server answers);
- two-leg prefill/decode dispatch over two port engines gives the JAX
  package's greedy tokens for the same drive.
"""

import asyncio
import json
import threading
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")
import jax.numpy as jnp  # noqa: E402

from operator_tpu import fabric as jax_fabric  # noqa: E402
from operator_tpu.fabric import disagg as jax_disagg  # noqa: E402
from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.ops import kv_transfer as jax_kv_transfer  # noqa: E402
from operator_tpu.router import EngineRouter as JaxRouter  # noqa: E402
from operator_tpu.router import ReplicaLoad as JaxLoad  # noqa: E402
from operator_tpu.router.core import Replica as JaxReplica  # noqa: E402
from operator_tpu.serving import kvstore as jax_kvstore  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from operator_tpu.serving.httpserver import CompletionServer as JaxCompletionServer  # noqa: E402
from operator_tpu.serving.sched import Scheduler as JaxScheduler  # noqa: E402
from operator_tpu.utils import faultinject as jax_faultinject  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from operator_tpu_torch import fabric  # noqa: E402
from operator_tpu_torch.fabric import disagg  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.ops import kv_transfer  # noqa: E402
from operator_tpu_torch.router import EngineRouter, ReplicaLoad  # noqa: E402
from operator_tpu_torch.router.core import Replica  # noqa: E402
from operator_tpu_torch.serving import kvstore  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.httpserver import CompletionServer  # noqa: E402
from operator_tpu_torch.serving.sched import Scheduler  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from operator_tpu_torch.utils import faultinject  # noqa: E402
from operator_tpu_torch.utils.timing import MetricsRegistry  # noqa: E402
from test_torch_completion_api import call  # noqa: E402
from test_torch_engine import event_loop_thread  # noqa: E402

HASH = "ab" * 16
TOKEN = "sekrit"
#: every engine drive's own bound
TIMEOUT_S = 60.0
#: 89 tokens with the byte tokenizer's BOS: 5 full 16-token blocks, inside
#: the prompt budget of max_seq 128 (the enqueue never truncates it)
PROMPT = "the quick brown fox jumps over the lazy dog " * 2
SECOND = "a different prompt, long enough to span two pages of sixteen"

SIDES = {
    "jax": SimpleNamespace(
        name="jax", fab=jax_fabric, disagg=jax_disagg, metrics=JaxMetricsRegistry,
        router=JaxRouter, load=JaxLoad, replica=JaxReplica, plan=jax_faultinject.FaultPlan,
        raise_=jax_faultinject.raise_,
    ),
    "port": SimpleNamespace(
        name="port", fab=fabric, disagg=disagg, metrics=MetricsRegistry,
        router=EngineRouter, load=ReplicaLoad, replica=Replica, plan=faultinject.FaultPlan,
        raise_=faultinject.raise_,
    ),
}

#: counters the fabric's client side keeps, compared between the packages
FETCH_COUNTERS = (
    "fabric_fetch_ok", "fabric_fetch_miss", "fabric_fetch_timeout", "fabric_fetch_error",
    "fabric_fetch_corrupt", "fabric_fetch_fallback", "fabric_index_evicted",
    "fabric_index_decayed", "fabric_prefetch_adopted", "fabric_peer_poll_ok",
    "fabric_peer_poll_error", "fabric_peer_removed", "fabric_peer_resolve_error",
    "fabric_disagg_handoff",
)


def counters(metrics) -> dict:
    return {name: metrics.counter(name) for name in FETCH_COUNTERS}


# ---------------------------------------------------------------------------
# pages: the same bits as a numpy (ml_dtypes) array and a torch tensor
# ---------------------------------------------------------------------------

DTYPES = {
    "float32": (np.float32, torch.float32),
    "float16": (np.float16, torch.float16),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
    "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
    "float8_e5m2": (ml_dtypes.float8_e5m2, torch.float8_e5m2),
}


def to_torch(array: np.ndarray, dtype) -> torch.Tensor:
    raw = np.ascontiguousarray(array).reshape(-1).view(np.uint8).copy()
    return torch.from_numpy(raw).view(dtype).reshape(array.shape)


def bits(value) -> bytes:
    if isinstance(value, torch.Tensor):
        return value.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(value).tobytes()


def page(seed: int, dtype: str = "float32", shape=(2, 4, 2, 8)) -> dict:
    """One seeded page pair on both sides: ``{"jax": (k, v), "port": (k, v)}``."""
    np_dtype, torch_dtype = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(shape, dtype=np.float32).astype(np_dtype)
    v = rng.standard_normal(shape, dtype=np.float32).astype(np_dtype)
    return {"jax": (k, v), "port": (to_torch(k, torch_dtype), to_torch(v, torch_dtype))}


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_gives_the_jax_bytes(dtype):
    pages = page(11, dtype)
    jax_blob = jax_fabric.encode_block(bytes.fromhex(HASH), *pages["jax"])
    port_blob = fabric.encode_block(bytes.fromhex(HASH), *pages["port"])
    assert port_blob == jax_blob
    header = json.loads(port_blob.split(b"\n")[1])
    assert header["k"]["dtype"] == dtype and header["k"]["shape"] == [2, 4, 2, 8]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_each_package_decodes_the_others_bytes(dtype):
    pages = page(12, dtype, shape=(3, 16, 2, 4))
    want = [bits(x) for x in pages["jax"]]
    h, k, v = fabric.decode_block(jax_fabric.encode_block(bytes.fromhex(HASH), *pages["jax"]))
    assert h.hex() == HASH and [bits(k), bits(v)] == want
    assert k.dtype == DTYPES[dtype][1] and tuple(v.shape) == (3, 16, 2, 4)
    h, k, v = jax_fabric.decode_block(fabric.encode_block(bytes.fromhex(HASH), *pages["port"]))
    assert h.hex() == HASH and [bits(k), bits(v)] == want
    assert k.dtype == np.dtype(DTYPES[dtype][0])


def test_decode_copies_out_of_the_wire_blob():
    """A view would pin the whole response behind one page-sized pool
    entry: each decoded tensor owns exactly its own bytes, is writable,
    and decoding warns nothing."""
    pages = page(7)
    blob = fabric.encode_block(bytes.fromhex(HASH), *pages["port"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _h, k, v = fabric.decode_block(blob)
    for got, ref in ((k, pages["port"][0]), (v, pages["port"][1])):
        assert got.untyped_storage().nbytes() == got.nbytes == ref.nbytes
        assert torch.equal(got, ref)
    k.zero_()  # writable, and the blob is untouched
    assert fabric.decode_block(blob)[1].abs().sum() > 0


def test_a_non_contiguous_tensor_goes_out_in_its_logical_order():
    pages = page(8, shape=(4, 2, 2, 8))
    k, v = pages["port"]
    kt = k.transpose(0, 1).contiguous().transpose(0, 1)
    assert not kt.is_contiguous()
    assert fabric.encode_block(b"\x01" * 16, kt, v) == fabric.encode_block(b"\x01" * 16, k, v)


MUTATIONS = {
    "truncated": lambda b: b[:-1],
    "bad-magic": lambda b: b"XXKV1\n" + b[6:],
    "trailing": lambda b: b + b"\x00",
    "flipped-byte": lambda b: b[:40] + bytes([b[40] ^ 0xFF]) + b[41:],
    "flipped-payload-byte": lambda b: b[:-9] + bytes([b[-9] ^ 0x01]) + b[-8:],
    "unparseable-header": lambda b: b"PMKV1\nnot json\n",
    "empty": lambda b: b"",
    "unknown-dtype": lambda b: b.replace(b'"dtype": "float32"', b'"dtype": "notadtype"', 1),
    "header-not-an-object": lambda b: b"PMKV1\n[1, 2]\n",
    "no-newline": lambda b: b"PMKV1\n{",
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_corruption_always_raises(mutation):
    pages = page(1)
    for side, module in (("jax", jax_fabric), ("port", fabric)):
        blob = module.encode_block(bytes.fromhex(HASH), *pages[side])
        with pytest.raises(module.CorruptBlock):
            module.decode_block(bytes(MUTATIONS[mutation](blob)))


# ---------------------------------------------------------------------------
# the peer poller
# ---------------------------------------------------------------------------


def _healthz(rid, blocks):
    return json.dumps({"status": "ok", "replica": rid, "load": {"kvBlocks": blocks}}).encode()


def _poller(side, fleet, *, peers=None, resolver=None, **kw):
    async def transport(url, timeout_s):
        assert timeout_s > 0
        base = url.rsplit("/healthz", 1)[0]
        if base not in fleet:
            raise ConnectionError(f"no pod at {base}")
        rid, blocks = fleet[base]
        return 200, _healthz(rid, blocks)

    index = side.fab.FabricIndex()
    poller = side.fab.PeerPoller(
        index, peers=peers or list(fleet), metrics=side.metrics(),
        resolver=resolver or (lambda host, port: [(host, port)]), transport=transport, **kw,
    )
    return index, poller


def _index_state(index, hashes=("h1", "h2", "h3")) -> dict:
    return {h: (index.holders(h), index.holder_urls(h)) for h in hashes} | {
        "empty": index.empty(), "replicas": index.replicas()}


def _poll_feeds(side):
    fleet = {"http://a:8000": ("pod-a", ["h1", "h2"]), "http://b:8000": ("pod-b", ["h2"])}
    index, poller = _poller(side, fleet)
    fed = asyncio.run(poller.poll_once())
    assert fed == 2 and ("pod-a", "http://a:8000") in index.holder_urls("h1")
    return [fed, _index_state(index), counters(poller.metrics)]


def _self_never_indexed(side):
    index, poller = _poller(side, {"http://me:8000": ("pod-me", ["h1"])}, self_id="pod-me")
    fed = asyncio.run(poller.poll_once())
    assert fed == 0 and index.empty()
    return [fed, _index_state(index)]


def _dead_peer_removed(side):
    fleet = {"http://a:8000": ("pod-a", ["h1"]), "http://b:8000": ("pod-b", ["h1"])}
    index, poller = _poller(side, fleet)
    asyncio.run(poller.poll_once())
    before = _index_state(index)
    del fleet["http://a:8000"]
    asyncio.run(poller.poll_once())
    assert index.holders("h1") == ["pod-b"]
    return [before, _index_state(index), counters(poller.metrics)]


def _replace_on_report(side):
    fleet = {"http://a:8000": ("pod-a", ["h1", "h2"])}
    index, poller = _poller(side, fleet)
    asyncio.run(poller.poll_once())
    fleet["http://a:8000"] = ("pod-a", ["h2"])
    asyncio.run(poller.poll_once())
    assert index.holders("h1") == [] and index.holders("h2") == ["pod-a"]
    return _index_state(index)


def _dns_expansion(side):
    fleet = {"http://10.0.0.4:8000": ("pod-a", ["h1"]), "http://10.0.0.5:8000": ("pod-b", ["h2"])}

    def resolver(host, port):
        assert (host, port) == ("podmortem-serving", 8000)
        return [("10.0.0.4", 8000), ("10.0.0.5", 8000)]

    index, poller = _poller(side, fleet, peers=["http://podmortem-serving:8000"],
                            resolver=resolver)
    fed = asyncio.run(poller.poll_once())
    both = _index_state(index)
    poller._resolver = lambda host, port: [("10.0.0.4", 8000)]
    asyncio.run(poller.poll_once())
    assert fed == 2 and index.holders("h2") == []
    return [fed, both, _index_state(index)]


def _resolve_failure(side):
    index, poller = _poller(side, {"http://a:8000": ("pod-a", ["h1"])})
    asyncio.run(poller.poll_once())

    def dead_dns(host, port):
        raise OSError("dns down")

    poller._resolver = dead_dns
    asyncio.run(poller.poll_once())
    assert index.empty()
    return [_index_state(index), counters(poller.metrics)]


@pytest.mark.parametrize("case", [
    _poll_feeds, _self_never_indexed, _dead_peer_removed, _replace_on_report, _dns_expansion,
    _resolve_failure,
], ids=lambda f: f.__name__.strip("_"))
def test_peer_poller_as_the_jax_package(case):
    assert case(SIDES["port"]) == case(SIDES["jax"])


# ---------------------------------------------------------------------------
# the fetch client and the consecutive-failure decay
# ---------------------------------------------------------------------------


def _fetcher(side, index, transport, **kw):
    kw.setdefault("metrics", side.metrics())
    kw.setdefault("timeout_s", 2.0)
    return side.fab.FabricFetcher(index, transport=transport, **kw)


def _served(side, pages):
    """Transport serving encoded pages keyed by hash hex (404 otherwise)."""
    async def transport(url, budget_s):
        assert budget_s > 0
        hash_hex = url.rsplit("/", 1)[-1]
        entry = pages.get(hash_hex)
        if entry is None:
            return 404, b""
        return 200, side.fab.encode_block(bytes.fromhex(hash_hex), *entry)
    return transport


def _index(side, *holders):
    index = side.fab.FabricIndex()
    for rid in holders:
        index.update(rid, [HASH], url=f"http://{rid}")
    return index


def _got(result):
    return None if result is None else [bits(x) for x in result]


def _fetch_ok(side):
    index = _index(side, "a")
    fetcher = _fetcher(side, index, _served(side, {HASH: page(2)[side.name]}))
    got = asyncio.run(fetcher.fetch_block(HASH))
    assert got is not None
    return [_got(got), counters(fetcher.metrics)]


def _fetch_404_evicts(side):
    index = _index(side, "a")
    fetcher = _fetcher(side, index, _served(side, {}))
    got = asyncio.run(fetcher.fetch_block(HASH))
    assert got is None and index.holders(HASH) == []
    return [_got(got), counters(fetcher.metrics), index.stats()]


def _fetch_corrupt(side):
    index = _index(side, "a")

    async def transport(url, budget_s):
        return 200, b"PMKV1\ngarbage\n"

    fetcher = _fetcher(side, index, transport)
    assert asyncio.run(fetcher.fetch_block(HASH)) is None
    return counters(fetcher.metrics)


def _fetch_wrong_hash(side):
    index = _index(side, "a")
    k, v = page(3)[side.name]

    async def transport(url, budget_s):
        return 200, side.fab.encode_block(bytes.fromhex("cd" * 16), k, v)

    fetcher = _fetcher(side, index, transport)
    assert asyncio.run(fetcher.fetch_block(HASH)) is None
    return counters(fetcher.metrics)


def _fetch_timeout_next_holder(side):
    index = _index(side, "a", "b")
    k, v = page(4)[side.name]
    calls = []

    async def transport(url, budget_s):
        calls.append(url)
        if "//a/" in url:
            raise asyncio.TimeoutError()
        return 200, side.fab.encode_block(bytes.fromhex(HASH), k, v)

    fetcher = _fetcher(side, index, transport)
    got = asyncio.run(fetcher.fetch_block(HASH))
    assert got is not None and len(calls) == 2
    return [calls, _got(got), counters(fetcher.metrics)]


def _fetch_budget_clamp(side):
    index = _index(side, "a")
    seen = []

    async def transport(url, budget_s):
        seen.append(budget_s)
        return 404, b""

    fetcher = _fetcher(side, index, transport, timeout_s=2.0)
    assert asyncio.run(fetcher.fetch_block(HASH, budget_s=0)) is None
    assert asyncio.run(fetcher.fetch_block(HASH, budget_s=-1)) is None
    assert not seen  # an exhausted budget never calls the transport
    asyncio.run(fetcher.fetch_block(HASH, budget_s=0.5))
    assert len(seen) == 1 and 0 < seen[0] <= 0.5  # clamped to the residual budget
    return counters(fetcher.metrics)


def _fetch_no_holder(side):
    fetcher = _fetcher(side, side.fab.FabricIndex(), _served(side, {}))
    assert asyncio.run(fetcher.fetch_block(HASH)) is None
    index = _index(side, "me")
    mine = _fetcher(side, index, _served(side, {HASH: page(5)[side.name]}), self_id="me")
    assert asyncio.run(mine.fetch_block(HASH)) is None
    return [counters(fetcher.metrics), counters(mine.metrics)]


def _fetch_fault_seam(side):
    index = _index(side, "a", "b")
    plan = side.plan(seed=7)
    plan.rule("fabric.fetch", [side.raise_(lambda: ConnectionError("holder died"), "kill")],
              match=lambda replica, block: replica == "a")
    fetcher = _fetcher(side, index, _served(side, {HASH: page(6)[side.name]}), fault_plan=plan)
    got = asyncio.run(fetcher.fetch_block(HASH))
    assert got is not None and plan.pending() == {}
    return [_got(got), counters(fetcher.metrics), plan.trace()]


def _decay_black_hole(side):
    index = _index(side, "a", "b")
    k, v = page(8)[side.name]

    async def transport(url, budget_s):
        if "//a/" in url:
            raise asyncio.TimeoutError()  # a black hole never 404s
        return 200, side.fab.encode_block(bytes.fromhex(HASH), k, v)

    fetcher = _fetcher(side, index, transport)
    for _ in range(4):
        assert asyncio.run(fetcher.fetch_block(HASH)) is not None
    assert index.holders(HASH) == ["b"]
    return [counters(fetcher.metrics), index.stats()]


def _decay_success_resets(side):
    index = _index(side, "a", "b")
    k, v = page(9)[side.name]
    black_hole = {"on": True}

    async def transport(url, budget_s):
        if "//a/" in url and black_hole["on"]:
            raise asyncio.TimeoutError()
        return 200, side.fab.encode_block(bytes.fromhex(HASH), k, v)

    fetcher = _fetcher(side, index, transport)
    seen = []
    for on in (True, True, False, True, True):
        black_hole["on"] = on
        asyncio.run(fetcher.fetch_block(HASH))
        seen.append(index.stats()["decaying"])
    assert index.holders(HASH) == ["a", "b"]
    return [seen, counters(fetcher.metrics)]


def _decay_fresh_report_resets(side):
    index = _index(side, "a")
    out = [index.note_failure("a", HASH), index.note_failure("a", HASH),
           index.stats()["decaying"]]
    index.update("a", [HASH], url="http://a")
    out += [index.stats()["decaying"], index.note_failure("a", HASH), index.holders(HASH)]
    return out


def _decay_404_still_evicts(side):
    index = _index(side, "a", "b")
    k, v = page(10)[side.name]

    async def transport(url, budget_s):
        if "//a/" in url:
            return 404, b""
        return 200, side.fab.encode_block(bytes.fromhex(HASH), k, v)

    fetcher = _fetcher(side, index, transport)
    assert asyncio.run(fetcher.fetch_block(HASH)) is not None
    assert index.holders(HASH) == ["b"]
    return counters(fetcher.metrics)


@pytest.mark.parametrize("case", [
    _fetch_ok, _fetch_404_evicts, _fetch_corrupt, _fetch_wrong_hash, _fetch_timeout_next_holder,
    _fetch_budget_clamp, _fetch_no_holder, _fetch_fault_seam,
], ids=lambda f: f.__name__.strip("_"))
def test_fabric_fetcher_as_the_jax_package(case):
    assert case(SIDES["port"]) == case(SIDES["jax"])


@pytest.mark.parametrize("case", [
    _decay_black_hole, _decay_success_resets, _decay_fresh_report_resets,
    _decay_404_still_evicts,
], ids=lambda f: f.__name__.strip("_"))
def test_consecutive_failure_decay_as_the_jax_package(case):
    assert case(SIDES["port"]) == case(SIDES["jax"])


def test_disaggregated_dispatch_hands_off_tokens():
    def drive(side):
        async def run():
            router = side.router(["p", "d"])
            router.report_load("p", side.load(role="prefill"))
            router.report_load("d", side.load(role="decode"))
            seen = {}

            async def prefill_send(replica, attempt, budget_s):
                seen["prefill"] = replica.id
                return SimpleNamespace(token_ids=[1, 2, 3])

            async def decode_send(replica, attempt, budget_s, prefix):
                seen["decode"] = replica.id
                seen["prefix"] = list(prefix)
                return SimpleNamespace(token_ids=[1, 2, 3, 4, 5])

            metrics = side.metrics()
            pre, dec = await side.disagg.disaggregated_dispatch(
                router, prefill_send, decode_send, key="k", request_id="r1", metrics=metrics,
            )
            assert seen == {"prefill": "p", "decode": "d", "prefix": [1, 2, 3]}
            return [seen, pre.replica_id, dec.replica_id, list(dec.response.token_ids),
                    counters(metrics)]

        return asyncio.run(run())

    got = drive(SIDES["port"])
    assert got == drive(SIDES["jax"])
    assert got[-1]["fabric_disagg_handoff"] == 1


@pytest.mark.parametrize("side", ["jax", "port"])
def test_store_readers_never_see_mid_mutation_state(side):
    """The fabric path adopting and forgetting while the /healthz path
    iterates inventory, stats, evictable and probe: no reader ever sees a
    dict changed during iteration."""
    jax_side = side == "jax"
    pool = (jax_kv_transfer if jax_side else kv_transfer).HostKVPool(8)
    module = jax_kvstore if jax_side else kvstore
    store = module.PrefixKVStore(16, host_pool=pool, metrics=SIDES[side].metrics())
    k, v = page(0)["jax" if jax_side else "port"]
    stop = threading.Event()
    errors: list = []

    def mutate():
        i = 0
        try:
            while not stop.is_set():
                tokens = list(range(i % 5, i % 5 + 64))
                hashes = module.block_hashes(tokens, 16)
                parent = None
                for n, h in enumerate(hashes):
                    pool.put(h, k, v)
                    store.adopt_host(h, parent, tokens[n * 16:(n + 1) * 16])
                    parent = h
                for h in hashes:
                    store.forget(h)
                i += 1
        except BaseException as exc:  # noqa: BLE001 - the assertion
            errors.append(exc)

    def read():
        try:
            while not stop.is_set():
                store.inventory()
                store.stats()
                store.evictable()
                store.probe(list(range(64)))
                len(store)
        except BaseException as exc:  # noqa: BLE001 - the assertion
            errors.append(exc)

    threads = [threading.Thread(target=mutate), threading.Thread(target=read)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert not errors, errors


# ---------------------------------------------------------------------------
# mirror, fetch, adopt and restore on tiny-test
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


@pytest.fixture(scope="module")
def params(jax_params, torch_params):
    return {"jax": jax_params, "port": torch_params}


def replica(side, params, *, mirror=False, pool_mb=8):
    """One package's generator, store and scheduler at the reference
    test's shapes."""
    if side == "jax":
        generator = BatchedGenerator(
            params["jax"], JAX_TINY_TEST, JaxByteTokenizer(), paged=True, max_slots=4,
            max_seq=128, page_size=16, cache_dtype=jnp.float32, metrics=JaxMetricsRegistry(),
        )
        pool = jax_kv_transfer.HostKVPool(pool_mb) if pool_mb else None
        store = jax_kvstore.PrefixKVStore(16, host_pool=pool, metrics=generator.metrics)
        return JaxScheduler(generator, kvstore=store, fabric_mirror=mirror), generator, store
    generator = Generator(
        params["port"], TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=128, page_size=16,
        cache_dtype=torch.float32, device="cpu", metrics=MetricsRegistry(),
    )
    pool = kv_transfer.HostKVPool(pool_mb) if pool_mb else None
    store = kvstore.PrefixKVStore(16, host_pool=pool, metrics=generator.metrics)
    return Scheduler(generator, kvstore=store, fabric_mirror=mirror), generator, store


def greedy(side, max_tokens):
    cls = JaxSamplingParams if side == "jax" else SamplingParams
    return cls(max_tokens=max_tokens, temperature=0.0, stop_on_eos=False)


def drain_one(sched, req_id, limit=500):
    for _ in range(limit):
        for outcome in sched.step():
            if outcome.req_id == req_id:
                return outcome
    raise AssertionError(f"request {req_id} never finished")


def run(sched, side, prompt=PROMPT, max_tokens=8):
    return list(drain_one(sched, sched.enqueue(prompt, greedy(side, max_tokens))).result.token_ids)


def balanced(sched) -> dict:
    acc = sched.page_accounting()
    assert acc["available"] + acc["row_pages"] + acc["store_pages"] + acc["prefix_pages"] \
        == acc["total"], acc
    return acc


def pooled(store, hashes) -> dict:
    return {h.hex(): store.host_pool.get(h) for h in hashes}


def prompt_hashes(side, generator, prompt=PROMPT) -> list:
    module = jax_kvstore if side == "jax" else kvstore
    return module.block_hashes(generator.tokenizer.encode(prompt), generator.page_size)


def _fetch_adopt_restore(side, params):
    """Replica A computes and mirrors; B prefetches A's pages over an
    injected transport and decodes; A itself, its cache spilled, serves
    the prompt again from a local host-pool restore."""
    sched_a, gen_a, store_a = replica(side, params, mirror=True)
    first = run(sched_a, side)
    hashes = prompt_hashes(side, gen_a)
    assert hashes and all(store_a.host_pool.has(h) for h in hashes)
    assert gen_a.metrics.counter("fabric_mirror") == len(hashes)
    index = SIDES[side].fab.FabricIndex()
    index.update("a", [h.hex() for h in hashes], url="http://a")
    sched_b, gen_b, store_b = replica(side, params)
    fetcher = _fetcher(SIDES[side], index, _served(SIDES[side], pooled(store_a, hashes)),
                       self_id="b")
    tokens = gen_a.tokenizer.encode(PROMPT)
    adopted = asyncio.run(fetcher.prefetch(tokens, store=store_b))
    assert adopted == len(hashes) and all(store_b.restorable(h) for h in hashes)
    fetched = run(sched_b, side)
    sched_a.spill_cache()
    run(sched_a, side, "x", 1)  # the commit window after a spill
    restores = gen_a.metrics.counter("kv_restore")
    local = run(sched_a, side)
    return {
        "first": first, "fetched": fetched, "local": local, "adopted": adopted,
        "b_restores": gen_b.metrics.counter("kv_restore"), "b_hits": gen_b.metrics.counter("kv_hit"),
        "a_restores": gen_a.metrics.counter("kv_restore") - restores,
        "b_accounting": balanced(sched_b), "a_accounting": balanced(sched_a),
        "counters": counters(fetcher.metrics),
    }


def test_a_fetched_block_decodes_as_a_local_restore_and_as_the_jax_package(params):
    got = _fetch_adopt_restore("port", params)
    n = got["adopted"]
    assert got["fetched"] == got["local"] == got["first"]
    # the adopted pages were RESTORED (one copy each), not recomputed
    assert got["b_restores"] == got["b_hits"] == got["a_restores"] == n == 5
    assert got == _fetch_adopt_restore("jax", params)


def _contiguous_prefix(side, params):
    sched_a, gen_a, store_a = replica(side, params, mirror=True)
    run(sched_a, side, max_tokens=4)
    hashes = prompt_hashes(side, gen_a)
    tokens = gen_a.tokenizer.encode(PROMPT)
    out = []
    for gap in (0, 2):  # serve every block but one: adoption stops at the gap
        index = SIDES[side].fab.FabricIndex()
        index.update("a", [h.hex() for h in hashes], url="http://a")
        _, _, store_b = replica(side, params)
        served = {h: p for h, p in pooled(store_a, hashes).items() if h != hashes[gap].hex()}
        fetcher = _fetcher(SIDES[side], index, _served(SIDES[side], served), self_id="b")
        adopted = asyncio.run(fetcher.prefetch(tokens, store=store_b))
        out.append([adopted, [store_b.restorable(h) for h in hashes], counters(fetcher.metrics)])
    assert [o[0] for o in out] == [0, 2]
    return out


def test_prefetch_adopts_only_the_contiguous_prefix(params):
    assert _contiguous_prefix("port", params) == _contiguous_prefix("jax", params)


def test_prefetch_without_a_pool_is_a_noop(params):
    def noop(side):
        _, _, store = replica(side, params, pool_mb=0)
        fetcher = _fetcher(SIDES[side], SIDES[side].fab.FabricIndex(), _served(SIDES[side], {}))
        return [asyncio.run(fetcher.prefetch(list(range(48)), store=store)), len(store),
                counters(fetcher.metrics)]

    assert noop("port") == noop("jax") == [0, 0, noop("port")[2]]


def _engine(side, params, *, mirror=False):
    sched, generator, store = replica(side, params, mirror=mirror)
    if side == "jax":
        return JaxServingEngine(generator, scheduler=sched), store
    return ServingEngine(generator, sched), store


async def _close(engine):
    if isinstance(engine, ServingEngine):
        await asyncio.to_thread(engine.close)
    else:
        await engine.close()


def _engine_prefetch(side, params):
    """``ServingEngine.generate`` with a fetcher: the prefetch adopts the
    holder's blocks before admission and the request restores them."""
    sched_a, gen_a, store_a = replica(side, params, mirror=True)
    ref = run(sched_a, side)
    hashes = prompt_hashes(side, gen_a)
    index = SIDES[side].fab.FabricIndex()
    index.update("a", [h.hex() for h in hashes], url="http://a")
    engine, store = _engine(side, params)
    engine.fabric = _fetcher(SIDES[side], index, _served(SIDES[side], pooled(store_a, hashes)),
                             self_id="b", metrics=engine.generator.metrics)
    seen = []
    probe, adopt = store.probe, store.adopt_host

    def where():
        if side == "port":
            seen.append((threading.current_thread() is engine._thread,
                         engine._work_lock.locked()))

    def spy_probe(tokens):
        where()
        return probe(tokens)

    def spy_adopt(h, parent, tokens):
        where()
        return adopt(h, parent, tokens)

    store.probe, store.adopt_host = spy_probe, spy_adopt

    async def drive():
        try:
            result = await asyncio.wait_for(engine.generate(PROMPT, greedy(side, 8)), TIMEOUT_S)
            return list(result.token_ids)
        finally:
            await _close(engine)

    tokens = asyncio.run(drive())
    metrics = engine.generator.metrics
    return {"tokens": tokens, "ref": ref, "seen": seen,
            "restores": metrics.counter("kv_restore"), "counters": counters(metrics)}


def test_engine_prefetch_runs_probe_and_adopt_on_the_worker_under_its_lock(params):
    got = _engine_prefetch("port", params)
    # one probe and five adoptions, each on the worker thread, lock held
    assert got["seen"] == [(True, True)] * 6
    assert got["tokens"] == got["ref"]
    assert got["restores"] == got["counters"]["fabric_prefetch_adopted"] == 5
    ref = _engine_prefetch("jax", params)
    assert {k: v for k, v in got.items() if k != "seen"} == {
        k: v for k, v in ref.items() if k != "seen"}


def test_engine_without_holders_never_tokenizes_for_the_fabric(params):
    """The cheap gates: an empty index (or no pool) costs the request no
    probe, no tokenize and no store task."""
    engine, store = _engine("port", params)
    engine.fabric = _fetcher(SIDES["port"], fabric.FabricIndex(), _served(SIDES["port"], {}))
    encodes = []
    tokenizer = engine.generator.tokenizer
    encode = tokenizer.encode
    tokenizer.encode = lambda text: encodes.append(text) or encode(text)
    store.probe = lambda tokens: pytest.fail("probed with an empty index")

    async def drive():
        try:
            return await asyncio.wait_for(engine.generate(PROMPT, greedy("port", 2)), TIMEOUT_S)
        finally:
            await _close(engine)

    asyncio.run(drive())
    assert encodes == [PROMPT]  # the enqueue's own tokenize only


# ---------------------------------------------------------------------------
# GET /kv/blocks/{hash}
# ---------------------------------------------------------------------------


def test_kv_blocks_route_as_the_jax_server(params):
    """Both servers over engines that mirrored the same prompt: a pooled
    block answers 200 with ``encode_block``'s bytes, an unpooled one 404,
    a malformed hash 400, a missing token 401 — the JAX server's statuses
    and messages."""
    answers = {}
    blobs = {}
    with event_loop_thread() as loop:
        for side in ("jax", "port"):
            engine, store = _engine(side, params, mirror=True)
            cls = JaxCompletionServer if side == "jax" else CompletionServer
            server = cls(engine, model_id="tiny-test", host="127.0.0.1", port=0,
                         api_token=TOKEN)
            loop(server.start())
            try:
                async def warm():
                    return await engine.generate(PROMPT, greedy(side, 2))

                loop(warm())
                hashes = prompt_hashes(side, engine.generator)
                h = hashes[1].hex()
                port = server.bound_port
                status, head, body = call(port, "GET", f"/kv/blocks/{h}")
                assert status == 200 and "application/octet-stream" in head
                k, v = store.host_pool.get(hashes[1])
                assert body == SIDES[side].fab.encode_block(hashes[1], k, v)
                blobs[side] = (body, k, v)
                answers[side] = [
                    (s, json.loads(b)["error"]["message"]) for s, _, b in (
                        call(port, "GET", "/kv/blocks/" + "0" * 32),
                        call(port, "GET", "/kv/blocks/XYZ"),
                        call(port, "GET", "/kv/blocks/" + "G" * 32),
                        call(port, "GET", f"/kv/blocks/{h}", token=None),
                        call(port, "GET", f"/kv/blocks/{h}", token="wrong"),
                    )
                ]
            finally:
                loop(server.stop())
                loop(_close(engine))
    assert [s for s, _ in answers["port"]] == [404, 400, 400, 401, 401]
    assert answers["port"] == answers["jax"]
    # the JAX package reads the port's block: the pooled page's exact values
    _h, k, v = jax_fabric.decode_block(blobs["port"][0])
    assert bits(k) == bits(blobs["port"][1]) and bits(v) == bits(blobs["port"][2])


# ---------------------------------------------------------------------------
# two-leg prefill/decode dispatch over two engines
# ---------------------------------------------------------------------------


def _two_legs(side, params, prompts, max_tokens=6):
    """A prefill engine P (mirror on) and a decode engine D (fabric on,
    its index the router's health board, its transport P's
    ``kv_block_bytes``); each request as two legs, the board refreshed
    from P's load report after each prefill leg."""
    ns = SIDES[side]
    engine_p, _ = _engine(side, params, mirror=True)
    engine_d, _ = _engine(side, params)
    engine_p.replica_role, engine_d.replica_role = "prefill", "decode"
    router = ns.router([ns.replica("p", "inproc://p"), ns.replica("d", "inproc://d")])
    engines = {"p": engine_p, "d": engine_d}
    router.report_load("p", engine_p.load_report())
    router.report_load("d", engine_d.load_report())

    async def transport(url, budget_s):
        data = engine_p.kv_block_bytes(url.rsplit("/", 1)[-1])
        return (404, b"") if data is None else (200, data)

    metrics = ns.metrics()
    engine_d.fabric = ns.fab.FabricFetcher(router.health.kv_index, transport=transport,
                                           self_id="d", metrics=metrics)
    legs = []

    async def drive():
        out = []
        try:
            for prompt in prompts:
                async def prefill_send(replica, attempt, budget_s):
                    result = await engines[replica.id].generate(prompt, greedy(side, 1))
                    router.report_load("p", engine_p.load_report())
                    legs.append(("prefill", replica.id, len(result.token_ids)))
                    return result

                async def decode_send(replica, attempt, budget_s, prefix):
                    result = await engines[replica.id].generate(
                        prompt, greedy(side, max_tokens - len(prefix)), resume_tokens=prefix)
                    legs.append(("decode", replica.id, list(prefix)))
                    return SimpleNamespace(token_ids=list(prefix) + list(result.token_ids))

                pre, dec = await asyncio.wait_for(ns.disagg.disaggregated_dispatch(
                    router, prefill_send, decode_send, key=prompt, request_id=prompt[:8],
                    metrics=metrics), TIMEOUT_S)
                out.append(dec.response.token_ids)
            return out
        finally:
            await _close(engine_p)
            await _close(engine_d)

    tokens = asyncio.run(drive())
    return {"tokens": tokens, "legs": legs,
            "d_restores": engine_d.generator.metrics.counter("kv_restore"),
            "counters": counters(metrics)}


def test_two_leg_dispatch_gives_the_jax_package_tokens(params):
    """The same greedy tokens and legs as the JAX package.  The port's
    decode legs fetch every full block of each prompt; the JAX engine's
    prefill replica leaves a one-token leg's mirrored blocks pending until
    a next commit window its idle worker never reaches, so its decode
    legs get 404s and recompute (the port lands them before the leg
    settles: ``Scheduler.drain_mirror``)."""
    prompts = [PROMPT, SECOND]
    got = _two_legs("port", params, prompts)
    ref = _two_legs("jax", params, prompts)
    assert got["tokens"] == ref["tokens"] and got["legs"] == ref["legs"]
    assert [leg[:2] for leg in got["legs"]] == [("prefill", "p"), ("decode", "d")] * 2
    assert got["counters"]["fabric_disagg_handoff"] == ref["counters"][
        "fabric_disagg_handoff"] == len(prompts)
    blocks = 5 + 3
    assert got["counters"]["fabric_fetch_ok"] == got["counters"]["fabric_prefetch_adopted"] \
        == got["d_restores"] == blocks
    assert got["counters"]["fabric_fetch_miss"] == got["counters"]["fabric_fetch_fallback"] == 0
    assert ref["counters"]["fabric_fetch_miss"] == ref["counters"]["fabric_index_evicted"] \
        == blocks and ref["d_restores"] == 0
    # and a two-leg greedy answer is the one-replica answer
    one_replica = _fetch_adopt_restore("port", params)["first"][:6]
    assert got["tokens"][0] == one_replica
