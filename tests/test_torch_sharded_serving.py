"""Sharded serving on the port's mesh, held to the JAX package's mesh tests.

The JAX tests put eight virtual devices in one process and hold the mesh
generator's tokens to the single-device one's.  Torch runs one rank per
process, so these launch gloo ranks (``tests/_torch_serve_worker.py``,
which imports no JAX) on the CPU, one launch per mesh shape, and hold
what they serve to the JAX single-device generator on the same weights
(``params_from_jax``), computed once here.  The ranks meet through a
``FileStore`` under the launch's directory; a launch has a 240 s limit,
and a rank that fails or hangs fails every case of its launch with every
rank's output.  Each case below states the JAX test it mirrors and
asserts what that test asserts:

- ``tests/test_sharded_serving.py``: tokens equal on dp2tp2, fsdp2tp2 and
  dp4 (contiguous and paged), the one-prompt wave padded to dp4, two
  waves into recycled slots, the mesh validation rules (on a
  ``MeshPlan``, no ranks), the three-prompt wave's dp-divisible bucket,
  multi-LoRA on dp2·fsdp2·tp2 (the JAX test is xfail there for an argmax
  near-tie: here the tokens are held equal AND the adapted forward's
  logits within ``LORA_LOGITS_TOL`` of JAX's), and the 8B factorisation
  (its wave at reduced depth on tp4 alone: eight ranks of a 128,256-row
  vocabulary do not fit this machine's memory beside the other test
  workers);
- ``tests/test_chunked_prefill.py``: chunked against one-shot on a
  dp2·fsdp2·tp2 mesh, and a live decode advancing between a job's chunks;
- ``tests/test_guided.py``: guided rows beside a greedy one on
  dp2·fsdp2·tp2, and a guided wave through a chunked job on dp2tp2;
- ``tests/test_prefix_cache.py``: a shared prefix on dp2tp2 and
  dp2·fsdp2·tp2;
- ``tests/test_quant.py``: int8 serving on dp2tp2;
- ``tests/test_distributed.py``: the dp4·tp2 prefill and six greedy steps
  of ``tests/_dcn_decode_worker.py``, each data rank's row;
- ``__graft_entry__.dryrun_multichip``'s serving legs: the paged engine
  on its dp2·fsdp2·tp2 mesh, and the tp4 leg in int8;
- the provider: ``SERVING_MESH=dp=1,tp=2`` on two ranks (rank 0 serves,
  rank 1 follows; ``close()`` ends the follower) gives the unsharded
  engine's greedy tokens, from seeded weights and from a checkpoint
  through the sharded load, whose leaves are each rank's exact slice of
  ``load_params``'s (int8 and bf16); in one process ``auto`` builds a
  one-rank mesh and ``tp=2`` raises the JAX package's device count.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.llama import forward as jax_forward  # noqa: E402
from operator_tpu.models.quant import quantize_params as jax_quantize_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.parallel import lora as jax_lora  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, get_config  # noqa: E402
from operator_tpu_torch.parallel.mesh import MeshPlan, validate_param_shardings  # noqa: E402
from operator_tpu_torch.parallel.mesh import validate_serving_mesh  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

WORKER = pathlib.Path(__file__).resolve().parent / "_torch_serve_worker.py"
#: the committed SentencePiece-style tokenizer the provider's checkpoint carries
LLAMA_SP = WORKER.parent / "torch_tokenizers" / "llama_sp"
REPO = WORKER.parent.parent
#: one launch's limit, start-up of every rank included
LAUNCH_TIMEOUT_S = 240
#: the dp2·fsdp2·tp2 adapted forward's logits against JAX's single-device
#: ones (f32; a tp all-reduce sums in another order than one matmul)
LORA_LOGITS_TOL = 2e-4
#: a bf16 near-tie: the unsharded model's top-two margin below which a
#: tp rank's differently rounded sum may pick the other token (a few bf16
#: ulps of logits of magnitude up to ~4)
BF16_TIE_TOL = 0.0625

PROMPTS = [
    "pod crashed with exit code 137",
    "OOMKilled: java heap space exhausted in payment-service",
    "liveness probe failed: connection refused on port 8080",
    "CrashLoopBackOff after node drain",
]
PREFIX = (
    "You are a Kubernetes failure analyst. Explain the failure using the "
    "pattern evidence and log excerpts provided below; answer with Root "
    "Cause and Fix sections. "
)
CHOICES = ("CRITICAL", "HIGH", "MEDIUM", "LOW")
CHUNK_PROMPTS = ["pod was OOMKilled " * 7, "short prompt", "disk pressure eviction event " * 4]


def greedy(n: int) -> JaxSamplingParams:
    return JaxSamplingParams(max_tokens=n, temperature=0.0, stop_on_eos=False)


def jax_drain(generator, prompts, sampling) -> list:
    sampling = sampling if isinstance(sampling, list) else [sampling] * len(prompts)
    slots = generator.admit(prompts, sampling)
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    return [results[s].token_ids for s in slots]


def jax_gen(params, **kw) -> BatchedGenerator:
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", 128)
    kw.setdefault("paged", True)
    return BatchedGenerator(params, JAX_TINY_TEST, JaxByteTokenizer(), page_size=16,
                            cache_dtype=jnp.float32, **kw)


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}.{key}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


# -- the JAX side, computed once ------------------------------------------------


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(the inputs every launch reads, the JAX single-device expectations)."""
    params = jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)
    q8 = jax_quantize_params(params, JAX_TINY_TEST)
    adapter = jax_lora.init_lora(JAX_TINY_TEST, jax.random.PRNGKey(11), rank=4,
                                 dtype=jnp.float32)
    adapter = {
        name: {"a": factors["a"],
               "b": jax.random.normal(jax.random.PRNGKey(12), factors["b"].shape,
                                      jnp.float32) * 0.2}
        for name, factors in adapter.items()
    }
    expect = {}
    for paged in (False, True):
        expect[f"tokens_{paged}"] = jax_drain(jax_gen(params, paged=paged), PROMPTS, greedy(12))
    expect["three"] = jax_drain(jax_gen(params, paged=False), PROMPTS[:3], greedy(12))
    expect["prefix"] = jax_drain(jax_gen(params, max_seq=512, decode_block=2),
                                 [PREFIX + "mesh pod one", PREFIX + "mesh pod two"], greedy(6))
    expect["q8"] = jax_drain(jax_gen(q8, decode_block=2),
                             ["crash a", "oom b", "exit c", "fail d"], greedy(10))
    expect["solo"] = jax_gen(params, decode_block=2).generate("free prompt", greedy(8)).token_ids
    lora_gen = jax_gen(params, decode_block=2, lora_adapters={"incident": adapter})
    expect["lora"] = jax_drain(
        lora_gen, ["a", "b", "c", "d"],
        [JaxSamplingParams(max_tokens=6, temperature=0.0, stop_on_eos=False, adapter=name)
         for name in (None, "incident", None, "incident")])
    rng = np.random.default_rng(5)
    lora_ids = rng.integers(0, JAX_TINY_TEST.vocab_size, (4, 8), dtype=np.int32)
    lora_rows = np.array([0, 1, 0, 1], np.int32)
    positions = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32)[None], (4, 8))
    logits, _ = jax_forward(params, JAX_TINY_TEST, jnp.asarray(lora_ids), positions,
                            lora=lora_gen.lora, lora_alpha=lora_gen.lora_alpha,
                            lora_indices=jnp.asarray(lora_rows))
    sys.path.insert(0, str(WORKER.parent))
    import _dcn_decode_worker as dcn

    expect["dcn"] = np.asarray(dcn.greedy_decode(params)).tolist()
    arrays = _flatten(params, "params", {})
    _flatten(q8, "q8", arrays)
    _flatten(adapter, "lora", arrays)
    _flatten(jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(2), dtype=jnp.float32),
             "dry", arrays)
    arrays.update(lora_ids=lora_ids, lora_rows=lora_rows, lora_logits=np.asarray(logits),
                  dcn_prompts=dcn.PROMPTS, dcn_steps=np.asarray(dcn.STEPS))
    inputs = tmp_path_factory.mktemp("serve_inputs") / "inputs.npz"
    np.savez(inputs, **arrays)
    return inputs, expect


def _launch(task: str, world: int, workdir: pathlib.Path, inputs=None) -> dict:
    """Run ``world`` ranks of ``task``; rank 0's result."""
    if inputs is not None:
        os.link(inputs, workdir / "inputs.npz")
    env = dict(os.environ)
    for name in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    # loopback only: gloo would otherwise pick an interface by hostname
    env.update(GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    logs = [open(workdir / f"rank{rank}.log", "w+") for rank in range(world)]
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), task, str(rank), str(world), str(workdir)],
                         stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(REPO))
        for rank, log in enumerate(logs)
    ]
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    try:
        for proc in procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    failed = [rank for rank, proc in enumerate(procs) if proc.returncode != 0]
    if failed:
        report = "\n".join(f"--- rank {rank} (exit {procs[rank].returncode}) ---\n{outputs[rank]}"
                           for rank in failed)
        pytest.fail(f"{task}: ranks {failed} failed or passed {LAUNCH_TIMEOUT_S} s:\n{report}")
    return json.loads((workdir / "result.json").read_text())


@pytest.fixture(scope="module")
def dp2tp2(jax_side, tmp_path_factory):
    return _launch("dp2tp2", 4, tmp_path_factory.mktemp("dp2tp2"), jax_side[0])


@pytest.fixture(scope="module")
def fsdp2tp2(jax_side, tmp_path_factory):
    return _launch("fsdp2tp2", 4, tmp_path_factory.mktemp("fsdp2tp2"), jax_side[0])


@pytest.fixture(scope="module")
def dp4(jax_side, tmp_path_factory):
    return _launch("dp4", 4, tmp_path_factory.mktemp("dp4"), jax_side[0])


@pytest.fixture(scope="module")
def eight(jax_side, tmp_path_factory):
    return _launch("eight", 8, tmp_path_factory.mktemp("eight"), jax_side[0])


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return _launch("tp4", 4, tmp_path_factory.mktemp("tp4"))


@pytest.fixture(scope="module")
def provider(tmp_path_factory):
    from operator_tpu_torch.models import init_params
    from operator_tpu_torch.models.loader import save_params

    workdir = tmp_path_factory.mktemp("provider")
    config = dataclasses.replace(TINY_TEST, name="tiny-test-sp", vocab_size=1536)
    params = init_params(config, torch.Generator().manual_seed(4), torch.bfloat16, device="cpu")
    save_params(params, str(workdir / "ckpt"), config)
    for name in os.listdir(LLAMA_SP):
        shutil.copy(os.path.join(LLAMA_SP, name), workdir / "ckpt")
    return _launch("provider", 2, workdir)


# -- tests/test_sharded_serving.py ---------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("launch", ["dp2tp2", "fsdp2tp2", "dp4"])
def test_sharded_matches_single_device(request, jax_side, launch, paged):
    result = request.getfixturevalue(launch)
    assert result[f"tokens_{paged}"] == jax_side[1][f"tokens_{paged}"]


def test_sharded_params_are_distributed(dp2tp2, fsdp2tp2):
    """tp (and fsdp) really cut the matrices: wq is [L, 128, 128] whole."""
    assert dp2tp2["wq_local"] == [3, 128, 64]
    assert fsdp2tp2["sharded"]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_partial_bucket_pads_to_dp(dp4, jax_side, paged):
    assert dp4[f"one_{paged}"] == jax_side[1][f"tokens_{paged}"][:1]
    assert all(n % 4 == 0 for n in dp4[f"one_buckets_{paged}"])


def test_continuous_batching_across_waves_sharded(dp2tp2, jax_side):
    """The second wave lands in the first wave's freed slots, and every
    reference sequence comes out."""
    assert dp2tp2["waves"]["reused"]
    got = {tuple(t) for t in dp2tp2["waves"]["tokens"]}
    for expected in jax_side[1]["tokens_True"]:
        assert tuple(expected) in got


def test_mesh_validation_errors():
    with pytest.raises(ValueError, match="tp=4"):
        validate_serving_mesh(MeshPlan(tp=4), TINY_TEST, 4)  # kv_heads=2
    with pytest.raises(ValueError, match="max_slots"):
        validate_serving_mesh(MeshPlan(dp=8), TINY_TEST, 4)
    validate_serving_mesh(MeshPlan(dp=2, tp=2), TINY_TEST, 4)


def test_dp_aware_admission_no_replicated_prefill(dp4, jax_side):
    assert len(dp4["three"]) == 3 and all(len(t) == 12 for t in dp4["three"])
    assert dp4["three_buckets"] and all(n % 4 == 0 for n in dp4["three_buckets"])
    assert dp4["three"] == jax_side[1]["three"]


def test_sharded_multilora_matches_single_device(eight, jax_side):
    assert eight["lora_logits_err"] <= LORA_LOGITS_TOL
    assert eight["lora_tokens"] == jax_side[1]["lora"]


class Test8BFactorisation:
    def test_8b_param_shardings_divide_tp4_dp2(self):
        config = get_config("llama-3-8b")
        assert validate_param_shardings(MeshPlan(dp=2, tp=4), config) > 10
        assert validate_param_shardings(MeshPlan(dp=2, tp=4), config, quantized=True) > 10

    def test_8b_param_shardings_divide_tp4_fsdp2(self):
        for name in ("llama-3-8b", "llama-3.1-8b", "mistral-7b", "llama-3.2-3b"):
            validate_param_shardings(MeshPlan(fsdp=2, tp=4), get_config(name), quantized=True)

    def test_width_true_8b_wave_tp4(self, tp4):
        """Both slots finish on tp4 at 8B attention and vocab width, with
        the one-rank engine's tokens; lm_head's 128,256 columns split four
        ways."""
        assert len(tp4["width8b"]) == 2 and all(len(t) == 3 for t in tp4["width8b"])
        assert tp4["width8b"] == tp4["width8b_one"]
        assert tp4["width8b_local"] == [1024, 128256 // 4]


# -- tests/test_chunked_prefill.py ----------------------------------------------


@pytest.mark.parametrize("paged", [True, False])
def test_mesh_chunked_matches_mesh_oneshot(eight, paged):
    chunked, oneshot = eight[f"chunked_{paged}"]
    assert chunked == oneshot


def test_mesh_chunked_interleaves_decodes(dp2tp2):
    assert dp2tp2["interleave"] == {"job": True, "advanced": True}


# -- tests/test_guided.py -------------------------------------------------------


def test_guided_on_mesh(eight, jax_side):
    (free, free_ids), (a, _), (b, _), (c, _) = eight["guided"]
    assert free_ids == jax_side[1]["solo"]
    assert a in CHOICES and b in ("yes", "no") and c in CHOICES


def test_guided_chunked_prefill_on_mesh(dp2tp2):
    case = dp2tp2["guided_chunked"]
    assert case["job"]
    assert case["text"] in CHOICES
    assert case["free_len"] == 8


# -- tests/test_prefix_cache.py -------------------------------------------------


@pytest.mark.parametrize("launch", ["dp2tp2", "eight"], ids=["dp2tp2", "dp2fsdp2tp2"])
def test_prefix_on_mesh(request, jax_side, launch):
    result = request.getfixturevalue(launch)
    assert result["prefix_cached"] > 0
    assert result["prefix_tokens"] == jax_side[1]["prefix"]


# -- tests/test_quant.py --------------------------------------------------------


def test_int8_serving_sharded_matches_unsharded(dp2tp2, jax_side):
    assert dp2tp2["q8_local"] == [3, 128, 64]
    assert dp2tp2["q8_tokens"] == jax_side[1]["q8"]


# -- tests/test_distributed.py and the dryrun -----------------------------------


def test_two_process_sharded_decode_parity(eight, jax_side):
    """dp4·tp2: every data rank's prefilled and decoded row equals the
    single-device reference's row."""
    for data_rank, row in zip(eight["dcn_data_ranks"], eight["dcn_all"]):
        assert row == jax_side[1]["dcn"][data_rank]


def test_dryrun_sharded_paged_decode(eight):
    assert len(eight["dryrun"]) == 4 and all(len(t) == 4 for t in eight["dryrun"])


def test_dryrun_tp4_int8_decode(tp4):
    assert len(tp4["tp4_q8"]) == 2 and all(len(t) == 4 for t in tp4["tp4_q8"])
    assert tp4["tp4_q8"] == tp4["tp4_q8_one"]


# -- the provider and the sharded load --------------------------------------------


@pytest.mark.parametrize("source", ["seeded", "checkpoint"])
def test_provider_serves_a_two_rank_mesh(provider, source):
    """bf16 weights: a tp rank's partial sums round before the all-reduce
    adds them, so a greedy sequence may leave the unsharded one only
    where the unsharded model's top two logits are within
    ``BF16_TIE_TOL`` (teacher forced there); nowhere else."""
    sharded, plain = provider[f"{source}_tokens"]
    assert [len(t) for t in sharded] == [len(t) for t in plain] == [8] * 4
    for margin in provider[f"{source}_margins"]:
        assert margin is None or margin <= BF16_TIE_TOL
    assert provider[f"{source}_local_wq"] == [3, 128, 64]
    assert provider[f"{source}_sent"] > 0


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "bf16"])
def test_sharded_load_gives_each_rank_its_slice(provider, quantize):
    assert provider["load_equal_all_ranks"] == [True, True]
    assert provider[f"load_smaller_{quantize}"]


def test_a_dead_follower_fails_requests_instead_of_hanging(tmp_path):
    """The supervisor's path: the request fails (the follower's broken
    connection surfaces at rank 0's next collective or call), well within
    the launch's limit, and the engine reports itself down."""
    result = _launch("dead_follower", 2, tmp_path)
    assert result["outcome"] != "served"
    assert result["seconds"] < 150
    assert result["load"]["gave_up"]


@pytest.fixture
def one_process_group():
    """A one-rank group made by the test is destroyed after it."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    yield
    if made and dist.is_initialized():
        dist.destroy_process_group()


def test_provider_auto_mesh_in_one_process(one_process_group, caplog):
    from operator_tpu_torch.serving.provider import build_serving_engine

    env = {"OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
           "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16", "SERVING_MESH": "auto"}
    with caplog.at_level("WARNING"):
        engine, _ = build_serving_engine("cpu", env)
    try:
        assert engine.scheduler is None  # the mesh falls back to the wave engine
        assert "mesh=True" in caplog.text
        assert engine.generator.shard.tp == 1 and engine.generator.mirror is None
        [result] = engine.generate_batch(["pod crashed"], SamplingParams(
            max_tokens=4, temperature=0.0, stop_on_eos=False))
        assert len(result.token_ids) == 4
    finally:
        engine.close()


def test_provider_mesh_needs_its_devices(one_process_group):
    from operator_tpu_torch.serving.provider import build_serving_engine

    env = {"OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
           "SERVING_MESH": "tp=2"}
    with pytest.raises(ValueError, match="needs 2 devices, found 1"):
        build_serving_engine("cpu", env)


def test_jax_package_refuses_the_same_mesh():
    """The message above is the JAX package's own."""
    from operator_tpu.serving.provider import _parse_mesh_plan

    with pytest.raises(ValueError, match="needs 2 devices, found 1"):
        _parse_mesh_plan("tp=2", jax.devices("cpu")[:1], dataclasses.replace(JAX_TINY_TEST))
