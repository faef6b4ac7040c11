"""One rank of the port's sharded-serving tests (``test_torch_sharded_serving.py``).

    python tests/_torch_serve_worker.py <task> <rank> <world> <workdir>

Imports torch and the port only (no JAX: the JAX package's weights come
from the pytest process in ``<workdir>/inputs.npz``, and its expected
tokens stay there, where the test compares).  The ranks meet through a
``FileStore`` under ``<workdir>``; rank 0 writes ``<workdir>/result.json``
(what each case produced) and every rank prints ``<TASK>-OK``.  A task
is one mesh launch; its cases are the JAX mesh tests it mirrors:

- ``dp2tp2`` (4 ranks): greedy tokens on the contiguous and paged
  caches, two waves into recycled slots, a shared prefix, int8 weights,
  a chunked job with a live decode between its chunks, a guided wave
  through a chunked job;
- ``fsdp2tp2`` and ``dp4`` (4 ranks): greedy tokens on both caches; on
  dp4 also one- and three-prompt waves (their buckets);
- ``eight`` (8 ranks, dp2·fsdp2·tp2, then dp4·tp2): multi-LoRA tokens
  and the adapted forward's logits, a shared prefix, guided rows beside
  a greedy one, chunked against one-shot on both caches, the paged
  engine of ``__graft_entry__.dryrun_multichip``; on dp4·tp2 the
  prefill and six greedy steps of ``tests/_dcn_decode_worker.py``, each
  data rank's row;
- ``tp4`` (4 ranks): llama-3-8b's attention and vocabulary width (two
  layers) and the dryrun's tp4 leg (KV heads 4, q/k/v biases) in int8,
  each against the same engine on one rank;
- ``provider`` (2 ranks): ``build_serving_engine`` with
  ``SERVING_MESH=dp=1,tp=2`` (rank 0 serves, rank 1 follows) against the
  unsharded engine, from seeded weights and from a checkpoint through
  the sharded load, and the sharded load's leaves against
  ``load_params``'s, int8 and bf16;
- ``dead_follower`` (2 ranks): rank 1 dies after its build; rank 0's
  request fails within the group's timeout instead of hanging.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, configs, get_config  # noqa: E402
from operator_tpu_torch.models import init_params  # noqa: E402
from operator_tpu_torch.models.llama import KVCache, forward, params_from_jax  # noqa: E402
from operator_tpu_torch.models.tokenizer import load_tokenizer  # noqa: E402
from operator_tpu_torch.parallel.mesh import MeshPlan, ServingShard, make_mesh  # noqa: E402
from operator_tpu_torch.parallel.mesh import tree_leaves  # noqa: E402
from operator_tpu_torch.serving.engine import Generator  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

GREEDY12 = SamplingParams(max_tokens=12, temperature=0.0, stop_on_eos=False)
GREEDY6 = SamplingParams(max_tokens=6, temperature=0.0, stop_on_eos=False)
GREEDY10 = SamplingParams(max_tokens=10, temperature=0.0, stop_on_eos=False)
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
#: the provider task's checkpoint model: the committed SentencePiece-style
#: tokenizer's 1,405 ids need a wider vocabulary than tiny-test's
SP_CONFIG = dataclasses.replace(TINY_TEST, name="tiny-test-sp", vocab_size=1536)
#: ``tests/test_chunked_prefill.py``'s prompts: buckets of 128 and 64 tokens
CHUNK_PROMPTS = [
    "pod was OOMKilled " * 7,
    "short prompt",
    "disk pressure eviction event " * 4,
]


def unflatten(arrays: dict, prefix: str) -> dict:
    """The nested tree stored under ``prefix.`` in dotted keys."""
    tree: dict = {}
    for key, value in arrays.items():
        if not key.startswith(prefix + "."):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return params_from_jax(tree)


def drain(generator, prompts, sampling) -> list:
    """Admit every prompt as one wave, decode to the end; token ids per prompt."""
    sampling = sampling if isinstance(sampling, list) else [sampling] * len(prompts)
    slots = generator.admit(prompts, sampling)
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    return [results[s].token_ids for s in slots]


def texts(generator, prompts, sampling) -> list:
    slots = generator.admit(prompts, sampling)
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    return [(results[s].text, results[s].token_ids) for s in slots]


def gen(params, mesh, config=TINY_TEST, tokenizer=None, **kw):
    """The generator shapes of the JAX mesh tests (f32, page 16)."""
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", 128)
    kw.setdefault("paged", True)
    return Generator(params, config, tokenizer or ByteTokenizer(), page_size=16,
                     cache_dtype=torch.float32, device="cpu", mesh=mesh, **kw)


def buckets(generator) -> list:
    return sorted(n for n, *_ in generator._prefill_fns)


def sharded_plain(params, mesh, config=TINY_TEST) -> bool:
    """The generator's layer matrices really are this rank's shards."""
    return tuple(gen(params, mesh, config).params["layers"]["wq"].shape) != tuple(
        params["layers"]["wq"].shape)


# -- tasks --------------------------------------------------------------------


def task_dp2tp2(inputs: dict, out: dict) -> None:
    params, q8 = unflatten(inputs, "params"), unflatten(inputs, "q8")
    mesh = make_mesh(MeshPlan(dp=2, tp=2), device_type="cpu")
    shard = ServingShard(mesh)
    out["wq_local"] = list(gen(params, mesh).params["layers"]["wq"].shape)
    for paged in (False, True):
        out[f"tokens_{paged}"] = drain(gen(params, mesh, paged=paged, tokenizer=load_tokenizer(None)),
                                       PROMPTS, GREEDY12)
    g = gen(params, mesh, tokenizer=load_tokenizer(None))
    first = g.admit(PROMPTS[:2], [GREEDY12] * 2)
    waves = []
    while g.num_active:
        waves += [r.token_ids for _, r in g.step()]
    second = g.admit(PROMPTS[2:], [GREEDY12] * 2)
    while g.num_active:
        waves += [r.token_ids for _, r in g.step()]
    out["waves"] = {"tokens": waves, "reused": sorted(set(second) - set(first)) == []}
    g = gen(params, mesh, max_seq=512, decode_block=2)
    out["prefix_cached"] = g.set_shared_prefix(PREFIX)
    out["prefix_tokens"] = drain(g, [PREFIX + "mesh pod one", PREFIX + "mesh pod two"], GREEDY6)
    out["q8_tokens"] = drain(gen(q8, mesh, decode_block=2),
                             ["crash a", "oom b", "exit c", "fail d"], GREEDY10)
    out["q8_local"] = list(gen(q8, mesh).params["layers"]["wq"]["q"].shape)
    # a chunked job beside a live decode
    g = gen(params, mesh, max_seq=160, decode_block=2, prefill_chunk=16)
    [early] = g.admit(["short prompt"], [GREEDY6])
    while g._prefill_job is not None:
        g.step()
    before = len(g.slots[early].generated)
    g.admit([CHUNK_PROMPTS[0]], [GREEDY6])
    job = g._prefill_job is not None
    g.step()
    advanced = g._prefill_job is None or len(g.slots[early].generated) > before
    while g.num_active:
        g.step()
    out["interleave"] = {"job": job, "advanced": advanced}
    # guided rows admitted through a chunked job
    g = gen(params, mesh, decode_block=2, prefill_chunk=16)
    long_prompt = "classify the severity of this oom killed pod " * 2
    sampling = [SamplingParams(max_tokens=16, temperature=1.0, guided_choice=CHOICES),
                SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)]
    slots = g.admit([long_prompt, "free " + long_prompt], sampling)
    job = g._prefill_job is not None
    results = {}
    while g.num_active:
        for slot_id, result in g.step():
            results[slot_id] = result
    out["guided_chunked"] = {"job": job, "text": results[slots[0]].text,
                             "free_len": len(results[slots[1]].token_ids)}
    out["data_rank"] = shard.data_rank


def task_fsdp2tp2(inputs: dict, out: dict) -> None:
    params = unflatten(inputs, "params")
    mesh = make_mesh(MeshPlan(fsdp=2, tp=2), device_type="cpu")
    out["sharded"] = sharded_plain(params, mesh)
    for paged in (False, True):
        out[f"tokens_{paged}"] = drain(gen(params, mesh, paged=paged, tokenizer=load_tokenizer(None)),
                                       PROMPTS, GREEDY12)


def task_dp4(inputs: dict, out: dict) -> None:
    params = unflatten(inputs, "params")
    mesh = make_mesh(MeshPlan(dp=4), device_type="cpu")
    for paged in (False, True):
        g = gen(params, mesh, paged=paged, tokenizer=load_tokenizer(None))
        out[f"tokens_{paged}"] = drain(g, PROMPTS, GREEDY12)
        g = gen(params, mesh, paged=paged, tokenizer=load_tokenizer(None))
        out[f"one_{paged}"] = drain(g, PROMPTS[:1], GREEDY12)
        out[f"one_buckets_{paged}"] = buckets(g)
    g = gen(params, mesh, paged=False, tokenizer=load_tokenizer(None))
    out["three"] = drain(g, PROMPTS[:3], GREEDY12)
    out["three_buckets"] = buckets(g)


def task_eight(inputs: dict, out: dict) -> None:
    params = unflatten(inputs, "params")
    mesh = make_mesh(MeshPlan(dp=2, fsdp=2, tp=2), device_type="cpu")
    shard = ServingShard(mesh)
    # multi-LoRA: the engine's tokens and the adapted forward's logits
    adapter = unflatten(inputs, "lora")
    lora_gen = gen(params, mesh, decode_block=2, lora_adapters={"incident": adapter})
    sampling = [SamplingParams(max_tokens=6, temperature=0.0, stop_on_eos=False, adapter=name)
                for name in (None, "incident", None, "incident")]
    out["lora_tokens"] = drain(lora_gen, ["a", "b", "c", "d"], sampling)
    ids = torch.from_numpy(inputs["lora_ids"]).long()
    positions = torch.arange(ids.shape[1])[None].expand(ids.shape)
    logits, _ = forward(lora_gen.params, TINY_TEST, ids, positions, lora=lora_gen.lora,
                        lora_alpha=lora_gen.lora_alpha,
                        lora_indices=torch.from_numpy(inputs["lora_rows"]).long(), shard=shard)
    out["lora_logits_err"] = float(np.abs(logits.numpy() - inputs["lora_logits"]).max())
    g = gen(params, mesh, max_seq=512, decode_block=2)
    out["prefix_cached"] = g.set_shared_prefix(PREFIX)
    out["prefix_tokens"] = drain(g, [PREFIX + "mesh pod one", PREFIX + "mesh pod two"], GREEDY6)
    free = SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)
    out["guided"] = texts(gen(params, mesh, decode_block=2),
                          ["free prompt", "severity?", "pick", "choose"],
                          [free,
                           SamplingParams(max_tokens=16, temperature=0.9, guided_choice=CHOICES),
                           SamplingParams(max_tokens=16, temperature=1.2,
                                          guided_choice=("yes", "no")),
                           SamplingParams(max_tokens=16, temperature=0.0, guided_choice=CHOICES)])
    for paged in (False, True):
        out[f"chunked_{paged}"] = [
            drain(gen(params, mesh, max_seq=160, decode_block=2, paged=paged,
                      prefill_chunk=chunk), CHUNK_PROMPTS, GREEDY6)
            for chunk in (64, None)
        ]
    dry = unflatten(inputs, "dry")
    g = gen(dry, mesh, decode_block=2, tokenizer=load_tokenizer(None))
    out["dryrun"] = drain(g, ["pod failed with exit code 137"] * 4,
                          SamplingParams(max_tokens=4, temperature=0.0, stop_on_eos=False))
    # the dp4·tp2 prefill and six greedy steps, each data rank's row
    mesh = make_mesh(MeshPlan(dp=4, tp=2), device_type="cpu")
    shard = ServingShard(mesh)
    local = shard.local_params(params, TINY_TEST, quantized=False)
    prompts = torch.from_numpy(inputs["dcn_prompts"]).long()[shard.rows(4)]
    steps, t = int(inputs["dcn_steps"]), prompts.shape[1]
    cache = KVCache.create(TINY_TEST, 1, t + steps, dtype=torch.float32, device="cpu",
                           kv_heads=TINY_TEST.num_kv_heads // shard.tp)
    logits, cache = forward(local, TINY_TEST, prompts, torch.arange(t)[None], cache=cache,
                            cache_offset=0, shard=shard)
    tok, row = logits[:, -1].argmax(-1), []
    for i in range(steps):
        row.append(int(tok[0]))
        offsets = torch.full((1,), t + i)
        logits, cache = forward(local, TINY_TEST, tok[:, None], offsets[:, None], cache=cache,
                                cache_offset=offsets, shard=shard)
        tok = logits[:, -1].argmax(-1)
    rows = [torch.zeros(steps, dtype=torch.int64) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, torch.tensor(row))
    out["dcn_all"] = [r.tolist() for r in rows]
    out["dcn_data_ranks"] = gathered_data_ranks(shard)


def gathered_data_ranks(shard) -> list:
    ranks = [torch.zeros(1, dtype=torch.int64) for _ in range(dist.get_world_size())]
    dist.all_gather(ranks, torch.tensor([shard.data_rank]))
    return [int(r) for r in ranks]


def task_tp4(inputs: dict, out: dict) -> None:
    from operator_tpu_torch.models.quant import quantize_params

    mesh = make_mesh(MeshPlan(tp=4), device_type="cpu")
    sampling = SamplingParams(max_tokens=3, temperature=0.0, stop_on_eos=False)
    config = dataclasses.replace(get_config("llama-3-8b"), num_layers=2, hidden_size=1024,
                                 intermediate_size=3584, max_seq_len=256,
                                 name="llama-3-8b-attnwidth")
    params = init_params(config, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    prompts = ["pod oomkilled", "probe failed"]
    out["width8b"] = drain(gen(params, mesh, config, max_slots=2, tokenizer=load_tokenizer(None)),
                           prompts, sampling)
    out["width8b_one"] = drain(gen(params, None, config, max_slots=2,
                                   tokenizer=load_tokenizer(None)), prompts, sampling)
    out["width8b_local"] = list(ServingShard(mesh).local_shape(params["lm_head"].shape,
                                                              (None, "tp")))
    del params
    tp4 = dataclasses.replace(TINY_TEST, num_kv_heads=4, num_heads=8, name="tiny-tp4",
                              attention_bias=True)
    q8 = quantize_params(init_params(tp4, torch.Generator().manual_seed(3), torch.float32,
                                     device="cpu"), tp4)
    greedy = SamplingParams(max_tokens=4, temperature=0.0, stop_on_eos=False)
    prompts = ["container exceeded memory limit"] * 2
    out["tp4_q8"] = drain(gen(q8, mesh, tp4, max_slots=2, decode_block=2,
                              tokenizer=load_tokenizer(None)), prompts, greedy)
    out["tp4_q8_one"] = drain(gen(q8, None, tp4, max_slots=2, decode_block=2,
                                  tokenizer=load_tokenizer(None)), prompts, greedy)


def task_provider(inputs: dict, out: dict, workdir: str) -> None:
    from operator_tpu_torch.models.loader import load_params
    from operator_tpu_torch.serving.meshserve import MeshFollower
    from operator_tpu_torch.serving.provider import build_serving_engine

    env = {"OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
           "SCHED_MODE": "wave", "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16",
           "DECODE_BLOCK": "2"}
    prompts = ["pod crashed", "oom killed", "probe failed", "exit 137"]
    greedy = SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)
    # the checkpoint's model: tiny-test with room for its tokenizer's ids
    configs._REGISTRY[SP_CONFIG.name] = SP_CONFIG
    for source, extra in (("seeded", {}),
                          ("checkpoint", {"CHECKPOINT_DIR": os.path.join(workdir, "ckpt"),
                                          "OPERATOR_TPU_MODEL": SP_CONFIG.name,
                                          "ALLOW_RANDOM_WEIGHTS": "false",
                                          "WEIGHT_DTYPE": "int8"})):
        engine, _ = build_serving_engine("cpu", {**env, **extra, "SERVING_MESH": "dp=1,tp=2"})
        if dist.get_rank() != 0:
            assert isinstance(engine, MeshFollower)
            engine.run()
            out[f"{source}_follower_calls"] = engine.calls
            continue
        try:
            got = [r.token_ids for r in engine.generate_batch(prompts, greedy)]
            out[f"{source}_local_wq"] = list(tree_leaves(engine.generator.params["layers"]["wq"])[0]
                                             .shape)
            out[f"{source}_sent"] = engine.generator.mirror.sent
        finally:
            engine.close()
        plain, _ = build_serving_engine("cpu", {**env, **extra})
        try:
            want = [r.token_ids for r in plain.generate_batch(prompts, greedy)]
            out[f"{source}_tokens"] = [got, want]
            out[f"{source}_margins"] = [
                divergence_margin(plain.generator, prompt, a, b)
                for prompt, a, b in zip(prompts, got, want)]
        finally:
            plain.close()
    # the sharded load: each rank's leaves against its cut of the whole load
    mesh = make_mesh(MeshPlan(tp=2), device_type="cpu")
    shard = ServingShard(mesh)
    for quantize in (True, False):
        whole = load_params(os.path.join(workdir, "ckpt"), SP_CONFIG, torch.bfloat16,
                            device="cpu", quantize=quantize)
        mine = load_params(os.path.join(workdir, "ckpt"), SP_CONFIG, torch.bfloat16,
                           device="cpu", quantize=quantize, mesh=mesh)
        want = shard.local_params(whole, SP_CONFIG, quantized=quantize)
        pairs = list(zip(tree_leaves(mine), tree_leaves(want)))
        out[f"load_equal_{quantize}_{dist.get_rank()}"] = all(
            a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
        out[f"load_smaller_{quantize}"] = (
            sum(a.numel() for a, _ in pairs) < sum(t.numel() for t in tree_leaves(whole)))
    flags = [torch.zeros(1) for _ in range(dist.get_world_size())]
    dist.all_gather(flags, torch.tensor([float(all(v for k, v in out.items()
                                                   if k.startswith("load_equal")))]))
    out["load_equal_all_ranks"] = [bool(f.item()) for f in flags]


def divergence_margin(generator, prompt: str, got: list, want: list):
    """Where ``got`` first leaves ``want`` (the unsharded engine's greedy
    tokens), the unsharded model's top-two logit margin there, teacher
    forced over the prompt and ``want``; None where they agree."""
    diverged = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if diverged is None:
        return None
    ids = generator.tokenizer.encode(prompt) + want
    positions = torch.arange(len(ids))[None]
    logits, _ = forward(generator.params, generator.config, torch.tensor([ids]), positions)
    top = logits[0, len(ids) - len(want) - 1 + diverged].topk(2).values
    return float(top[0] - top[1])


def task_dead_follower(workdir: str) -> None:
    """Rank 1 builds its follower and dies; rank 0's requests must fail
    (not hang) and the engine must report itself down."""
    from operator_tpu_torch.serving.provider import build_serving_engine

    env = {"OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
           "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16", "PREFIX_CACHE": "false",
           "SERVING_MESH": "dp=1,tp=2"}
    engine, _ = build_serving_engine("cpu", env)
    if dist.get_rank() != 0:
        os._exit(0)  # the follower dies before its first call
    started = time.monotonic()
    try:
        engine.generate_batch(["pod crashed"], SamplingParams(max_tokens=4, temperature=0.0))
        outcome = "served"
    except Exception as exc:  # noqa: BLE001 - the outcome under test
        outcome = type(exc).__name__
    out = {"outcome": outcome, "seconds": time.monotonic() - started,
           "load": dataclasses.asdict(engine.load_report())}
    with open(os.path.join(workdir, "result.json"), "w") as fh:
        json.dump(out, fh, default=str)
    print("DEAD_FOLLOWER-OK rank=0", flush=True)
    os._exit(0)  # the group cannot be torn down with a rank gone


TASKS = {"dp2tp2": task_dp2tp2, "fsdp2tp2": task_fsdp2tp2, "dp4": task_dp4,
         "eight": task_eight, "tp4": task_tp4}


def main() -> None:
    task, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.manual_seed(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=120))
    path = os.path.join(workdir, "inputs.npz")
    inputs = dict(np.load(path, allow_pickle=False)) if os.path.exists(path) else {}
    out: dict = {}
    if task == "dead_follower":
        task_dead_follower(workdir)
    if task == "provider":
        task_provider(inputs, out, workdir)
    else:
        TASKS[task](inputs, out)
    dist.barrier()
    if rank == 0:
        with open(os.path.join(workdir, "result.json"), "w") as fh:
            json.dump(out, fh)
    print(f"{task.upper()}-OK rank={rank}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
