"""The deployed model's geometry on the CPU: llama-3-8b cut to size, served
through both packages' continuous schedulers with the byte-level
tokenizer fixture.

The config is a ``dataclasses.replace`` of each package's ``LLAMA_3_8B``:
2 layers, hidden 512, 4 query heads over 1 KV head of width 128 (the
group of 4 and the head width of llama-3-8b), rope theta 500,000 and the
full 128,256-id vocab, so the specials' ids (128,000 and up) are real and
the sampled ids mostly lie outside the fixture's vocab.  The same f32
weights (the JAX ``init_params``, moved by ``params_from_jax``) must give
the same greedy tokens and the same decoded text in both.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import configs as jax_configs  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu.serving.sched import Scheduler as JaxScheduler  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry  # noqa: E402
from operator_tpu_torch.models import configs, params_from_jax  # noqa: E402
from operator_tpu_torch.models.tokenizer import HFTokenizer, load_tokenizer  # noqa: E402
from operator_tpu_torch.serving.engine import Generator  # noqa: E402
from operator_tpu_torch.serving.sched import Scheduler  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from test_torch_tokenizer import LLAMA3_BL, fixture_lines  # noqa: E402

CUT = dict(num_layers=2, hidden_size=512, intermediate_size=1792, num_heads=4,
           num_kv_heads=1, head_dim=128)
PROMPTS = [
    fixture_lines()[0],
    "Pod payments-7f9c OOMKilled (exit 137): it's the JVM heap — réessayer 3× 😀",
    "\n".join(fixture_lines()[5:9]),
]
MAX_TOKENS = 8


def _config(module):
    config = dataclasses.replace(module.LLAMA_3_8B, **CUT)
    assert (config.vocab_size, config.rope_theta) == (128256, 500_000.0)
    assert config.num_heads // config.num_kv_heads == 4 and config.head_dim == 128
    return config


def _drive(sched, sampling) -> list:
    ids = [sched.enqueue(prompt, sampling) for prompt in PROMPTS]
    done = {}
    for _ in range(400):
        for outcome in sched.step():
            done[outcome.req_id] = outcome
        if len(done) == len(ids):
            break
    assert len(done) == len(ids)
    return [(done[i].result.token_ids, done[i].result.text) for i in ids]


def test_llama3_geometry_with_the_byte_level_tokenizer_matches_jax():
    jax_config, config = _config(jax_configs), _config(configs)
    jax_params = jax_init_params(jax_config, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    jax_tok, tok = jax_load_tokenizer(LLAMA3_BL), load_tokenizer(LLAMA3_BL)
    assert isinstance(tok, HFTokenizer)
    assert (tok.bos_id, tok.eos_id) == (jax_tok.bos_id, jax_tok.eos_id) == (128000, 128001)

    jax_gen = BatchedGenerator(
        jax_params, jax_config, jax_tok, max_slots=4, max_seq=256, paged=True, page_size=16,
        cache_dtype=jnp.float32, metrics=MetricsRegistry(),
    )
    want = _drive(JaxScheduler(jax_gen, chunk=32, token_budget=64),
                  JaxSamplingParams(max_tokens=MAX_TOKENS, temperature=0.0, stop_on_eos=False))
    gen = Generator(
        params, config, tok, max_slots=4, max_seq=256, page_size=16,
        cache_dtype=torch.float32, device="cpu",
    )
    got = _drive(Scheduler(gen, chunk=32, token_budget=64),
                 SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0, stop_on_eos=False))
    assert got == want
    assert all(len(ids) == MAX_TOKENS for ids, _ in got)
    # the prompts went through the byte-level tokenizer, not bytes
    assert all(tok.encode(p) == jax_tok.encode(p) for p in PROMPTS)
    assert gen.allocator.available == gen.allocator.num_pages - 1
