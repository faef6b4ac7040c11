"""Guided decoding and multi-LoRA on the wave engine, on the card.

A small int8 engine (``TINY_TEST``, bf16 activations) with two seeded
adapters on the card: a decode block of guided and adapted rows is
enqueued with PyTorch's sync debug mode set to error, so any host sync
inside the block (an ``.item()``, a ``.cpu()``, a data-dependent shape)
raises; the block launches the decode kernel once per layer per step,
and the DFA state it carries on the device equals a host replay of the
block's tokens through the transition tables.  A whole drive of such
rows stays in its languages.  Skips without a card (``cuda`` marker);
this file imports no JAX::

    python -m pytest tests/test_torch_guided_cuda.py -q
"""

import importlib
import re

import pytest

torch = pytest.importorskip("torch")

from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, init_params  # noqa: E402

# the module: the package's ``paged_attention`` is the function, as in JAX
paged_attention = importlib.import_module("operator_tpu_torch.ops.paged_attention")
from operator_tpu_torch.parallel.lora import init_lora  # noqa: E402
from operator_tpu_torch.serving.engine import Generator  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

CHOICES = ("CrashLoopBackOff", "OOMKilled", "Error")
REGEX = r"exit code [0-9]{1,3}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _generator():
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(TINY_TEST, gen, torch.bfloat16, device="cuda", quantize=True)
    adapters = {}
    for name in ("incident", "verbose"):
        adapter = init_lora(TINY_TEST, gen, rank=8, device="cuda")
        for factors in adapter.values():
            factors["b"] = (torch.randn(factors["b"].shape, generator=gen, device="cuda")
                            * 0.2).to(torch.bfloat16)
        adapters[name] = adapter
    return Generator(params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=128,
                     page_size=16, decode_block=4, pipeline_depth=1, device="cuda",
                     lora_adapters=adapters)


SAMPLING = [
    SamplingParams(max_tokens=24, temperature=0.8, stop_on_eos=False,
                   guided_choice=CHOICES, adapter="incident"),
    SamplingParams(max_tokens=24, temperature=0.0, stop_on_eos=False, guided_regex=REGEX),
    SamplingParams(max_tokens=24, temperature=0.7, stop_on_eos=False, adapter="verbose"),
]


@pytest.mark.cuda
def test_guided_adapted_block_stays_on_the_device(cuda):
    g = _generator()
    slots = g.admit(["severity?", "how many?", "free text"], SAMPLING)
    tables = g._guided_tables.cpu()
    aut = g.guided_aut.cpu()
    before = g.guided_state.cpu()
    _, temp, top_p, active, idx = g._sampling_tensors()
    paged_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, toks, _, state = g._decode_block_paged(
            g.params, g.paged_cache, g.last_tokens, temp, top_p, active, g.lora, idx,
            g._guided_tables, g.guided_aut, g.guided_state,
        )
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert paged_attention.launches == TINY_TEST.num_layers * g.decode_block
    toks = toks.cpu()
    for slot in slots[:2]:  # the guided rows
        s = int(before[slot])
        for k in range(g.decode_block):
            s = int(tables[int(aut[slot]), s, int(toks[k, slot])])
            assert s >= 0
        assert int(state[slot]) == s


@pytest.mark.cuda
def test_guided_adapted_drive_stays_in_its_languages(cuda):
    g = _generator()
    slots = g.admit(["severity?", "how many?", "free text"], [
        SamplingParams(max_tokens=24, temperature=0.8, guided_choice=CHOICES,
                       adapter="incident"),
        SamplingParams(max_tokens=24, temperature=0.0, guided_regex=REGEX),
        SamplingParams(max_tokens=8, temperature=0.7, adapter="verbose"),
    ])
    results = {}
    while g.num_active:
        for slot_id, result in g.step():
            results[slot_id] = result
    assert results[slots[0]].text in CHOICES
    assert re.fullmatch(REGEX, results[slots[1]].text)
    assert g._guided_tables is None
    assert g.allocator.available == g.allocator.num_pages - 1
