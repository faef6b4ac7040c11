"""The port's int8 parity gate (``models/quant.py:parity_report``) against
the JAX package's.

On ``TINY_TEST`` with the JAX ``PRNGKey(0)`` f32 weights bridged through
numpy, the port's report over the JAX test's two prompts and ten new
tokens must be the JAX report: ``greedy_match``, ``prompts`` and
``mismatched_prompts`` equal, ``max_logit_diff`` within 1e-4 (f32: the
two packages sum the same products in other orders).  The gate itself
holds for the port as it holds for the JAX package: token-identical
greedy decode, and the logit error under the 1B-class threshold of 0.5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.quant import parity_report as jax_parity_report  # noqa: E402
from operator_tpu.models.quant import quantize_params as jax_quantize_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, init_params, params_from_jax  # noqa: E402
from operator_tpu_torch.models.quant import (  # noqa: E402
    init_params_quantized,
    parity_report,
    quantize_params,
)

#: the JAX test's prompts (tests/test_quant_parity.py) and its threshold
PARITY_PROMPTS = ("pod crashed exit 137", "oom killed container")
MAX_LOGIT_DIFF = 0.5
#: f32 logits of two packages' forwards: the same products, other orders
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_trees():
    params = jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)
    return params, jax_quantize_params(params, JAX_TINY_TEST)


@pytest.fixture(scope="module")
def reports(jax_trees):
    params, qparams = jax_trees
    prompts = [JaxByteTokenizer().encode(p) for p in PARITY_PROMPTS]
    want = jax_parity_report(params, qparams, JAX_TINY_TEST, prompts, max_new_tokens=10)
    port_params = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    got = parity_report(
        port_params, quantize_params(port_params, TINY_TEST), TINY_TEST,
        [ByteTokenizer().encode(p) for p in PARITY_PROMPTS], max_new_tokens=10,
    )
    return got, want


@pytest.mark.parametrize("key", ["greedy_match", "prompts", "mismatched_prompts"])
def test_report_equals_the_jax_report(reports, key):
    got, want = reports
    assert set(got) == set(want)
    assert got[key] == want[key]


def test_max_logit_diff_agrees_with_the_jax_report(reports):
    got, want = reports
    assert abs(got["max_logit_diff"] - want["max_logit_diff"]) < LOGIT_TOL, (got, want)


def test_the_gate_holds_for_the_port(reports):
    got, _ = reports
    assert got["greedy_match"] and got["mismatched_prompts"] == 0
    assert 0.0 < got["max_logit_diff"] < MAX_LOGIT_DIFF, got


def test_a_flipped_token_is_reported(jax_trees):
    """A quantized tree far from the float one must fail the gate: the
    report counts the mismatched prompt and the logit error grows."""
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_trees[0]))
    broken = quantize_params(params, TINY_TEST)
    broken["layers"]["wo"] = {
        "q": broken["layers"]["wo"]["q"].flip(-1),
        "s": broken["layers"]["wo"]["s"],
    }
    report = parity_report(params, broken, TINY_TEST,
                           [ByteTokenizer().encode(PARITY_PROMPTS[0])], max_new_tokens=6)
    assert report["prompts"] == 1
    assert report["max_logit_diff"] > MAX_LOGIT_DIFF
    assert report["greedy_match"] == (report["mismatched_prompts"] == 0)


def test_init_params_quantized_is_init_then_quantize():
    """The one-stack-at-a-time init draws what ``init_params`` draws and
    quantizes it as ``quantize_params`` does, bit for bit."""
    got = init_params_quantized(TINY_TEST, torch.Generator().manual_seed(3),
                                torch.float32, device="cpu")
    want = quantize_params(
        init_params(TINY_TEST, torch.Generator().manual_seed(3), torch.float32, device="cpu"),
        TINY_TEST,
    )
    for name, leaf in want["layers"].items():
        if isinstance(leaf, dict):
            assert torch.equal(got["layers"][name]["q"], leaf["q"]), name
            assert torch.equal(got["layers"][name]["s"], leaf["s"]), name
        else:
            assert torch.equal(got["layers"][name], leaf), name
    assert torch.equal(got["embed"], want["embed"])
