"""The port's training layer against the JAX package's, in one process.

``operator_tpu_torch/parallel/train.py`` and LoRA's training half on a
1x1x1 mesh (a one-rank gloo group) against ``operator_tpu/parallel`` on
a one-device JAX mesh: ``TINY_TEST`` in f32, the JAX weights, adapters
and int8 base bridged through numpy, the batch drawn from a numpy seed
with some targets masked out.  Held: the loss, five full-training steps
(losses, and after one step every param and both Adam moments), six
LoRA steps over an f32 and an int8 base, LoRA's properties (zero B is
the identity, the base stays frozen, the merge equals the low-rank
path) and the checkpoint round trip.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models import quant as jax_quant  # noqa: E402
from operator_tpu.parallel import lora as jax_lora  # noqa: E402
from operator_tpu.parallel import mesh as jax_mesh  # noqa: E402
from operator_tpu.parallel import train as jax_train  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, params_from_jax  # noqa: E402
from operator_tpu_torch.models.llama import forward  # noqa: E402
from operator_tpu_torch.parallel import (  # noqa: E402
    MeshPlan,
    apply_lora,
    init_lora,
    load_train_state,
    make_lora_train_step,
    make_mesh,
    make_train_step,
    next_token_loss,
    param_shardings,
    save_train_state,
)
from operator_tpu_torch.parallel.mesh import tree_leaves, tree_map  # noqa: E402
from operator_tpu_torch.parallel.train import adam_moments  # noqa: E402

RANK = 4
#: the two libraries' f32 reductions in different orders: the losses
#: agree to about 1e-6 relative, the moments after one step within 1e-6
LOSS_RTOL = 1e-4
STEP_ATOL = 1e-6
#: the params after one step: Adam's first update is lr * g / (|g| +
#: 1e-8), so where |g| is near 1e-8 the two gradients' last-digit
#: difference moves it by up to 2 * lr; measured: 2 of 135,168
#: elements of one leaf off by 2.2e-6 in one run and 1.8e-5 in
#: another.  Elements whose gradient is zero or at least SETTLED_GRAD
#: are held to STEP_ATOL, the rest (under 1% of a leaf) to the
#: update's range
SETTLED_GRAD = 1e-6
LEARNING_RATE = 1e-4  # make_optimizer's default, JAX's too


def _np(tensor):
    tensor = tensor.full_tensor() if hasattr(tensor, "full_tensor") else tensor
    return tensor.detach().cpu().numpy()


def _port(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshPlan(), device_type="cpu")


@pytest.fixture(scope="module")
def jax_mesh1():
    return jax_mesh.make_mesh(jax_mesh.MeshPlan(), devices=jax.devices("cpu")[:1])


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, TINY_TEST.vocab_size, (4, 32), dtype=np.int32)
    mask = np.ones((4, 32), np.float32)
    mask[1, 20:] = 0.0  # a padded row
    mask[3, :5] = 0.0  # a prompt that does not count
    return tokens, mask


def _torch_batch(batch):
    tokens, mask = batch
    return torch.from_numpy(tokens), torch.from_numpy(mask)


def _adapters(seed):
    return jax_lora.init_lora(JAX_TINY_TEST, jax.random.PRNGKey(seed), rank=RANK,
                              dtype=jnp.float32)


def _copy(tree):
    """A copy of a JAX tree to hand to a step that donates its state."""
    return jax.tree_util.tree_map(jnp.copy, tree)


def _adam(opt_state):
    return next(part for part in opt_state if isinstance(part, optax.ScaleByAdamState))


def test_next_token_loss_matches_jax(jax_params, batch):
    tokens, mask = batch
    adapters = jax.tree_util.tree_map(lambda x: x + 0.01, _adapters(1))
    for lora in (None, adapters):
        want = float(jax_train.next_token_loss(jax_params, JAX_TINY_TEST, jnp.asarray(tokens),
                                               jnp.asarray(mask), lora=lora))
        got = next_token_loss(_port(jax_params), TINY_TEST, *_torch_batch(batch),
                              lora=None if lora is None else _port(lora))
        assert float(got) == pytest.approx(want, rel=LOSS_RTOL)


@pytest.fixture(scope="module")
def jax_full_run(jax_params, jax_mesh1, batch):
    """Five JAX steps: the losses, and the params and moments after one."""
    init_state, train_step = jax_train.make_train_step(JAX_TINY_TEST, jax_mesh1)
    state = init_state(_copy(jax_params))
    tokens, mask = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    losses, first = [], None
    for _ in range(5):
        state, loss = train_step(state, tokens, mask)
        losses.append(float(loss))
        if first is None:
            adam = _adam(state.opt_state)
            first = jax.tree_util.tree_map(np.asarray, (state.params, adam.mu, adam.nu))
    return losses, first


def test_five_train_steps_match_jax(jax_params, jax_full_run, mesh, batch):
    want_losses, (want_params, want_mu, want_nu) = jax_full_run
    init_state, train_step = make_train_step(TINY_TEST, mesh)
    state = init_state(_port(jax_params))
    tokens, mask = _torch_batch(batch)
    losses = []
    for step in range(5):
        state, loss = train_step(state, tokens, mask)
        losses.append(float(loss))
        if step == 0:
            mu, nu = adam_moments(state)
            for got_tree, want_tree in ((mu, want_mu), (nu, want_nu)):
                for got, want in zip(tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree)):
                    np.testing.assert_allclose(_np(got), want, rtol=0, atol=STEP_ATOL)
            for got, want, first_mu in zip(tree_leaves(state.params),
                                           jax.tree_util.tree_leaves(want_params),
                                           jax.tree_util.tree_leaves(want_mu)):
                err = np.abs(_np(got) - want)
                grad = np.abs(first_mu) / (1 - 0.9)  # mu = (1 - b1) g
                settled = (grad == 0) | (grad >= SETTLED_GRAD)
                assert err[settled].max(initial=0.0) <= STEP_ATOL
                assert err.max() <= 2 * LEARNING_RATE
                assert (~settled).mean() < 1e-2
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    assert int(state.step) == 5


def test_params_and_moments_keep_their_placements(jax_params, mesh, batch):
    init_state, train_step = make_train_step(TINY_TEST, mesh)
    state = init_state(_port(jax_params))
    state, _ = train_step(state, *_torch_batch(batch))
    want = param_shardings(mesh, TINY_TEST)
    mu, nu = adam_moments(state)
    for tree in (state.params, mu, nu):
        assert tree_map(lambda leaf: leaf.placements, tree) == want


def _jax_lora_losses(base, adapters, mesh, batch, quantized, steps=6):
    init_state, train_step = jax_lora.make_lora_train_step(
        JAX_TINY_TEST, mesh, quantized_base=quantized)
    state = init_state(_copy(adapters))
    tokens, mask = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, base, tokens, mask)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("quantized", [False, True], ids=["f32_base", "int8_base"])
def test_six_lora_steps_match_jax(jax_params, jax_mesh1, mesh, batch, quantized):
    jax_base = (jax_quant.quantize_params(jax_params, JAX_TINY_TEST) if quantized
                else jax_params)
    adapters = _adapters(1)
    want = _jax_lora_losses(jax_base, adapters, jax_mesh1, batch, quantized)
    base = _port(jax_base)
    before = [leaf.clone() for leaf in tree_leaves(base)]
    init_state, train_step = make_lora_train_step(TINY_TEST, mesh, quantized_base=quantized)
    state = init_state(_port(adapters))
    tokens, mask = _torch_batch(batch)
    losses = []
    for _ in range(6):
        state, loss = train_step(state, base, tokens, mask)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    # the frozen base is never written, int8 groups stay int8
    for got, was in zip(tree_leaves(base), before):
        assert got.dtype == was.dtype and torch.equal(got, was)


def test_lora_zero_b_is_identity(jax_params):
    params = _port(jax_params)
    adapters = init_lora(TINY_TEST, torch.Generator().manual_seed(1), rank=RANK,
                         dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, TINY_TEST.vocab_size, (2, 12), dtype=np.int32))
    positions = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    ref, _ = forward(params, TINY_TEST, tokens, positions)
    merged, _ = forward(apply_lora(params, adapters), TINY_TEST, tokens, positions)
    low_rank, _ = forward(params, TINY_TEST, tokens, positions, lora=adapters)
    torch.testing.assert_close(merged, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(low_rank, ref, rtol=0, atol=1e-5)


def test_lora_training_is_deployable_through_the_merge(jax_params, mesh, batch):
    """The frozen base plus the trained adapters alone reproduce the
    improvement, and merging them gives the low-rank path's loss."""
    params = _port(jax_params)
    init_state, train_step = make_lora_train_step(TINY_TEST, mesh)
    state = init_state(_port(_adapters(1)))
    tokens, mask = _torch_batch(batch)
    losses = []
    for _ in range(8):
        state, loss = train_step(state, params, tokens, mask)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.05, losses
    with torch.no_grad():
        reproduced = float(next_token_loss(params, TINY_TEST, tokens, mask, lora=state.params))
        adapters = {name: {k: v.full_tensor() for k, v in f.items()}
                    for name, f in state.params.items()}
        merged = float(next_token_loss(apply_lora(params, adapters), TINY_TEST, tokens, mask))
    assert reproduced < losses[0] - 0.05
    assert merged == pytest.approx(reproduced, abs=1e-4)


def test_lora_step_refuses_a_base_of_the_other_kind(jax_params, mesh, batch):
    init_state, train_step = make_lora_train_step(TINY_TEST, mesh, quantized_base=True)
    state = init_state(_port(_adapters(1)))
    with pytest.raises(ValueError, match="int8"):
        train_step(state, _port(jax_params), *_torch_batch(batch))


def test_train_state_checkpoint_roundtrip(jax_params, mesh, batch, tmp_path):
    """Params, both moments and the step round-trip exactly onto a fresh
    reference state; the restored state trains on to the same loss; and
    saving over the same path works."""
    init_state, train_step = make_train_step(TINY_TEST, mesh)
    state = init_state(_port(jax_params))
    tokens, mask = _torch_batch(batch)
    state, _ = train_step(state, tokens, mask)
    path = str(tmp_path / "ckpt")
    save_train_state(state, path)
    other = jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(9), dtype=jnp.float32)
    restored = load_train_state(path, init_state(_port(other)))
    assert int(restored.step) == int(state.step) == 1
    for got_tree, want_tree in zip((restored.params, *adam_moments(restored)),
                                   (state.params, *adam_moments(state))):
        for got, want in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
            assert got.placements == want.placements
            assert torch.equal(got.full_tensor(), want.full_tensor())
    next_a, loss_a = train_step(restored, tokens, mask)
    _, loss_b = train_step(state, tokens, mask)
    assert float(loss_a) == float(loss_b)
    assert int(next_a.step) == 2
    save_train_state(next_a, path)
    again = load_train_state(path, init_state(_port(other)))
    assert int(again.step) == 2
