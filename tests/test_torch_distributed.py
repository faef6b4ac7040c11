"""The port's mesh layer across real processes (gloo ranks on the CPU).

Torch runs one rank per process, so where the JAX tests put eight
virtual devices in one process, these launch eight (or two) worker
processes (``tests/_torch_dist_worker.py``, which imports no JAX).  The
JAX expectations are computed once here, on one device, and handed to
the ranks in an ``.npz``; the ranks meet through a ``FileStore`` under
``tmp_path`` (no TCP port to race for), and every launch has its own
timeout: a rank that fails or hangs fails the test with every rank's
output.

- eight ranks, one launch: the dp2·fsdp2·tp2 sharded forward against
  JAX's single-device logits (rtol = atol = 2e-4, as the JAX test);
  five training steps on dp2·fsdp2·tp2 and on dp4·tp2 (the plan of the
  JAX training test) against JAX's losses (rtol 1e-4), the params and
  both moments at their placements after every step; two LoRA steps
  over an int8 base; the checkpoint written from dp2·fsdp2·tp2 and
  restored exactly onto a dp1·fsdp4·tp2 reference, which trains on to
  JAX's sixth loss;
- two ranks: the dp reduction of ``tests/test_distributed.py`` (total
  12.0);
- one process: ``initialize_distributed()`` without a coordinator is a
  no-op, and its arguments and environment map onto torch's.
"""

from __future__ import annotations

import json
import os
import pathlib
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
from operator_tpu.models import quant as jax_quant  # noqa: E402
from operator_tpu.models.llama import forward as jax_forward  # noqa: E402
from operator_tpu.parallel import lora as jax_lora  # noqa: E402
from operator_tpu.parallel import mesh as jax_mesh  # noqa: E402
from operator_tpu.parallel import train as jax_train  # noqa: E402
from operator_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

WORKER = pathlib.Path(__file__).resolve().parent / "_torch_dist_worker.py"
REPO = WORKER.parent.parent
#: one launch's limit, start-up of every rank included
LAUNCH_TIMEOUT_S = 240
#: the JAX training steps the eight-rank launch is held to: five, and the
#: sixth after the checkpoint's restore
JAX_STEPS = 6


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}.{key}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _launch(task: str, world: int, workdir: pathlib.Path) -> list[dict]:
    """Run ``world`` ranks of ``task``; their JSON results, rank order."""
    env = dict(os.environ)
    for name in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK"):
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
    return [json.loads((workdir / f"rank{rank}.json").read_text()) for rank in range(world)]


def _jax_expectations(workdir: pathlib.Path) -> dict:
    params = jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(3)
    fwd_tokens = rng.integers(0, JAX_TINY_TEST.vocab_size, (4, 16), dtype=np.int32)
    positions = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32)[None], (4, 16))
    logits, _ = jax_forward(params, JAX_TINY_TEST, jnp.asarray(fwd_tokens), positions)
    tokens = rng.integers(0, JAX_TINY_TEST.vocab_size, (4, 32), dtype=np.int32)
    mask = np.ones((4, 32), np.float32)
    mask[2, 24:] = 0.0

    arrays = _flatten(params, "params", {})
    one = jax_mesh.make_mesh(jax_mesh.MeshPlan(), devices=jax.devices("cpu")[:1])
    init_state, train_step = jax_train.make_train_step(JAX_TINY_TEST, one)
    state = init_state(jax.tree_util.tree_map(jnp.copy, params))
    losses = []
    for _ in range(JAX_STEPS):
        state, loss = train_step(state, jnp.asarray(tokens), jnp.asarray(mask))
        losses.append(float(loss))

    base = jax_quant.quantize_params(params, JAX_TINY_TEST)
    adapters = jax_lora.init_lora(JAX_TINY_TEST, jax.random.PRNGKey(1), rank=4, dtype=jnp.float32)
    _flatten(base, "q8", arrays)
    _flatten(adapters, "lora", arrays)
    init_lora_state, lora_step = jax_lora.make_lora_train_step(JAX_TINY_TEST, one,
                                                               quantized_base=True)
    lora_state = init_lora_state(jax.tree_util.tree_map(jnp.copy, adapters))
    lora_losses = []
    for _ in range(2):
        lora_state, loss = lora_step(lora_state, base, jnp.asarray(tokens), jnp.asarray(mask))
        lora_losses.append(float(loss))

    arrays.update(fwd_tokens=fwd_tokens, logits=np.asarray(logits), tokens=tokens, mask=mask,
                  losses=np.asarray(losses), lora_losses=np.asarray(lora_losses))
    np.savez(workdir / "inputs.npz", **arrays)
    return {"losses": losses, "lora_losses": lora_losses}


def test_eight_rank_mesh_matches_jax(tmp_path):
    want = _jax_expectations(tmp_path)
    results = _launch("eight", 8, tmp_path)
    for out in results:
        assert out["mesh"] == "mesh {'dp': 2, 'fsdp': 2, 'tp': 2} over 8 cpu device(s)"
        assert out["logits_max_abs_err"] <= 2e-4
        for plan in ("losses_dp2_fsdp2_tp2", "losses_dp4_tp2"):
            np.testing.assert_allclose(out[plan], want["losses"][:5], rtol=1e-4)
            assert out[plan][-1] < out[plan][0]
        np.testing.assert_allclose(out["lora_losses"], want["lora_losses"], rtol=1e-4)
        np.testing.assert_allclose(out["resumed_losses"], [want["losses"][5]] * 2, rtol=1e-4)
    # every rank reports the same global losses
    assert len({json.dumps(out["losses_dp2_fsdp2_tp2"]) for out in results}) == 1


def test_two_rank_dp_reduction(tmp_path):
    results = _launch("two", 2, tmp_path)
    # rows 0-3 (value 1) on rank 0, rows 4-7 (value 2) on rank 1: a
    # one-process run would give 4.0 or 8.0
    assert [out["local"] for out in results] == [4.0, 8.0]
    assert all(out["total"] == 12.0 and out["rows"] == 8 for out in results)


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    calls = []
    monkeypatch.setattr(port_mesh.dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def test_single_process_launch_is_a_noop(clean_env):
    """Without arguments or a coordinator in the environment, no group is
    made (a group would wait for peers that never come)."""
    port_mesh.initialize_distributed()
    assert clean_env == []


def test_jax_arguments_map_onto_torch(clean_env):
    port_mesh.initialize_distributed(coordinator_address="10.0.0.1:1234", num_processes=4,
                                     process_id=2)
    assert clean_env == [{"init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2,
                          "backend": port_mesh._backend()}]


def test_coordinator_environment_joins(clean_env, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    port_mesh.initialize_distributed()
    assert clean_env[-1]["init_method"] == "tcp://10.0.0.1:1234"
    assert (clean_env[-1]["world_size"], clean_env[-1]["rank"]) == (2, 1)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    port_mesh.initialize_distributed()  # torchrun: env:// reads the rest
    assert clean_env[-1] == {"backend": port_mesh._backend()}
    monkeypatch.setenv("WORLD_SIZE", "1")
    port_mesh.initialize_distributed()  # a one-process torchrun: no group
    assert len(clean_env) == 2
