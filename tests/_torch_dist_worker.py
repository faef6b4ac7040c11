"""One rank of the port's multi-process mesh tests (``test_torch_distributed.py``).

    python tests/_torch_dist_worker.py <task> <rank> <world> <workdir>

Imports torch and the port only (no JAX: the JAX expectations come from
the pytest process in ``<workdir>/inputs.npz``).  The ranks meet through
a ``FileStore`` under ``<workdir>``; each writes ``<workdir>/rank<r>.json``
and prints one ``<TASK>-OK`` line.  Tasks:

- ``eight``: on a dp2·fsdp2·tp2 mesh, the sharded forward against JAX's
  logits, five full-training steps against JAX's losses with the params
  and both moments kept at their placements, the same on a dp4·tp2 mesh,
  two LoRA steps over an int8 base, and the checkpoint round trip with
  a restore onto a dp1·fsdp4·tp2 reference;
- ``two``: the dp reduction — eight rows, four on each rank, of values
  1 and 2, summed over the mesh to 12.0.
"""

from __future__ import annotations

import json
import os
import sys
from datetime import timedelta

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from operator_tpu_torch.models import TINY_TEST  # noqa: E402
from operator_tpu_torch.parallel import (  # noqa: E402
    MeshPlan,
    batch_spec,
    initialize_distributed,
    load_train_state,
    logits_spec,
    make_lora_train_step,
    make_mesh,
    make_train_step,
    mesh_summary,
    param_shardings,
    placements,
    save_train_state,
    shard_params,
    sharded_forward,
)
from operator_tpu_torch.parallel.mesh import place, tree_leaves, tree_map  # noqa: E402
from operator_tpu_torch.parallel.train import adam_moments  # noqa: E402

#: the tests' tolerances (test_torch_distributed.py states them)
LOGITS_TOL = 2e-4
LOSS_RTOL = 1e-4


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
        node[parts[-1]] = torch.from_numpy(np.array(value))
    return tree


def check(condition: bool, message: str) -> None:
    if not condition:
        raise AssertionError(message)


def placed_as(tree, mesh, config, **kw) -> bool:
    return tree_map(lambda leaf: leaf.placements, tree) == param_shardings(mesh, config, **kw)


def train(mesh, params, tokens, mask, want, steps=5):
    init_state, train_step = make_train_step(TINY_TEST, mesh)
    state = init_state(params)
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, tokens, mask)
        losses.append(float(loss))
        mu, nu = adam_moments(state)
        for tree in (state.params, mu, nu):
            check(placed_as(tree, mesh, TINY_TEST), f"placements drifted on {mesh_summary(mesh)}")
    np.testing.assert_allclose(losses, want[:steps], rtol=LOSS_RTOL)
    return state, losses, (init_state, train_step)


def task_eight(rank: int, workdir: str) -> dict:
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    params, q8 = unflatten(inputs, "params"), unflatten(inputs, "q8")
    adapters = unflatten(inputs, "lora")
    tokens = torch.from_numpy(inputs["tokens"])
    mask = torch.from_numpy(inputs["mask"])
    losses_want = inputs["losses"]
    out: dict = {}

    mesh = make_mesh(MeshPlan(dp=2, fsdp=2, tp=2), device_type="cpu")
    sharded = shard_params(params, mesh, TINY_TEST)
    wq = sharded["layers"]["wq"]
    check(wq.to_local().shape != wq.shape, "wq is not distributed")
    fwd_tokens = torch.from_numpy(inputs["fwd_tokens"])
    positions = torch.arange(fwd_tokens.shape[1], dtype=torch.int32)[None].expand(
        fwd_tokens.shape).contiguous()
    logits = sharded_forward(sharded, TINY_TEST, fwd_tokens, positions, mesh)
    check(logits.placements == placements(logits_spec(), mesh), "logits placement")
    got = logits.full_tensor().numpy()
    np.testing.assert_allclose(got, inputs["logits"], rtol=LOGITS_TOL, atol=LOGITS_TOL)
    out["logits_max_abs_err"] = float(np.abs(got - inputs["logits"]).max())
    out["mesh"] = mesh_summary(mesh)

    state_a, out["losses_dp2_fsdp2_tp2"], (_, step_a) = train(mesh, sharded, tokens, mask,
                                                              losses_want)
    mesh_b = make_mesh(MeshPlan(dp=4, fsdp=1, tp=2), device_type="cpu")
    _, out["losses_dp4_tp2"], _ = train(mesh_b, params, tokens, mask, losses_want)

    base = shard_params(q8, mesh, TINY_TEST, quantized=True)
    before = [leaf.to_local().clone() for leaf in tree_leaves(base)]
    init_lora_state, lora_step = make_lora_train_step(TINY_TEST, mesh, quantized_base=True)
    lora_state = init_lora_state(adapters)
    lora_losses = []
    for _ in range(2):
        lora_state, loss = lora_step(lora_state, base, tokens, mask)
        lora_losses.append(float(loss))
    np.testing.assert_allclose(lora_losses, inputs["lora_losses"], rtol=LOSS_RTOL)
    check(all(torch.equal(leaf.to_local(), was) for leaf, was in zip(tree_leaves(base), before)),
          "the int8 base changed")
    out["lora_losses"] = lora_losses

    path = os.path.join(workdir, "ckpt")
    save_train_state(state_a, path)
    mesh_c = make_mesh(MeshPlan(dp=1, fsdp=4, tp=2), device_type="cpu")
    init_c, step_c = make_train_step(TINY_TEST, mesh_c)
    reference = init_c(tree_map(torch.zeros_like, params))
    restored = load_train_state(path, reference)
    check(int(restored.step) == 5, "step")
    for got_tree, want_tree in zip((restored.params, *adam_moments(restored)),
                                   (state_a.params, *adam_moments(state_a))):
        check(placed_as(got_tree, mesh_c, TINY_TEST), "restored placements")
        for got_leaf, want_leaf in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
            check(torch.equal(got_leaf.full_tensor(), want_leaf.full_tensor()),
                  "a restored leaf differs")
    _, loss_c = step_c(restored, tokens, mask)
    _, loss_a = step_a(state_a, tokens, mask)
    np.testing.assert_allclose([float(loss_c), float(loss_a)], [losses_want[5]] * 2,
                               rtol=LOSS_RTOL)
    out["resumed_losses"] = [float(loss_c), float(loss_a)]
    return out


def task_two(rank: int, workdir: str) -> dict:
    mesh = make_mesh(MeshPlan(dp=2), device_type="cpu")
    rows = torch.tensor([[1.0]] * 4 + [[2.0]] * 4)  # rank 0 holds the 1s, rank 1 the 2s
    placed = place(rows, mesh, placements(batch_spec(), mesh, rows.shape))
    local = float(placed.to_local().sum())
    total = float(placed.sum().full_tensor())
    return {"local": local, "total": total, "rows": int(placed.shape[0])}


def main() -> int:
    task, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    initialize_distributed(init_method="file://" + os.path.join(workdir, "store"),
                           world_size=world, rank=rank, timeout=timedelta(seconds=120))
    out = {"eight": task_eight, "two": task_two}[task](rank, workdir)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    print(f"{task.upper()}-OK rank={rank} ranks={world} {json.dumps(out)}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
