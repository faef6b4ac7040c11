"""Sharded training step — fine-tuning support for the explanation models.

Port of ``operator_tpu/parallel/train.py`` on ``torch.distributed``.  The
state rests on the mesh as the JAX step keeps it: params at
``mesh.param_shardings`` (fsdp x tp tiles every large matrix), both Adam
moments at the same placements, and batches at ``mesh.batch_spec`` (rows
over dp and fsdp jointly).

How a step runs.  The JAX step is one jit over the mesh, and XLA splits
every op by the shardings.  Here every rank runs the model's plain
forward and backward (``models/llama.py``) on its own rows of the batch,
with each weight gathered whole for the step, ZeRO-3 style; the
gradients, each rank's partial sum over its rows, are then reduced onto
the params' placements (all-reduce over dp, reduce-scatter over fsdp, a
local slice over tp) before the optimizer's step.  The arithmetic is the
JAX step's; compute is data parallel over dp x fsdp and repeated over tp
(splitting it over tp, and gathering one layer at a time, is later
work).  The loss is the global masked mean: each rank divides its sum
by the count over every rank.

The optimizer is ``torch.optim.AdamW`` set to what ``optax.adamw(lr,
b1=0.9, b2=0.95, weight_decay=0.01)`` computes (eps 1e-8 outside the
root, bias correction, decay on every leaf); it steps on the placed
params and keeps its moments beside them.  Checkpoints are
``torch.distributed.checkpoint`` directories (the JAX package writes
orbax ones): the format is the port's own.
"""

from __future__ import annotations

import functools
import os
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..models.configs import ModelConfig
from ..models.llama import Params, forward
from .mesh import (
    P,
    batch_spec,
    logits_spec,
    param_shardings,
    place,
    placements,
    tree_leaves,
    tree_map,
)

__all__ = [
    "TrainState",
    "adam_moments",
    "load_train_state",
    "make_optimizer",
    "make_train_step",
    "next_token_loss",
    "save_train_state",
    "sharded_forward",
]

#: builds the optimizer over a list of (placed) params
OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]

#: a per-rank value that sums over the data axes: partial over dp and
#: fsdp (each rank holds other rows), the same on every tp rank
_DATA_PARTIAL = (Partial(), Partial(), Replicate())


@dataclass
class TrainState:
    params: Params  # placed leaves (DTensors) the optimizer steps
    opt_state: torch.optim.Optimizer  # holds the Adam moments of ``params``
    step: torch.Tensor  # int32 scalar


def _whole(leaf: Any) -> Any:
    """A leaf's whole tensor on this rank (a DTensor is gathered)."""
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _loss_terms(
    params: Params,
    config: ModelConfig,
    token_ids: torch.Tensor,
    loss_mask: torch.Tensor,
    lora: Any,
    lora_alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(minus the summed log-likelihood of the counted targets, their
    count) over the rows given, on whole tensors."""
    b, t = token_ids.shape
    positions = torch.arange(t, dtype=torch.int32, device=token_ids.device)[None].expand(b, t)
    logits, _ = forward(params, config, token_ids, positions, lora=lora, lora_alpha=lora_alpha)
    targets = token_ids[:, 1:]
    mask = loss_mask[:, 1:].to(torch.float32)
    logprobs = torch.log_softmax(logits[:, :-1], dim=-1)
    picked = logprobs.gather(-1, targets[..., None].long())[..., 0]
    return -(picked * mask).sum(), mask.sum()


def next_token_loss(
    params: Params,
    config: ModelConfig,
    token_ids: torch.Tensor,  # [B, T]
    loss_mask: torch.Tensor,  # [B, T] 1.0 where the target counts
    *,
    lora: Any = None,  # adapter tree (parallel/lora.py); low-rank path only
    lora_alpha: float = 16.0,
) -> torch.Tensor:
    """Mean next-token cross-entropy (float32 logits, ``log_softmax``),
    over the targets ``loss_mask`` counts.  Placed (DTensor) params,
    adapters and batches are gathered whole first."""
    total, count = _loss_terms(
        tree_map(_whole, params), config, _whole(token_ids), _whole(loss_mask),
        None if lora is None else tree_map(_whole, lora), lora_alpha,
    )
    return total / count.clamp_min(1.0)


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01) -> OptimizerFactory:
    """AdamW as ``optax.adamw(learning_rate, b1=0.9, b2=0.95,
    weight_decay=weight_decay)`` computes it: a factory over the params
    (a torch optimizer holds its params)."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=weight_decay)


def _batch_rows(batch: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a batch at ``batch_spec``: a DTensor is
    redistributed there; a plain tensor is the whole batch, the same on
    every rank."""
    if isinstance(batch, DTensor):
        return batch.redistribute(mesh, placements(batch_spec(), mesh, batch.shape)).to_local()
    batch = batch.to(mesh.device_type)
    return place(batch, mesh, placements(batch_spec(), mesh, batch.shape)).to_local()


def _data_sum(value: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum of a per-rank value over the data axes."""
    return DTensor.from_local(value, mesh, _DATA_PARTIAL, run_check=False).full_tensor()


def sharded_forward(
    params: Params,
    config: ModelConfig,
    token_ids: torch.Tensor,  # [B, T], whole or at batch_spec
    positions: torch.Tensor,  # [B, T], whole or at batch_spec
    mesh: DeviceMesh,
    **kwargs: Any,
) -> DTensor:
    """``models/llama.py:forward`` (without a cache) over a placed param
    tree, as the JAX package jits ``forward`` over sharded params: each
    rank runs its rows of the batch through the whole weights, and the
    logits come back at ``logits_spec`` (rows over dp and fsdp, vocab
    over tp).  ``kwargs`` go to ``forward``."""
    with torch.no_grad():
        logits, _ = forward(tree_map(_whole, params), config, _batch_rows(token_ids, mesh),
                            _batch_rows(positions, mesh), **kwargs)
    rows = DTensor.from_local(logits, mesh, placements(P(("dp", "fsdp")), mesh),
                              run_check=False)
    return rows.redistribute(mesh, placements(logits_spec(), mesh, rows.shape))


def _value_and_grad(
    trainable: Params,
    loss_terms: Callable[[Params], tuple[torch.Tensor, torch.Tensor]],
    mesh: DeviceMesh,
) -> tuple[torch.Tensor, Params]:
    """The global loss and its gradient at ``trainable``'s placements.

    ``loss_terms(whole_trainable)`` gives this rank's (summed loss,
    count) over its rows; each rank's share of the mean is its sum over
    the count of every rank, so the gradients of the shares sum, over
    the data axes, to the gradient of the mean."""
    leaves = tree_map(lambda leaf: _whole(leaf).detach().requires_grad_(), trainable)
    total, count = loss_terms(leaves)
    share = total / _data_sum(count.detach(), mesh).clamp_min(1.0)
    share.backward()

    def reduced(leaf: Any, whole: torch.Tensor) -> Any:
        grad = whole.grad if whole.grad is not None else torch.zeros_like(whole)
        if not isinstance(leaf, DTensor):
            return grad
        partial = DTensor.from_local(grad, mesh, _DATA_PARTIAL, run_check=False)
        return partial.redistribute(leaf.device_mesh, leaf.placements)

    return _data_sum(share.detach(), mesh), tree_map(reduced, trainable, leaves)


def _start(params: Params, spec_placements: Any, mesh: DeviceMesh,
           optimizer: OptimizerFactory) -> TrainState:
    """A state owning copies of ``params`` at ``spec_placements``, its
    Adam moments zero at the same placements (made now, not at the first
    step, so a fresh state is a checkpoint's reference)."""
    placed = tree_map(
        lambda leaf, where: place(leaf.detach(), mesh, where).clone().requires_grad_(),
        params, spec_placements,
    )
    opt = optimizer(tree_leaves(placed))
    for leaf in tree_leaves(placed):
        opt.state[leaf] = {
            "step": torch.zeros((), dtype=torch.float32),
            "exp_avg": torch.zeros_like(leaf, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(leaf, memory_format=torch.preserve_format),
        }
    return TrainState(placed, opt, torch.zeros((), dtype=torch.int32, device=mesh.device_type))


def _apply(state: TrainState, grads: Params) -> TrainState:
    """One optimizer step in place; the input state is consumed."""
    for leaf, grad in zip(tree_leaves(state.params), tree_leaves(grads)):
        leaf.grad = grad
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    return TrainState(state.params, state.opt_state, state.step + 1)


def make_train_step(
    config: ModelConfig,
    mesh: DeviceMesh,
    optimizer: Optional[OptimizerFactory] = None,
):
    """Returns ``(init_state, train_step)`` over ``mesh``.

    ``init_state(params)`` copies a param tree (whole tensors, the same
    on every rank, or placed ones) onto ``param_shardings`` and zeroes
    the moments there.  ``train_step(state, token_ids, loss_mask)``
    returns ``(state, loss)``; the batch is whole or placed.  As in JAX,
    which donates it, the input state is consumed: its tensors are
    updated in place and belong to the returned state.  After every step
    the params and both Adam moments stand at the params' placements."""
    optimizer = optimizer or make_optimizer()
    p_shardings = param_shardings(mesh, config)

    def init_state(params: Params) -> TrainState:
        return _start(params, p_shardings, mesh, optimizer)

    def train_step(state: TrainState, token_ids: torch.Tensor, loss_mask: torch.Tensor):
        tokens, mask = _batch_rows(token_ids, mesh), _batch_rows(loss_mask, mesh)
        loss, grads = _value_and_grad(
            state.params, lambda params: _loss_terms(params, config, tokens, mask, None, 16.0),
            mesh,
        )
        return _apply(state, grads), loss

    return init_state, train_step


def adam_moments(state: TrainState) -> tuple[Params, Params]:
    """The first and second Adam moments (optax's ``mu`` and ``nu``) as
    trees shaped like ``state.params``."""
    moments = state.opt_state.state
    return (tree_map(lambda leaf: moments[leaf]["exp_avg"], state.params),
            tree_map(lambda leaf: moments[leaf]["exp_avg_sq"], state.params))


def _flat(state: TrainState) -> dict[str, torch.Tensor]:
    """The state's tensors by checkpoint key."""
    flat: dict[str, torch.Tensor] = {"step": state.step}

    def add(prefix: str, tree: Any) -> None:
        if isinstance(tree, dict):
            for key, value in tree.items():
                add(f"{prefix}.{key}", value)
        else:
            flat[prefix] = tree

    mu, nu = adam_moments(state)
    for prefix, tree in (("params", state.params), ("mu", mu), ("nu", nu)):
        add(prefix, tree)
    return flat


def save_train_state(state: TrainState, path: str) -> None:
    """Durable fine-tune checkpoint (params, both moments, step) as a
    ``torch.distributed.checkpoint`` directory: each rank writes its
    shards, and saving over an existing checkpoint replaces it."""
    import torch.distributed.checkpoint as dcp

    writer = dcp.FileSystemWriter(os.path.abspath(path), overwrite=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Detected an existing checkpoint")
        dcp.save(_flat(state), storage_writer=writer)


def load_train_state(path: str, reference: TrainState) -> TrainState:
    """Restore a checkpoint saved by :func:`save_train_state` into
    ``reference`` (e.g. a fresh ``init_state(params)``), which supplies
    the tree, dtypes and target placements: every leaf is loaded onto the
    reference's placements, so resuming on another mesh factorisation
    means passing a reference built on that mesh.  The reference's
    tensors are overwritten and returned as the restored state."""
    import torch.distributed.checkpoint as dcp

    with torch.no_grad():
        dcp.load(_flat(reference), storage_reader=dcp.FileSystemReader(os.path.abspath(path)))
        for moments in reference.opt_state.state.values():
            moments["step"].fill_(reference.step.to(torch.float32).item())
    return reference
