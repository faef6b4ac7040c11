"""Device mesh and sharding rules on ``torch.distributed``.

Port of ``operator_tpu/parallel/mesh.py``.  One
``torch.distributed.device_mesh.DeviceMesh`` with named dims ``("dp",
"fsdp", "tp")``:

- **dp**: data parallel over failure events;
- **tp**: tensor parallel — heads and MLP columns split over the axis;
- **fsdp**: parameter sharding for training and for fitting larger
  checkpoints.

A spec (:class:`P`) names, for each tensor dim, the mesh axis (or axes)
that shard it, as ``jax.sharding.PartitionSpec`` does; :func:`placements`
turns it into DTensor placements on a mesh, the counterpart of
``NamedSharding``.  The rules (:func:`param_specs`, :func:`batch_spec`,
...) are the JAX package's, entry for entry.

Two differences from JAX, both of the runtime:

- one process per rank: JAX puts many (virtual) devices in one process,
  torch puts one rank in each process, so a mesh of N devices needs a
  process group of N ranks (:func:`make_mesh` makes a one-rank group
  itself for a 1x1x1 mesh);
- DTensor pads a dim that its mesh axes do not divide, where JAX's
  ``shard_shape`` raises; :func:`validate_param_shardings` and
  :func:`placements` check divisibility explicitly.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from ..models.configs import ModelConfig
from ..models.llama import Params
from ..models.quant import QUANTIZED_LAYER_MATRICES

log = logging.getLogger(__name__)

__all__ = [
    "AXES",
    "MeshPlan",
    "P",
    "batch_spec",
    "initialize_distributed",
    "kv_cache_spec",
    "logits_spec",
    "make_mesh",
    "mesh_summary",
    "paged_cache_specs",
    "param_shardings",
    "param_specs",
    "placements",
    "plan_for",
    "shard_params",
    "tree_leaves",
    "tree_map",
    "tree_structure",
    "validate_param_shardings",
]

AXES = ("dp", "fsdp", "tp")

#: the fallback per-device memory budget: a 16 GB chip with ~12.5%
#: headroom (the JAX package's constant, so plans agree off the card)
_FALLBACK_BUDGET = 14e9


class P(tuple):
    """A placement spec: one entry per leading tensor dim — a mesh axis
    name, a tuple of names (the dim split over each, the first the
    major), or None (whole).  Dims past the last entry are whole.  A
    tuple, so ``tuple(P(None, "tp")) == (None, "tp")``, as a JAX
    ``PartitionSpec`` converts."""

    def __new__(cls, *entries: Union[None, str, tuple]) -> "P":
        return super().__new__(cls, entries)

    def __getnewargs__(self) -> tuple:
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshPlan:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1

    @property
    def total(self) -> int:
        return self.dp * self.fsdp * self.tp


MeshLike = Union[DeviceMesh, MeshPlan]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (the param tree's shape),
    with ``rest`` trees of the same structure giving the extra
    arguments; a :class:`P` or a placements tuple is a leaf."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value, *(other[key] for other in rest))
                for key, value in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in tree_leaves(value)]
    return [tree]


def tree_structure(tree: Any) -> Any:
    """The nesting of a tree of dicts, leaves as None (equal for trees of
    the same shape)."""
    if isinstance(tree, dict):
        return {key: tree_structure(value) for key, value in tree.items()}
    return None


def _hbm_budget(devices: Optional[Sequence]) -> float:
    """Usable memory per device: the card's total x 0.875 when ``devices``
    are CUDA devices, else the JAX package's fallback."""
    if devices:
        device = torch.device(devices[0])
        if device.type == "cuda":
            return float(torch.cuda.get_device_properties(device).total_memory) * 0.875
    return _FALLBACK_BUDGET


def plan_for(
    n_devices: int,
    *,
    tp: Optional[int] = None,
    fsdp: int = 1,
    config: Optional[ModelConfig] = None,
    devices: Optional[Sequence] = None,
) -> MeshPlan:
    """Choose a mesh factorisation for ``n_devices``.

    Defaults: the smallest tp that fits the model's bf16 weights in a
    device's memory and divides its KV heads (so attention never crosses
    devices for one KV head), everything else data-parallel."""
    if tp is None:
        tp = 1
        if config is not None:
            approx_params = (
                config.vocab_size * config.hidden_size * 2
                + config.num_layers
                * (4 * config.hidden_size * config.num_heads * config.head_dim
                   + 3 * config.hidden_size * config.intermediate_size)
            )
            bytes_needed = approx_params * 2  # bf16
            per_device = _hbm_budget(devices)
            while tp < n_devices and (bytes_needed / tp) > per_device:
                tp *= 2
            while tp > 1 and config.num_kv_heads % tp != 0:
                tp //= 2
    if tp * fsdp > n_devices:
        raise ValueError(f"tp*fsdp={tp*fsdp} exceeds {n_devices} devices")
    dp = n_devices // (tp * fsdp)
    plan = MeshPlan(dp=dp, fsdp=fsdp, tp=tp)
    if plan.total != n_devices:
        log.warning("mesh uses %d of %d devices", plan.total, n_devices)
    return plan


def _backend() -> str:
    """gloo for CPU tensors, and nccl for CUDA ones where there is a card."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def make_mesh(plan: Optional[MeshPlan] = None, *, device_type: str = "cuda") -> DeviceMesh:
    """The ``(dp, fsdp, tp)`` mesh of ``plan`` over the process group's
    ranks, one device of ``device_type`` per rank.

    With no process group and a one-device plan, a one-rank group is made
    here (in-process store), so one process needs no launcher.  Otherwise
    the group must already exist (:func:`initialize_distributed`) with
    exactly ``plan.total`` ranks: unlike JAX, which can put every device
    of a mesh in one process, torch runs one rank per process."""
    if not dist.is_initialized():
        if plan is not None and plan.total != 1:
            raise ValueError(
                f"a {plan.total}-device mesh needs a process group of {plan.total} ranks "
                f"(one process per rank; torch has no virtual devices as JAX has): "
                f"call initialize_distributed() in each rank first")
        dist.init_process_group(_backend(), store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    plan = plan or plan_for(world)
    if plan.total != world:
        raise ValueError(
            f"plan {plan} needs {plan.total} devices but the process group has {world} "
            f"ranks (one process per rank; torch has no virtual devices as JAX has)")
    if device_type == "cuda":
        # one card per rank, chosen before the mesh binds its communicator
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())
    mesh = init_device_mesh(device_type, (plan.dp, plan.fsdp, plan.tp), mesh_dim_names=AXES)
    # the data axes as one dim too, so a sum over both (the loss, the
    # gradients) is one collective rather than two in sequence
    mesh["dp", "fsdp"]._flatten("data")
    return mesh


def initialize_distributed(**kwargs: Any) -> None:
    """Join the process group of a multi-process launch.

    A no-op unless the caller passes keyword arguments or the environment
    names a coordinator: JAX's ``JAX_COORDINATOR_ADDRESS`` or
    ``COORDINATOR_ADDRESS``, or torchrun's ``MASTER_ADDR`` with
    ``WORLD_SIZE`` > 1.  JAX's keywords map onto torch's:
    ``coordinator_address`` ("host:port") onto ``init_method``,
    ``num_processes`` onto ``world_size``, ``process_id`` onto ``rank``;
    with a coordinator from the environment, the world size and rank are
    torchrun's ``WORLD_SIZE`` and ``RANK``.  Any other keyword goes to
    ``torch.distributed.init_process_group`` as it is.  The backend is
    nccl for the card and gloo for the CPU."""
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS")
    torchrun = bool(os.environ.get("MASTER_ADDR")) and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if not (kwargs or coordinator or torchrun):
        return
    renamed = {"num_processes": "world_size", "process_id": "rank"}
    kwargs = {renamed.get(key, key): value for key, value in kwargs.items()}
    address = kwargs.pop("coordinator_address", None)
    if address is None and not kwargs.keys() & {"init_method", "store"} and not torchrun:
        address = coordinator
    if address is not None:
        kwargs["init_method"] = f"tcp://{address}"
        for key, env in (("world_size", "WORLD_SIZE"), ("rank", "RANK")):
            if key not in kwargs:
                if env not in os.environ:
                    raise ValueError(f"coordinator {address} given without {key} "
                                     f"(pass it, or set {env})")
                kwargs[key] = int(os.environ[env])
    kwargs.setdefault("backend", _backend())
    dist.init_process_group(**kwargs)


# --------------------------------------------------------------------------
# sharding rules
# --------------------------------------------------------------------------


def _axis_sizes(mesh: MeshLike) -> dict[str, int]:
    if isinstance(mesh, MeshPlan):
        return dataclasses.asdict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _spec_axes(entry: Union[None, str, tuple]) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_divides(spec: P, shape: Sequence[int], sizes: dict[str, int], what: str) -> None:
    """Raise as JAX's ``shard_shape`` does where a dim does not divide."""
    if len(spec) > len(shape):
        raise ValueError(f"{what}: spec {spec} has more entries than shape {tuple(shape)}")
    for dim, entry in enumerate(spec):
        ways = 1
        for axis in _spec_axes(entry):
            if axis not in sizes:
                raise ValueError(f"{what}: spec {spec} names axis {axis!r}, "
                                 f"not one of the mesh's {tuple(sizes)}")
            ways *= sizes[axis]
        if shape[dim] % ways:
            raise ValueError(
                f"{what}: spec {spec} partitions axis {dim} {ways} ways, but the "
                f"dimension size is {shape[dim]} (full shape {tuple(shape)}): the "
                f"tiling factors must evenly divide the shape")


def placements(spec: P, mesh: DeviceMesh, shape: Optional[Sequence[int]] = None
               ) -> tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim.  A
    tensor dim split over two mesh axes is two ``Shard`` of that dim, in
    the mesh's dim order, which is JAX's major-to-minor order, so a spec
    must name them in that order.  With ``shape``, raise where the mesh
    does not divide it (DTensor would pad)."""
    names = tuple(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _spec_axes(entry)
        for axis in axes:
            if axis not in names:
                raise ValueError(f"spec {spec} names axis {axis!r}, not one of the mesh's {names}")
            if out[names.index(axis)] != Replicate():
                raise ValueError(f"spec {spec} uses axis {axis!r} twice")
            out[names.index(axis)] = Shard(dim)
        order = [names.index(axis) for axis in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {dim}'s axes must be in the mesh's order {names}")
    if shape is not None:
        _check_divides(spec, shape, _axis_sizes(mesh), "placements")
    return tuple(out)


def param_specs(config: ModelConfig, *, shard_fsdp: bool = True, quantized: bool = False) -> Params:
    """Specs mirroring the param tree of ``llama.init_params``.

    Megatron-style tp: column-parallel in-projections (heads / MLP
    columns on ``tp``), row-parallel out-projections.  fsdp shards the
    other matrix axis, so tp x fsdp tiles every large matrix.
    ``quantized`` mirrors the int8 tree (``models/quant.py``): each layer
    matrix becomes ``{q: <matrix spec>, s: <out-axis spec>}``."""
    f = "fsdp" if shard_fsdp else None
    layer_specs: dict[str, Any] = {
        "wq": P(None, f, "tp"),
        "wk": P(None, f, "tp"),
        "wv": P(None, f, "tp"),
        "wo": P(None, "tp", f),
        "w_gate": P(None, f, "tp"),
        "w_up": P(None, f, "tp"),
        "w_down": P(None, "tp", f),
        "ln_attn": P(None, None),
        "ln_mlp": P(None, None),
    }
    if config.attention_bias:
        # Qwen2 q/k/v biases live on the projections' output axis (tp)
        layer_specs["bq"] = P(None, "tp")
        layer_specs["bk"] = P(None, "tp")
        layer_specs["bv"] = P(None, "tp")
    if quantized:
        for name in QUANTIZED_LAYER_MATRICES:
            spec = layer_specs[name]
            layer_specs[name] = {"q": spec, "s": P(None, spec[2])}  # out axis
    specs: dict[str, Any] = {
        "embed": P(f, None),  # vocab over fsdp, hidden whole
        "layers": layer_specs,
        "ln_final": P(None),
    }
    if not config.tie_embeddings:
        specs["lm_head"] = P(f, "tp")
    return specs


def param_shardings(mesh: DeviceMesh, config: ModelConfig, **kw: Any) -> Params:
    """The placements of every param leaf on ``mesh`` (the tree of
    ``param_specs`` with each spec turned into placements)."""
    return tree_map(lambda spec: placements(spec, mesh), param_specs(config, **kw))


def batch_spec() -> P:
    """Token batches shard over (dp, fsdp) jointly — fsdp acts as a
    second data axis at run time (ZeRO-style)."""
    return P(("dp", "fsdp"), None)


def kv_cache_spec() -> P:
    """[layers, B, S, kv_heads, head_dim]: batch over dp(+fsdp), heads over tp."""
    return P(None, ("dp", "fsdp"), None, "tp", None)


def paged_cache_specs() -> Any:
    """Specs mirroring the ``PagedKVCache`` tree: the page pool is shared
    by every sequence, so pages shard over tp on the KV-head axis only;
    tables and lengths are tiny and whole."""
    from ..ops.paged_attention import PagedKVCache

    pages = P(None, None, None, "tp", None)  # [L, pages, page_size, KH, D]
    return PagedKVCache(k_pages=pages, v_pages=pages, page_table=P(None, None),
                        lengths=P(None))


def logits_spec() -> P:
    return P(("dp", "fsdp"), None, "tp")


def place(tensor: torch.Tensor, mesh: DeviceMesh, spec_placements: Sequence[Placement]
          ) -> DTensor:
    """``tensor`` on ``mesh`` at ``spec_placements``: a DTensor is
    redistributed; a plain tensor, the same whole tensor on every rank,
    is cut to this rank's shard without a collective."""
    if isinstance(tensor, DTensor):
        return tensor.redistribute(mesh, spec_placements)
    ways: dict[int, int] = {}
    for placement, size in zip(spec_placements, mesh.shape):
        if isinstance(placement, Shard):
            ways[placement.dim] = ways.get(placement.dim, 1) * size
    for dim, count in ways.items():
        if tensor.shape[dim] % count:
            raise ValueError(f"dim {dim} of shape {tuple(tensor.shape)} does not divide "
                             f"over {count} ranks")
    return distribute_tensor(tensor, mesh, spec_placements, src_data_rank=None)


def shard_params(params: Params, mesh: DeviceMesh, config: ModelConfig, **kw: Any) -> Params:
    """Place a param tree onto the mesh.  Every rank passes the same
    whole tree (from one seed or one checkpoint) and keeps its shard."""
    return tree_map(lambda leaf, where: place(leaf, mesh, where),
                    params, param_shardings(mesh, config, **kw))


def validate_param_shardings(mesh: MeshLike, config: ModelConfig, *,
                             quantized: bool = False) -> int:
    """Prove every parameter leaf divides evenly over the mesh without
    allocating the model: the tree is built on the ``meta`` device.
    ``mesh`` is a ``DeviceMesh`` or the :class:`MeshPlan` it would be
    made from (a plan needs no process group of its size).  Raises
    ``ValueError`` where a mesh axis does not divide a dim, as JAX's
    ``shard_shape`` does; returns the leaf count."""
    from ..models.llama import init_params

    shapes = init_params(config, None, device="meta", quantize=quantized)
    sizes = _axis_sizes(mesh)
    specs = param_specs(config, quantized=quantized)
    leaves = tree_leaves(shapes)
    spec_leaves = tree_leaves(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} param leaves")
    for leaf, spec in zip(leaves, spec_leaves):
        _check_divides(spec, leaf.shape, sizes, config.name)
    return len(leaves)


def mesh_summary(mesh: DeviceMesh) -> str:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return f"mesh {sizes} over {mesh.size()} {mesh.device_type} device(s)"
