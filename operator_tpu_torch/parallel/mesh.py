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

Its serving half: :func:`validate_serving_mesh` (the wave engine's two
rules) and :class:`ServingShard`, a rank's place in a serving mesh and
the collectives the serving programs run on plain local tensors.

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
    "ServingShard",
    "validate_serving_mesh",
    "batch_spec",
    "initialize_distributed",
    "kv_cache_spec",
    "launched",
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


def _backend(world_size: Optional[int] = None) -> str:
    """gloo for CPU tensors, and nccl for CUDA ones where every rank has
    a card of its own.  Where ``world_size`` ranks share fewer cards, gloo
    for both: nccl refuses two ranks of one communicator on one device,
    and gloo takes CUDA tensors for all-reduce and broadcast (the
    collectives :class:`ServingShard` runs there)."""
    if not torch.cuda.is_available():
        return "gloo"
    if world_size is not None and world_size > torch.cuda.device_count():
        log.warning("%d ranks share %d card(s): gloo collectives, no nccl",
                    world_size, torch.cuda.device_count())
        return "gloo"
    return "cpu:gloo,cuda:nccl"


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
        # (ranks beyond the card count share cards, over gloo: _backend)
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else dist.get_rank()
        torch.cuda.set_device(index % torch.cuda.device_count())
    mesh = init_device_mesh(device_type, (plan.dp, plan.fsdp, plan.tp), mesh_dim_names=AXES)
    # the data axes as one dim too, so a sum over both (the loss, the
    # gradients) is one collective rather than two in sequence
    mesh["dp", "fsdp"]._flatten("data")
    return mesh


def launched() -> bool:
    """Whether the environment names a coordinator (JAX's or torchrun's),
    as :func:`initialize_distributed` reads it."""
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS")
    torchrun = bool(os.environ.get("MASTER_ADDR")) and int(os.environ.get("WORLD_SIZE", "1")) > 1
    return bool(coordinator or torchrun)


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
    if not (kwargs or launched()):
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
    world = kwargs.get("world_size", os.environ.get("WORLD_SIZE"))
    kwargs.setdefault("backend", _backend(None if world is None else int(world)))
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


# --------------------------------------------------------------------------
# serving on a mesh: local shards and explicit collectives
# --------------------------------------------------------------------------

#: the tp-split layer matrices whose OUTPUT axis is split (column
#: parallel) and whose INPUT axis is (row parallel: a partial sum that an
#: all-reduce over tp completes)
COLUMN_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")
ROW_PARALLEL = ("wo", "w_down")


def validate_serving_mesh(mesh: MeshLike, config: ModelConfig, max_slots: int) -> None:
    """The wave engine's two rules for a serving mesh, with the JAX
    generator's messages (``operator_tpu/serving/engine.py:457-478``):
    tp divides the KV heads and the heads, and the slots divide over the
    data axes.  ``mesh`` may be a :class:`MeshPlan` (no ranks needed)."""
    sizes = _axis_sizes(mesh)
    tp = sizes.get("tp", 1)
    dp_total = sizes.get("dp", 1) * sizes.get("fsdp", 1)
    if config.num_kv_heads % tp or config.num_heads % tp:
        raise ValueError(
            f"tp={tp} must divide kv_heads={config.num_kv_heads} "
            f"and heads={config.num_heads}"
        )
    if max_slots % dp_total:
        raise ValueError(
            f"max_slots={max_slots} must be a multiple of "
            f"dp*fsdp={dp_total} (slots shard over the data axes)"
        )


class ServingShard:
    """This rank's place in a serving mesh, and the collectives the
    serving programs run on plain local tensors (DTensor's sharding
    propagation is too slow for the model's ops; it is used for nothing
    here).  JAX serves a mesh from one process and XLA inserts the
    collectives that ``in_shardings`` imply; the port writes them:

    - ``reduce_tp``: the all-reduce after each row-parallel projection
      (``wo``, ``w_down``);
    - ``gather_data``: slots and prefill rows split over the data axes
      (``dp`` major, ``fsdp`` minor, :func:`batch_spec`); sampled tokens
      and prefilled KV are gathered over them;
    - ``gather_fsdp``: at serving, a matrix's fan-in axis is split over
      fsdp, and each layer's weights are gathered before use;
    - vocab: ``lm_head``'s columns are split over tp (``logits_spec``),
      and the logits are gathered to the full vocab before sampling, so
      every tp rank draws the same token; the embedding (and a tied head)
      is split over fsdp and gathered as a layer's weights are.

    A gather over a one-rank group returns its input; an all-reduce
    always runs, so a one-rank group's collectives are in the programs
    (and in their CUDA graphs) as a larger group's are.  nccl gathers into
    one tensor; gloo (the CPU, and ranks sharing a card) into a list."""

    def __init__(self, mesh: DeviceMesh) -> None:
        sizes = _axis_sizes(mesh)
        self.dp, self.fsdp, self.tp = sizes["dp"], sizes["fsdp"], sizes["tp"]
        #: slots and prefill rows split this many ways
        self.data = self.dp * self.fsdp
        self.ranks = {axis: mesh.get_local_rank(axis) for axis in AXES}
        self.data_rank = self.ranks["dp"] * self.fsdp + self.ranks["fsdp"]
        self.tp_group = mesh.get_group("tp")
        self.fsdp_group = mesh.get_group("fsdp")
        self.data_group = mesh["dp", "fsdp"]._flatten("data").get_group()
        if dist.get_group_rank(self.data_group, dist.get_rank()) != self.data_rank:
            raise RuntimeError("the data axes' group does not order ranks dp-major")
        self.backend = str(dist.get_backend(self.tp_group))
        #: collectives a CUDA graph can capture: nccl's on the card, not gloo's
        self.capturable = mesh.device_type == "cuda" and "nccl" in self.backend
        self._layer_specs: dict = {}

    # -- where this rank's shard lies ---------------------------------------

    def _index(self, entry: Union[None, str, tuple]) -> tuple[int, int]:
        """(ways, this rank's index) of one spec entry."""
        ways, index = 1, 0
        for axis in _spec_axes(entry):
            size = getattr(self, axis)
            ways, index = ways * size, index * size + self.ranks[axis]
        return ways, index

    def local(self, tensor: torch.Tensor, spec: P) -> torch.Tensor:
        """This rank's shard of a whole ``tensor`` under ``spec`` (a
        contiguous copy where the spec splits it, else the tensor)."""
        out = tensor
        for dim, entry in enumerate(spec):
            ways, index = self._index(entry)
            if ways > 1:
                size = tensor.shape[dim]
                if size % ways:
                    raise ValueError(f"dim {dim} of shape {tuple(tensor.shape)} does not "
                                     f"divide over {ways} ranks ({spec})")
                out = out.narrow(dim, index * (size // ways), size // ways)
        return out.contiguous() if out is not tensor else tensor

    def local_shape(self, shape: Sequence[int], spec: P) -> tuple:
        out = list(shape)
        for dim, entry in enumerate(spec):
            out[dim] //= self._index(entry)[0]
        return tuple(out)

    def local_params(self, params: Params, config: ModelConfig, quantized: bool) -> Params:
        """``params`` cut to this rank's shards.  A leaf already at its
        local shape (the sharded loader's output) is kept; a leaf at
        neither shape raises."""
        from ..models.llama import init_params

        specs = param_specs(config, quantized=quantized)
        shapes = init_params(config, None, device="meta", quantize=quantized)

        def cut(leaf, spec, meta):
            local = self.local_shape(meta.shape, spec)
            if tuple(leaf.shape) == tuple(meta.shape):
                return self.local(leaf, spec)
            if tuple(leaf.shape) == local:
                return leaf
            raise ValueError(f"a param leaf of shape {tuple(leaf.shape)} is neither the "
                             f"model's {tuple(meta.shape)} nor this rank's shard {local}")

        return tree_map(cut, params, specs, shapes)

    def local_lora(self, lora: dict) -> dict:
        """A stacked adapter tree (``[L, n, in, r]`` ``a``, ``[L, n, r,
        out]`` ``b``, replicated) cut for this rank's projections: a
        column-parallel target keeps its ``b`` columns, a row-parallel
        one its ``a`` rows, so its term joins the partial sum before the
        projection's all-reduce (exact by linearity: no collective of its
        own)."""
        out = {}
        for name, factors in lora.items():
            a, b = factors["a"], factors["b"]
            if name in COLUMN_PARALLEL:
                b = self.local(b, P(None, None, None, "tp"))
            elif name in ROW_PARALLEL:
                a = self.local(a, P(None, None, "tp"))
            out[name] = {"a": a, "b": b}
        return out

    def rows(self, n: int) -> slice:
        """This data rank's rows of an ``n``-row batch (``n`` divides)."""
        per = n // self.data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    # -- collectives ----------------------------------------------------------

    def reduce_tp(self, x: torch.Tensor) -> torch.Tensor:
        """The partial sums of a row-parallel projection, summed over tp
        (in place)."""
        dist.all_reduce(x, group=self.tp_group)
        return x

    def _gather(self, x: torch.Tensor, dim: int, group, ways: int) -> torch.Tensor:
        if ways == 1:
            return x
        x = x.contiguous()
        if self.capturable:
            moved = x.movedim(dim, 0).contiguous()
            out = torch.empty((ways * moved.shape[0], *moved.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, moved, group=group)
            return out.movedim(0, dim)
        parts = [torch.empty_like(x) for _ in range(ways)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Each data rank's rows (``dim``) joined in data-rank order."""
        return self._gather(x, dim, self.data_group, self.data)

    def gather_tp(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return self._gather(x, dim % x.dim(), self.tp_group, self.tp)

    def gather_fsdp(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self._gather(x, dim % x.dim(), self.fsdp_group, self.fsdp)

    def layer_weights(self, weights: dict, config: ModelConfig) -> dict:
        """One layer's weights whole on their fsdp axis (the per-layer
        all-gather XLA inserts for JAX at serving)."""
        if self.fsdp == 1:
            return weights
        quantized = isinstance(weights["wq"], dict)
        specs = self._layer_specs.get((config.name, quantized))
        if specs is None:
            specs = self._layer_specs[(config.name, quantized)] = param_specs(
                config, quantized=quantized)["layers"]

        def whole(leaf, spec):
            for dim, entry in enumerate(tuple(spec)[1:]):
                if "fsdp" in _spec_axes(entry):
                    leaf = self.gather_fsdp(leaf, dim)
            return leaf

        return tree_map(whole, weights, {name: specs[name] for name in weights})

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the embedding, whose vocab axis is split over fsdp: the
        table is gathered first, as a layer's weights are (fsdp is also a
        data axis, so the ranks of an fsdp group look up different ids)."""
        return self.gather_fsdp(table, 0)[ids]

    def logits(self, x: torch.Tensor, params: Params, config: ModelConfig) -> torch.Tensor:
        """``x @ head`` over the full vocab: an untied head's columns are
        split over tp (its rows, over fsdp, are gathered first); a tied
        head is the embedding, its vocab split over fsdp."""
        if config.tie_embeddings:
            return x @ self.gather_fsdp(params["embed"], 0).T
        head = self.gather_fsdp(params["lm_head"], 0)
        return self.gather_tp(x @ head, -1)
