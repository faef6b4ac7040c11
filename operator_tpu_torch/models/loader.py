"""Checkpoint loading: HF-format weights -> the port's stacked param tree.

Port of ``operator_tpu/models/loader.py``.  Sources:

- a local directory of ``*.safetensors`` files (with or without the
  ``model.safetensors.index.json`` shard index) in Hugging Face Llama
  layout, or
- any in-memory mapping of HF parameter names to tensors (the parity
  tests convert a freshly initialised ``transformers`` model).

The HF layout stores projections as ``[out_features, in_features]``; they
are transposed once at load, so the forward pass is always ``x @ W``
(``models/llama.py``), and the per-layer tensors are stacked on a leading
axis.  Each stacked layer group is placed on the device the moment its
last layer arrives; the transpose runs there, after the copy.

The port depends on PyTorch alone, not on the ``safetensors`` package, so
the format is read and written here: an 8-byte little-endian header length, a JSON header
(padded with spaces to 8 bytes) naming each tensor's dtype, shape and
``data_offsets``, then the raw bytes.  A file is mapped copy-on-write and
its tensors are views of the map (bf16 arrives as its raw 16 bits viewed
as ``torch.bfloat16``), so nothing is copied until a group is stacked.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import re
import struct
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Mapping, Optional, Union

import torch

from ..utils.device import resolve_device
from .configs import ModelConfig
from .quant import QUANTIZED_LAYER_MATRICES, is_quantized, quantize_matrix

log = logging.getLogger(__name__)

Params = dict[str, Any]

__all__ = [
    "convert_hf_state_dict",
    "iter_safetensors",
    "load_params",
    "load_params_async",
    "read_safetensors",
    "save_params",
    "write_safetensors",
]

_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.(.+)\.weight")
_BIAS_RE = re.compile(r"model\.layers\.(\d+)\.self_attn\.([qkv])_proj\.bias")

#: HF sub-name -> (our stacked name, transpose?)
_LAYER_MAP = {
    "self_attn.q_proj": ("wq", True),
    "self_attn.k_proj": ("wk", True),
    "self_attn.v_proj": ("wv", True),
    "self_attn.o_proj": ("wo", True),
    "mlp.gate_proj": ("w_gate", True),
    "mlp.up_proj": ("w_up", True),
    "mlp.down_proj": ("w_down", True),
    "input_layernorm": ("ln_attn", False),
    "post_attention_layernorm": ("ln_mlp", False),
}

# --------------------------------------------------------------------------
# the safetensors format
# --------------------------------------------------------------------------

_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "U16": torch.uint16, "F16": torch.float16, "BF16": torch.bfloat16,
    "I32": torch.int32, "U32": torch.uint32, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "U64": torch.uint64,
    "F8_E5M2": torch.float8_e5m2, "F8_E4M3": torch.float8_e4m3fn,
}
_DTYPE_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def read_safetensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` in file order, each a CPU view of a
    copy-on-write map of ``path`` (writable, so ``torch.frombuffer`` needs
    no read-only buffer; a write would stay private to this process)."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        (header_len,) = struct.unpack("<Q", fh.read(8))
        if 8 + header_len > size:
            raise ValueError(f"{path}: header of {header_len} bytes overruns the file")
        header = json.loads(fh.read(header_len))
        mapped = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
    header.pop("__metadata__", None)
    data = torch.frombuffer(mapped, dtype=torch.uint8)[8 + header_len:]
    for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has unknown dtype {info['dtype']!r}")
        begin, end = info["data_offsets"]
        shape = [int(n) for n in info["shape"]]
        numel = 1
        for n in shape:
            numel *= n
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= data.numel() or end - begin != numel * itemsize:
            raise ValueError(f"{path}: tensor {name} has bad data_offsets {info['data_offsets']}")
        raw = data[begin:end]
        if (8 + header_len + begin) % itemsize:
            raw = raw.clone()  # an unaligned tensor cannot be viewed in place
        yield name, raw.view(dtype).reshape(shape)


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write CPU tensors as one safetensors file: widest dtypes first
    (then by name, as the library orders them), so every tensor is
    aligned to its element size."""
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: dict[str, Any] = {}
    offset = 0
    for name, tensor in items:
        nbytes = tensor.numel() * tensor.element_size()
        header[name] = {
            "dtype": _DTYPE_NAMES[tensor.dtype],
            "shape": list(tensor.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for _, tensor in items:
            fh.write(tensor.contiguous().reshape(-1).view(torch.uint8).numpy().data)


def iter_safetensors(checkpoint_dir: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` lazily across all shard files (in the
    index's file order when there is one), each a view of its file's map,
    so the loader holds at most the layer tensors not yet stacked."""
    index_path = os.path.join(checkpoint_dir, "model.safetensors.index.json")
    files: list[str]
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        files = sorted({os.path.join(checkpoint_dir, v) for v in index["weight_map"].values()})
    else:
        files = sorted(
            os.path.join(checkpoint_dir, f)
            for f in os.listdir(checkpoint_dir)
            if f.endswith(".safetensors")
        )
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {checkpoint_dir}")
    for path in files:
        yield from read_safetensors(path)


# --------------------------------------------------------------------------
# HF names -> the stacked tree
# --------------------------------------------------------------------------


def _placer(device: torch.device, dtype: torch.dtype) -> Callable[[str, torch.Tensor], Any]:
    def put(name: str, value: torch.Tensor) -> torch.Tensor:
        # a copy even where device and dtype match: the source is a view
        # of a file map; a transposed group transposes on the device
        return value.to(device=device, dtype=dtype, copy=True).contiguous()

    return put


def convert_hf_state_dict(
    state: "Mapping[str, torch.Tensor] | Iterable[tuple[str, torch.Tensor]]",
    config: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    *,
    put: Optional[Callable[[str, torch.Tensor], Any]] = None,
    device: Union[str, torch.device, None] = None,
) -> Params:
    """Map HF Llama names to the stacked tree ``llama.init_params`` builds.

    ``state`` may be a dict (e.g. a ``state_dict()``) or a lazy
    ``(name, tensor)`` iterable (:func:`iter_safetensors`).
    ``put(name, tensor)`` places one top-level tensor or stacked group
    (default: a copy in ``dtype`` on ``device``, ``cuda`` unless the
    caller asks for another); checkpoint dtypes are kept until ``put``
    converts them.  A transposed group reaches ``put`` as a transposed
    view of the stacked HF tensors.
    """
    if put is None:
        put = _placer(resolve_device(device), dtype)

    n = config.num_layers
    per_layer: dict[str, list[Optional[torch.Tensor]]] = {
        ours: [None] * n for ours, _ in _LAYER_MAP.values()
    }
    if config.attention_bias:
        per_layer.update({f"b{axis}": [None] * n for axis in "qkv"})
    transposed = {ours for ours, t in _LAYER_MAP.values() if t}
    filled: dict[str, int] = {ours: 0 for ours in per_layer}
    layers: dict[str, Any] = {}
    top: dict[str, Any] = {}

    def record(ours: str, idx: int, tensor: torch.Tensor) -> None:
        per_layer[ours][idx] = tensor.detach()
        filled[ours] += 1
        if filled[ours] == n:
            # group complete: stack (checkpoint dtype), place, free refs
            stacked = torch.stack(per_layer[ours])
            layers[ours] = put(ours, stacked.transpose(-1, -2) if ours in transposed else stacked)
            per_layer[ours] = []

    items = state.items() if hasattr(state, "items") else state
    for name, raw in items:
        if name == "model.embed_tokens.weight":
            top["embed"] = put("embed", raw.detach())
        elif name == "model.norm.weight":
            top["ln_final"] = put("ln_final", raw.detach())
        elif name == "lm_head.weight":
            top["lm_head"] = put("lm_head", raw.detach().T)
        else:
            bias_match = _BIAS_RE.fullmatch(name)
            if bias_match:
                idx = int(bias_match.group(1))
                if not config.attention_bias:
                    log.debug("config has no attention_bias; ignoring %s", name)
                elif idx < n:
                    record(f"b{bias_match.group(2)}", idx, raw)
                continue
            match = _LAYER_RE.fullmatch(name)
            if not match:
                log.debug("ignoring unknown checkpoint tensor %s", name)
                continue
            idx, sub = int(match.group(1)), match.group(2)
            mapped = _LAYER_MAP.get(sub)
            if mapped is None:
                log.debug("ignoring unknown layer tensor %s", name)
                continue
            if idx >= n:
                continue  # a scaled-down config loads a prefix of the layers
            record(mapped[0], idx, raw)

    missing = [
        f"{ours}[{i}]"
        for ours, slots in per_layer.items()
        if ours not in layers
        for i, s in enumerate(slots)
        if s is None
    ]
    if missing:
        raise ValueError(f"checkpoint is missing {len(missing)} tensors, e.g. {missing[:4]}")
    params: Params = {"embed": top["embed"], "layers": layers, "ln_final": top["ln_final"]}
    if config.tie_embeddings:
        if "lm_head" in top:
            log.info("config ties embeddings; ignoring checkpoint lm_head")
    else:
        if "lm_head" not in top:
            raise ValueError("checkpoint has no lm_head.weight but config does not tie embeddings")
        params["lm_head"] = top["lm_head"]
    return params


# inverse of _LAYER_MAP: ours -> (hf name, transpose) — derived so the two
# directions can never drift
_HF_LAYER_NAMES = {ours: (hf, t) for hf, (ours, t) in _LAYER_MAP.items()}


def save_params(
    params: Params,
    checkpoint_dir: str,
    config: ModelConfig,
    *,
    shard_bytes: int = 4 << 30,
) -> list[str]:
    """Write the stacked tree as a sharded HF-layout safetensors
    checkpoint (``model-0000i-of-0000n.safetensors`` with
    ``model.safetensors.index.json``) that :func:`load_params` — or any
    HF Llama loader — reads back.  Quantized trees (or partly merged
    ones) must be expanded first: HF layout has no ``{q, s}`` convention.
    One stacked group is on the host at a time, beside the shard being
    packed.  Returns the written shard file names."""
    if is_quantized(params):
        raise ValueError(
            "save_params writes HF layout, which has no int8 {q, s} "
            "convention — expand with quant.dequantize_params first "
            "(merge_lora output still holds untargeted int8 groups)"
        )
    os.makedirs(checkpoint_dir, exist_ok=True)

    def host(tensor: torch.Tensor) -> torch.Tensor:
        # transposes run where the tree lives, before the copy out
        return tensor.detach().contiguous().to("cpu")

    def tensors():
        yield "model.embed_tokens.weight", host(params["embed"])
        yield "model.norm.weight", host(params["ln_final"])
        if "lm_head" in params:
            yield "lm_head.weight", host(params["lm_head"].T)
        for ours, (hf, transpose) in _HF_LAYER_NAMES.items():
            stacked = params["layers"][ours]
            stacked = host(stacked.transpose(-1, -2) if transpose else stacked)
            for i in range(config.num_layers):
                yield f"model.layers.{i}.{hf}.weight", stacked[i]
            del stacked
        for axis in "qkv":
            if f"b{axis}" not in params["layers"]:
                continue
            stacked = host(params["layers"][f"b{axis}"])
            for i in range(config.num_layers):
                yield f"model.layers.{i}.self_attn.{axis}_proj.bias", stacked[i]
            del stacked

    # pack + write shard by shard; rename to the final -of-NNNNN names
    # once the count is known
    weight_map: dict[str, str] = {}
    tmp_files: list[str] = []
    shard: dict[str, torch.Tensor] = {}
    size = total_size = 0

    def flush() -> None:
        nonlocal shard, size
        if not shard:
            return
        fname = f"model-{len(tmp_files) + 1:05d}.tmp"
        write_safetensors(os.path.join(checkpoint_dir, fname), shard)
        tmp_files.append(fname)
        for name in shard:
            weight_map[name] = fname
        shard, size = {}, 0

    for name, tensor in tensors():
        nbytes = tensor.numel() * tensor.element_size()
        if size and size + nbytes > shard_bytes:
            flush()
        shard[name] = tensor
        size += nbytes
        total_size += nbytes
    flush()

    total = len(tmp_files)
    files: list[str] = []
    renames = {}
    for i, tmp in enumerate(tmp_files, start=1):
        final = f"model-{i:05d}-of-{total:05d}.safetensors"
        os.replace(os.path.join(checkpoint_dir, tmp), os.path.join(checkpoint_dir, final))
        renames[tmp] = final
        files.append(final)
    weight_map = {name: renames[tmp] for name, tmp in weight_map.items()}
    with open(os.path.join(checkpoint_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total_size}, "weight_map": weight_map}, f)
    return files


def load_params(
    checkpoint_dir: str,
    config: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    *,
    device: Union[str, torch.device, None] = None,
    quantize: bool = False,
    mesh: Any = None,
) -> Params:
    """Load a HF Llama checkpoint directory onto ``device`` (``cuda``
    unless the caller asks for another).

    ``quantize=True`` quantizes each layer-matrix group on the device the
    moment it is placed (``models/quant.py``'s int8 scheme), so the
    device's peak is the int8 tree plus one ``dtype`` group, never the
    float tree beside the int8 one.

    ``mesh`` (a serving ``DeviceMesh``, the JAX package's ``shardings=``)
    puts only this rank's shard of each tensor on its card
    (``parallel/mesh.py:param_specs``), cut from the file's map on the
    host.  A quantized group goes to the card at its local OUTPUT columns
    with its whole input axis (the per-output-channel scale reads all of
    it), is quantized there and then cut on its input axis: each rank
    gets exactly its slice of the unsharded load, and no rank's card
    holds more than one float group of its columns.
    """
    place = _placer(resolve_device(device), dtype)
    shard = specs = None
    if mesh is not None:
        from ..parallel.mesh import P, ServingShard, param_specs

        shard = ServingShard(mesh)
        specs = param_specs(config, quantized=quantize)
        specs = {**specs, **specs.pop("layers")}

    def put(name: str, value: torch.Tensor) -> Any:
        if quantize and name in QUANTIZED_LAYER_MATRICES:
            if shard is None:
                return quantize_matrix(place(name, value))  # the float group frees on return
            spec = specs[name]["q"]  # [L, in, out]
            group = quantize_matrix(place(name, shard.local(value, P(None, None, spec[2]))))
            return {"q": shard.local(group["q"], P(None, spec[1], None)), "s": group["s"]}
        if shard is not None:
            value = shard.local(value, specs[name])
        return place(name, value)

    return convert_hf_state_dict(iter_safetensors(checkpoint_dir), config, dtype, put=put)


class _AsyncLoad:
    """Handle for an in-flight weight load (:func:`load_params_async`):
    the load runs on a daemon thread; ``result()`` joins it and re-raises
    its failure on the caller; ``seconds`` is its wall once done."""

    def __init__(self, target, args, kwargs) -> None:
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._started = time.perf_counter()
        self.seconds: Optional[float] = None

        def _run() -> None:
            try:
                self._result = target(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 - re-raised in result()
                self._error = exc
            finally:
                self.seconds = time.perf_counter() - self._started

        self._thread = threading.Thread(target=_run, name="weight-stream", daemon=True)
        self._thread.start()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None) -> Params:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("weight stream still loading")
        if self._error is not None:
            raise self._error
        return self._result


def load_params_async(
    checkpoint_dir: str,
    config: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    *,
    device: Union[str, torch.device, None] = None,
    quantize: bool = False,
    mesh: Any = None,
) -> _AsyncLoad:
    """Start :func:`load_params` on a background thread and return a
    handle; the caller touches the params only after ``result()``."""
    return _AsyncLoad(
        load_params, (checkpoint_dir, config, dtype),
        {"device": device, "quantize": quantize, "mesh": mesh},
    )
