"""Wire format for one KV block on the fabric (PMKV1).

The port's own copy of ``operator_tpu/fabric/wire.py``.  A block travels
as::

    PMKV1\\n
    {"hash": <32 hex>, "k": {...}, "v": {...}, "sha256": <payload hex>}\\n
    <raw k bytes><raw v bytes>

The header is one JSON line (``json.dumps(header, sort_keys=True)``) so a
reader can split on the first newline after the magic; the payload is the
two tensors' contiguous bytes back to back, and the checksum covers the
payload only (the header is self-validating: shape and dtype must
reconstruct exactly the payload's length).  Dtypes are named as numpy
names them (``float32``, ``float16``, ``bfloat16`` as ``ml_dtypes``
prints it, ``float8_e4m3fn``...), so for the same values both packages
put the same bytes on the wire and each decodes the other's.

Pages live in the holder's ``HostKVPool`` as host tensors
``[layers, page_size, kv_heads, head_dim]``.  Decoding COPIES each tensor
out of the response buffer into storage of its own: a view would pin the
whole wire blob (header and both tensors) behind a page-sized pool entry,
breaking the pool's ``k.nbytes + v.nbytes`` accounting.
"""

from __future__ import annotations

import hashlib
import json
import math

import torch

__all__ = ["MAGIC", "CorruptBlock", "decode_block", "encode_block"]

MAGIC = b"PMKV1\n"

#: numpy's dtype names (the JAX package's header spelling) and their tensors
_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "float8_e4m3fnuz": torch.float8_e4m3fnuz,
    "float8_e5m2fnuz": torch.float8_e5m2fnuz,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


class CorruptBlock(ValueError):
    """The bytes on the wire do not reconstruct the advertised block."""


def _spec(tensor: torch.Tensor) -> dict:
    return {"dtype": _NAMES[tensor.dtype], "shape": list(tensor.shape)}


def _raw(tensor: torch.Tensor) -> bytes:
    return tensor.reshape(-1).view(torch.uint8).numpy().tobytes()


def encode_block(block_hash: bytes, k: torch.Tensor, v: torch.Tensor) -> bytes:
    """Serialize one block's ``(k, v)`` host page pair for the wire."""
    k, v = k.contiguous(), v.contiguous()
    payload = _raw(k) + _raw(v)
    header = {
        "hash": block_hash.hex(),
        "k": _spec(k),
        "v": _spec(v),
        "sha256": hashlib.sha256(payload).hexdigest(),
    }
    return MAGIC + json.dumps(header, sort_keys=True).encode("utf-8") + b"\n" + payload


def _reconstruct(spec, payload: memoryview, offset: int) -> "tuple[torch.Tensor, int]":
    try:
        dtype = _DTYPES[spec["dtype"]]
        shape = tuple(int(d) for d in spec["shape"])
    except (KeyError, TypeError, ValueError, AttributeError) as exc:
        raise CorruptBlock(f"bad array spec: {exc!r}") from exc
    if any(d < 0 for d in shape):
        raise CorruptBlock(f"bad array spec: negative dimension in {shape}")
    nbytes = math.prod(shape) * dtype.itemsize
    if offset + nbytes > len(payload):
        raise CorruptBlock("payload shorter than header claims")
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype), offset
    # one copy of exactly this tensor's bytes, writable and owned by the
    # tensor (frombuffer over the immutable response would warn and pin it)
    own = bytearray(payload[offset:offset + nbytes])
    tensor = torch.frombuffer(own, dtype=dtype).reshape(shape)
    return tensor, offset + nbytes


def decode_block(data: bytes) -> "tuple[bytes, torch.Tensor, torch.Tensor]":
    """Parse wire bytes back into ``(block_hash, k, v)``.

    Raises :class:`CorruptBlock` on any mismatch (magic, header, dtype,
    payload length, checksum); callers treat that exactly like a fetch
    miss and recompute."""
    if not data.startswith(MAGIC):
        raise CorruptBlock("bad magic")
    newline = data.find(b"\n", len(MAGIC))
    if newline < 0:
        raise CorruptBlock("truncated header")
    view = memoryview(data)
    try:
        header = json.loads(bytes(view[len(MAGIC):newline]).decode("utf-8"))
        block_hash = bytes.fromhex(header["hash"])
        advertised = header["sha256"]
    except (KeyError, TypeError, ValueError, AttributeError) as exc:
        raise CorruptBlock(f"bad header: {exc!r}") from exc
    payload = view[newline + 1:]
    if hashlib.sha256(payload).hexdigest() != advertised:
        raise CorruptBlock("payload checksum mismatch")
    k, offset = _reconstruct(header.get("k", {}), payload, 0)
    v, offset = _reconstruct(header.get("v", {}), payload, offset)
    if offset != len(payload):
        raise CorruptBlock("trailing bytes after payload")
    return block_hash, k, v
