"""The AOT cache of the serving programs: their capture records.

Counterpart of ``operator_tpu/serving/aotcache.py``.  The JAX package
persists each serving program's compiled executable so a warm boot
deserializes instead of compiling.  The port's serving programs are CUDA
graphs (``serving/graphs.py``), and a captured graph cannot be written to
disk, so what the port persists is each program's capture record: its
name, its key and the shapes and dtypes of its static inputs (one
``.aotx`` file per program and key).  A hit does not skip the capture.
It tells the warmup grid which keys the last boot used, so a warm boot
captures every one of them in ``precompile``, before readiness, and then
captures nothing while it serves: that is the port's warm signature, as
``live_compiles == 0`` is the JAX package's.  The kernels' ``nvcc``
libraries persist on their own, in the build directory
(``ops/_build.py``: each named by its sources' hash; an entry point puts
it beside the records through ``utils/platform.py``).

Key discipline is the JAX package's: the directory is keyed by a
fingerprint over everything that shapes a program (model config, the
engine's shape knobs, dtypes) and the runtime it is valid for (torch and
CUDA versions, the driver, the device name and compute capability, the
kernel sources' digest and ``AOT_CACHE_SALT``).  Any mismatch is a miss;
a corrupt or format-bumped record reads as a loud, counted error and is
removed; ``get``/``put`` never raise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pickle
import tempfile
from typing import Any, Iterable, Optional

log = logging.getLogger(__name__)

__all__ = [
    "AotCache",
    "CACHE_FORMAT",
    "CachedProgram",
    "SERVING_PROGRAM_MARKERS",
    "fingerprint_digest",
    "generator_fingerprint",
    "runtime_versions",
    "serving_compile_events",
]

#: bump when the on-disk record layout changes; old files then read as
#: corrupt (loud discard) instead of loading garbage
CACHE_FORMAT = 1

#: filename suffix for one capture record
_SUFFIX = ".aotx"

#: the serving programs' names (``serving/graphs.py`` programs of the wave
#: engine and the continuous scheduler) — what a compile event must
#: contain to count as a serving-program capture.  Kernel builds
#: (``nvcc:<source>``) and the encoder's graphs are not serving programs.
SERVING_PROGRAM_MARKERS = (
    "prefill_fn", "chunk_fn", "finish_fn", "mixed_fn", "_decode_block",
)


def serving_compile_events(events: Iterable) -> list:
    """Filter a ``CompileWatcher`` event list down to serving-program
    captures (see SERVING_PROGRAM_MARKERS).  Events are the watcher's
    ``(t, name, duration)`` tuples."""
    return [
        ev for ev in events
        if any(marker in ev[1] for marker in SERVING_PROGRAM_MARKERS)
    ]


def runtime_versions() -> dict:
    """The runtime facts a capture record and a built kernel are valid
    for: torch and CUDA versions, the driver, the device's name and
    compute capability, the kernel sources' digest.  ``AOT_CACHE_SALT``
    folds in so operators (and tests) can force a cold boot without
    deleting anything."""
    import torch

    from ..ops import _build

    platform, device, capability, driver = "cpu", "cpu", "", ""
    if torch.cuda.is_available():
        platform = "cuda"
        device = torch.cuda.get_device_name(0)
        capability = ".".join(str(v) for v in torch.cuda.get_device_capability(0))
        try:
            driver = str(torch._C._cuda_getDriverVersion())
        except Exception:  # noqa: BLE001 - private API moved: key without it
            driver = "?"
    return {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "driver": driver,
        "platform": platform,
        "device": device,
        "capability": capability,
        "kernels": _build.sources_digest(),
        "salt": os.environ.get("AOT_CACHE_SALT", ""),
    }


def _dtype_name(dtype: Any) -> str:
    if dtype is None:
        return "bfloat16"
    name = getattr(dtype, "__name__", None) or str(dtype)
    return name.removeprefix("torch.")


def generator_fingerprint(
    *,
    config: Any,
    weight_dtype: str,
    max_slots: int,
    max_seq: Optional[int] = None,
    cache_dtype: Any = None,
    paged: bool = False,
    page_size: int = 64,
    kv_pages: Optional[int] = None,
    mesh: Any = None,
    decode_block: int = 1,
    sample_top_k: Optional[int] = None,
    pipeline_depth: int = 1,
    prefill_chunk: Optional[int] = None,
    sched_pipeline_depth: int = 1,
    spec_width: int = 1,
    kv_prefix_cache: bool = False,
    lora_names: Iterable[str] = (),
) -> dict:
    """The fingerprint payload for a ``Generator`` shape, with the JAX
    package's keys.  Called with the constructor's arguments (provider
    and tests) or the generator's resolved attributes; a divergence reads
    as a miss, never as a wrong load.  ``mesh`` (a ``DeviceMesh``) keys on
    :func:`_mesh_desc`, the same on every boot of the same layout."""
    try:
        model = dataclasses.asdict(config)
    except TypeError:
        model = {k: v for k, v in vars(config).items() if not k.startswith("_")}
    max_seq_limit = int(model.get("max_seq_len") or 0) or None
    resolved_seq = min(max_seq or max_seq_limit, max_seq_limit) if max_seq_limit else max_seq
    return {
        "format": CACHE_FORMAT,
        "model": model,
        "weight_dtype": weight_dtype,
        "max_slots": int(max_slots),
        "max_seq": resolved_seq,
        "cache_dtype": _dtype_name(cache_dtype),
        "paged": bool(paged),
        "page_size": int(page_size),
        "kv_pages": int(kv_pages or 0),
        "mesh": _mesh_desc(mesh),
        "decode_block": int(decode_block),
        "sample_top_k": int(sample_top_k) if sample_top_k else None,
        "pipeline_depth": int(pipeline_depth),
        "prefill_chunk": int(prefill_chunk) if prefill_chunk else None,
        # the mixed step's sampled width (1 + spec_lookup_k) shapes it;
        # depth keys the join conservatively (a flip re-warms)
        "sched_pipeline_depth": int(sched_pipeline_depth),
        "spec_width": int(spec_width),
        "kv_prefix_cache": bool(kv_prefix_cache),
        "lora": sorted(str(n) for n in lora_names if n),
        "runtime": runtime_versions(),
    }


def _mesh_desc(mesh: Any) -> Optional[dict]:
    """A serving mesh as the fingerprint keys it (JAX's axes, device
    count and device kind, and this rank's place: each rank captures its
    own shard's programs).  Nothing of it changes between boots."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    kind = mesh.device_type
    if kind == "cuda":
        import torch

        kind = torch.cuda.get_device_name(torch.cuda.current_device())
    return {
        "axes": dict(zip(names, (int(n) for n in mesh.shape))),
        "devices": int(mesh.size()),
        "kind": kind,
        "rank": {name: int(mesh.get_local_rank(name)) for name in names},
    }


def fingerprint_digest(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def record_name(program: str, key: Any) -> str:
    """File stem of one program's record at one key."""
    digest = hashlib.sha256(repr(key).encode("utf-8")).hexdigest()[:16]
    return f"{program}-{digest}"


class AotCache:
    """One fingerprint-keyed directory of capture records.

    ``get``/``put`` never raise: a miss or any I/O or decode error costs a
    capture, never correctness, with a loud log line and the
    ``podmortem_aot_cache_{hit,miss,store,error}_total`` counters.
    """

    def __init__(self, path: str, payload: dict, *, metrics: Any = None) -> None:
        self.payload = payload
        self.fingerprint = fingerprint_digest(payload)
        self.dir = os.path.join(path, self.fingerprint[:32])
        self.metrics = metrics
        self.hits = 0
        self.misses = 0
        self.errors = 0
        self.stored = 0
        #: programs captured under this cache with no record (cold, or
        #: after a discarded record) — the number a warm boot wants at zero
        self.live_compiles = 0
        #: the JAX cache's environmental deserialize failure; a capture
        #: record has no counterpart, so it stays 0 (the key is kept so
        #: ``stats()`` reads the same in both packages)
        self.symbol_errors = 0
        #: every capture under this cache, recorded or not (a warm boot
        #: captures each recorded key once: graphs cannot be restored)
        self.captures = 0
        self._warned_cold = False

    # -- bookkeeping ----------------------------------------------------
    def _incr(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.incr(name)

    def _file(self, name: str) -> str:
        return os.path.join(self.dir, name + _SUFFIX)

    def stats(self) -> dict:
        return {
            "fingerprint": self.fingerprint[:16],
            "dir": self.dir,
            "hits": self.hits,
            "misses": self.misses,
            "errors": self.errors,
            "symbol_errors": self.symbol_errors,
            "stored": self.stored,
            "live_compiles": self.live_compiles,
            "captures": self.captures,
        }

    # -- load -----------------------------------------------------------
    def _load(self, path: str) -> dict:
        with open(path, "rb") as f:
            record = pickle.load(f)
        if not isinstance(record, dict):
            raise ValueError(f"not a cache record: {type(record).__name__}")
        if record.get("format") != CACHE_FORMAT:
            raise ValueError(f"cache format {record.get('format')!r} != {CACHE_FORMAT}")
        return record

    def records(self) -> list[dict]:
        """Every readable record in the directory (no counters move; an
        unreadable file is left for ``get`` to discard loudly)."""
        try:
            names = sorted(f for f in os.listdir(self.dir) if f.endswith(_SUFFIX))
        except OSError:
            return []  # cold boot: the directory appears on the first put
        out = []
        for fname in names:
            try:
                out.append(self._load(os.path.join(self.dir, fname)))
            except Exception:  # noqa: BLE001 - reported by get()
                continue
        return out

    def get(self, name: str) -> Optional[dict]:
        """The record stored for ``name``, or None (miss or corrupt — the
        caller captures and stores)."""
        path = self._file(name)
        if not os.path.exists(path):
            self.misses += 1
            self._incr("aot_cache_miss")
            if not self._warned_cold:
                self._warned_cold = True
                log.warning(
                    "AOT executable cache MISS for %r (fingerprint %s): "
                    "capturing live and persisting for the next boot "
                    "(further misses this boot log at DEBUG)",
                    name, self.fingerprint[:16],
                )
            else:
                log.debug("AOT cache miss: %s", name)
            return None
        try:
            record = self._load(path)
        except Exception:  # noqa: BLE001 - corrupt entry: loud discard
            self.errors += 1
            self._incr("aot_cache_error")
            log.warning(
                "AOT cache entry %r failed to deserialize; falling back to "
                "a live capture and discarding the file", name, exc_info=True,
            )
            self._remove(name)
            return None
        self.hits += 1
        self._incr("aot_cache_hit")
        return record

    def _remove(self, name: str) -> None:
        try:
            os.remove(self._file(name))
        except OSError:
            pass

    # -- store ----------------------------------------------------------
    def put(self, name: str, record: dict) -> bool:
        """Persist one capture record (atomic rename, so a crash mid-write
        leaves a temp file, never a torn entry)."""
        try:
            blob = pickle.dumps({"format": CACHE_FORMAT, "name": name, **record})
            os.makedirs(self.dir, exist_ok=True)
            self._write_manifest()
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, self._file(name))
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
        except Exception:  # noqa: BLE001 - persistence is an optimisation only
            self.errors += 1
            self._incr("aot_cache_error")
            log.warning("AOT cache store failed for %r", name, exc_info=True)
            return False
        self.stored += 1
        self._incr("aot_cache_store")
        return True

    def _write_manifest(self) -> None:
        """Human-readable key anatomy next to the records, so a surprising
        miss is debuggable by diffing two manifests."""
        manifest = os.path.join(self.dir, "fingerprint.json")
        if os.path.exists(manifest):
            return
        try:
            with open(manifest, "w") as f:
                json.dump(
                    {"fingerprint": self.fingerprint, "payload": self.payload},
                    f, indent=2, sort_keys=True, default=str,
                )
        except OSError:
            pass


class CachedProgram:
    """One serving program's bookkeeping against the AOT cache.

    ``serving/graphs.py:GraphProgram`` asks :meth:`lookup` at the first
    use of each key (a hit when the key's record exists, else a counted
    miss) and calls :meth:`captured` when the capture is done: a missed
    key counts as a live compile and its record is stored for the next
    boot."""

    __slots__ = ("name", "_cache", "_hit")

    def __init__(self, cache: AotCache, name: str) -> None:
        self.name = name
        self._cache = cache
        self._hit: dict = {}

    def lookup(self, key: Any) -> bool:
        hit = self._cache.get(record_name(self.name, key)) is not None
        self._hit[key] = hit
        return hit

    def captured(self, key: Any, inputs: list, seconds: float) -> None:
        cache = self._cache
        cache.captures += 1
        if self._hit.pop(key, False):
            return
        cache.live_compiles += 1
        log.info(
            "AOT cache: captured %s %r live in %.2fs; persisting",
            self.name, key, seconds,
        )
        cache.put(record_name(self.name, key), {
            "program": self.name, "key": key, "inputs": inputs,
        })
