"""Shared durable-journal helper — one crash-safe JSONL discipline.

``memory/store.py`` (incident journal), ``operator/claims.py`` (claim
ledger) and the flight recorder all follow the same append-only pattern;
before this module the first two each carried their own ~80-line copy, so
a durability fix had to land twice.  :class:`Journal` is
that pattern, once:

- **load** — torn-line tolerance: a crash mid-append tears at most the
  final line; corrupt lines are counted and skipped, never the file;
- **append** — one JSON object per line, ``write`` + ``flush`` so the
  record is in the page cache before the caller proceeds;
- **compact** — rewrite to a temp file then atomic ``os.replace``; a
  crash mid-compaction leaves the old journal intact.

Two write modes:

- ``async_writes=False`` (incident store): IO runs on the calling thread
  — the store's mutations already run off the event loop
  (``asyncio.to_thread``), so direct writes block nobody that matters.
- ``async_writes=True`` (claim ledger): IO rides a dedicated writer
  thread (the ``obs/record.py`` pattern) and ``append`` returns after
  *enqueueing* — an NFS-class compaction stall holds the writer thread,
  never the event loop, so routine ledger traffic can no longer stall
  the lease renew loop and depose a healthy leader.  ``append(...,
  wait=True)`` blocks until the line is flushed: ``try_claim`` uses it
  to keep the durable-before-analysis-starts contract (which means that
  ONE wait can still queue behind an in-flight compaction on wedged
  storage — durability and non-blocking are irreconcilable there; the
  exposure shrinks from every append to the rare claim-during-
  compaction).  The single writer thread preserves append/compact order
  exactly as submitted.

Thread-safety contract: callers serialize their own ``append``/``compact``
calls (both adopters hold their store lock across every mutation); the
Journal adds no second lock of its own.

The port's own copy of ``operator_tpu/utils/journal.py``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Optional

log = logging.getLogger(__name__)

__all__ = ["Journal"]


class Journal:
    """Append-only JSONL with torn-line-tolerant load and atomic
    compaction; see module docstring for the write modes."""

    def __init__(
        self,
        path: Optional[str],
        *,
        label: str = "journal",
        async_writes: bool = False,
    ) -> None:
        self.path = path
        self.label = label
        self._handle = None
        self._lines = 0
        #: set by :meth:`abandon` — the SIGKILL-simulation / deposed-
        #: leader state where further IO (INCLUDING jobs already queued
        #: on the writer thread) is discarded, mutating only the
        #: caller's memory
        self._abandoned = False
        self._async_writes = bool(path and async_writes)
        #: created by :meth:`open`, torn down by :meth:`close` — a closed
        #: journal must not park an idle writer thread for the process
        #: lifetime
        self._writer = None

    @property
    def lines(self) -> int:
        """Appended-line count since load/compaction — the caller's
        compaction-trigger input (approximate across threads is fine)."""
        return self._lines

    # -- load ----------------------------------------------------------
    def load(self, replay: Callable[[dict], None]) -> int:
        """Replay every parseable line through ``replay``; corrupt or
        torn lines are skipped with a warning (losing at most the one
        mutation that was mid-write).  Returns the loaded count and
        resets the line counter to it."""
        self._lines = 0
        if not self.path or not os.path.exists(self.path):
            return 0
        loaded = dropped = 0
        with open(self.path, encoding="utf-8", errors="replace") as handle:
            for line in handle:
                line = line.strip()
                if not line:
                    continue
                try:
                    replay(json.loads(line))
                    loaded += 1
                except (ValueError, KeyError, TypeError):
                    dropped += 1
        self._lines = loaded
        if dropped:
            log.warning("%s %s: skipped %d corrupt line(s)",
                        self.label, self.path, dropped)
        return loaded

    # -- handle lifecycle ---------------------------------------------
    def open(self) -> None:
        """(Re)open the append handle, creating parent directories; in
        writer-thread mode, (re)starts the writer too."""
        if not self.path:
            return
        self._abandoned = False
        if self._async_writes and self._writer is None:
            import concurrent.futures

            self._writer = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"journal-{self.label}"
            )
        if self._writer is not None:
            self._submit(self._open_sync)
        else:
            self._open_sync()

    def _open_sync(self) -> None:
        assert self.path is not None
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._handle = open(self.path, "a", encoding="utf-8")

    def close(self, *, flush: bool = True) -> None:
        """Close the handle; with a writer thread, drains queued writes
        first (``flush=True``), then SHUTS the writer down — a closed
        ledger must not leak a parked thread per instance.  :meth:`open`
        restarts it (the reload path)."""
        if self._writer is not None:
            if flush:
                self.flush()
            self._submit(self._close_sync)
            self._writer.shutdown(wait=True)  # barrier incl. the close job
            self._writer = None
        else:
            self._close_sync()

    def _close_sync(self) -> None:
        if self._handle is not None:
            self._handle.close()
            self._handle = None

    def abandon(self) -> None:
        """Drop the handle WITHOUT flushing queued writes — the on-disk
        state a SIGKILL (or a deposed leader) leaves behind.  The flag
        is honoured ON the writer thread too: appends and compactions
        already queued when abandon() runs are discarded at execution
        (a deposed leader's stale compaction must never ``os.replace``
        the journal the new leader is writing).  :meth:`open` resumes."""
        self._abandoned = True
        if self._writer is not None:
            self._submit(self._close_sync)
        else:
            self._close_sync()

    # -- writes --------------------------------------------------------
    def append(self, record: dict, *, wait: bool = False) -> None:
        """Append one record.  Serialized NOW (the record may be live
        state mutated under the caller's lock); written on the calling
        thread, or enqueued to the writer thread when one is configured.
        ``wait=True`` blocks until the line is flushed — the
        durable-before-proceeding form ``try_claim`` relies on."""
        if not self.path or self._abandoned:
            return
        line = json.dumps(record, sort_keys=True) + "\n"
        self._lines += 1
        if self._writer is not None:
            future = self._writer.submit(self._append_sync, line)
            if wait:
                future.result()  # durable append: IO failure propagates
            else:
                future.add_done_callback(self._log_failure)
        else:
            self._append_sync(line)

    def _append_sync(self, line: str) -> None:
        if self._handle is None or self._abandoned:
            return
        self._handle.write(line)
        self._handle.flush()

    def compact(self, records: "list[dict]") -> None:
        """Rewrite the journal as exactly ``records`` — temp file, close
        the old handle, atomic ``os.replace``, reopen.  Serialized NOW;
        the IO runs wherever appends do (writer thread when configured,
        so a compaction stall on slow storage never blocks the caller)."""
        if not self.path or self._abandoned:
            return
        lines = [json.dumps(r, sort_keys=True) + "\n" for r in records]
        self._lines = len(lines)
        if self._writer is not None:
            self._submit(self._compact_sync, lines)
        else:
            self._compact_sync(lines)

    def _compact_sync(self, lines: "list[str]") -> None:
        if self._abandoned:  # queued before abandon(): discard, see abandon
            return
        assert self.path is not None
        tmp = f"{self.path}.tmp"
        with open(tmp, "w", encoding="utf-8") as handle:
            handle.writelines(lines)
        self._close_sync()
        os.replace(tmp, self.path)
        self._open_sync()

    # -- barriers ------------------------------------------------------
    def flush(self, timeout: Optional[float] = 5.0) -> None:
        """Barrier: every previously submitted write has hit disk (no-op
        without a writer thread — direct writes already flushed)."""
        if self._writer is not None:
            self._writer.submit(lambda: None).result(timeout)

    def _submit(self, fn, *args) -> None:
        assert self._writer is not None
        future = self._writer.submit(fn, *args)
        # surface IO failures in the log instead of swallowing them in a
        # never-examined Future (a full disk must be visible, and must
        # not fail the mutation that was being journaled)
        future.add_done_callback(self._log_failure)

    def _log_failure(self, future) -> None:
        exc = future.exception()
        if exc is not None and not isinstance(exc, AssertionError):
            log.warning("%s %s: journal IO failed: %s",
                        self.label, self.path, exc)
