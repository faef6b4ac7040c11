"""Git pattern sync: PatternLibrary reconciler + repository sync service.

The port's own copy of ``operator_tpu/operator/patternsync.py``: host code, the same names and
behaviour.

Parity with reference PatternLibraryReconciler + PatternSyncService
(SURVEY.md §3.4): clone-or-pull each spec.repository into
``<cache>/<library>/<repo>``, refresh on ``spec.refreshInterval``
(30s/5m/1h/2d/1h30m), discover available libraries, and maintain status —
including per-repo ``syncedRepositories`` entries, which the reference CRD
declares but its reconciler stubs out (PatternLibraryReconciler.java:171-176).

Improvements over the reference, both called out by the survey:
- the credentials secret namespace follows the secretRef / CR namespace
  instead of a hardcoded ``podmortem-system`` (:149);
- after a successful sync the in-process PatternEngine reloads, so new
  patterns apply without a restart (the reference relies on the parser
  service re-reading the PVC).

Git runs as a subprocess (the JGit role) with credentials injected through
a temporary ``GIT_ASKPASS`` helper so tokens never appear in argv or remote
URLs on disk.
"""

from __future__ import annotations

import asyncio
import datetime
import logging
import os
import stat
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..patterns.engine import PatternEngine
from ..patterns.loader import discover_library_files
from ..schema.crds import (
    PatternLibrary,
    PatternRepository,
    SyncedRepository,
    parse_refresh_interval,
)
from ..schema.kube import Secret
from ..schema.meta import now_iso
from ..utils.config import OperatorConfig
from .kubeapi import ApiError, KubeApi, NotFoundError

log = logging.getLogger(__name__)


class GitSyncError(Exception):
    pass


@dataclass
class SyncOutcome:
    repo_name: str
    commit: Optional[str] = None
    pattern_count: int = 0
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


class GitSyncService:
    def __init__(self, config: Optional[OperatorConfig] = None) -> None:
        self.config = config or OperatorConfig()
        #: opt-in chaos seam (utils/faultinject.py): consulted per git verb
        #: under "git.<verb>" — e.g. fail a clone twice then let it succeed
        self.fault_plan = None

    # ------------------------------------------------------------------
    async def _git(
        self,
        *args: str,
        cwd: Optional[str] = None,
        token: Optional[str] = None,
    ) -> str:
        env = dict(os.environ)
        env["GIT_TERMINAL_PROMPT"] = "0"
        askpass_path: Optional[str] = None
        if token:
            # username/token both answered by the helper; covers the
            # reference's user:pass and bare-token forms (PatternSyncService
            # .java:141-151) without leaking the token into argv
            fd, askpass_path = tempfile.mkstemp(prefix="askpass-", suffix=".sh")
            user = "token"
            if ":" in token:
                user, token = token.split(":", 1)
            with os.fdopen(fd, "w") as f:
                f.write(
                    "#!/bin/sh\ncase \"$1\" in\n*sername*) echo '%s' ;;\n*) echo '%s' ;;\nesac\n"
                    % (user.replace("'", ""), token.replace("'", ""))
                )
            os.chmod(askpass_path, stat.S_IRWXU)
            env["GIT_ASKPASS"] = askpass_path
        # human-readable verb for error messages: skip -C <path> and flags
        arg_list = list(args)
        verb_args = arg_list[2:] if arg_list[:1] == ["-C"] else arg_list
        verb = next((a for a in verb_args if not a.startswith("-")), "command")
        if self.fault_plan is not None:
            # chaos seam: injected GitSyncError/OSError surfaces exactly as
            # a real subprocess failure would (SyncOutcome.error populated,
            # per-repo status entry "Failed")
            self.fault_plan.apply(f"git.{verb}", cwd=cwd)
        try:
            proc = await asyncio.create_subprocess_exec(
                self.config.git_binary,
                *args,
                cwd=cwd,
                env=env,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE,
            )
            try:
                stdout, stderr = await asyncio.wait_for(
                    proc.communicate(), timeout=self.config.sync_timeout_s
                )
            except asyncio.TimeoutError:
                proc.kill()
                raise GitSyncError(f"git {verb} timed out")
            if proc.returncode != 0:
                raise GitSyncError(
                    f"git {verb} failed: {stderr.decode(errors='replace').strip()[:500]}"
                )
            return stdout.decode(errors="replace")
        finally:
            if askpass_path:
                try:
                    os.unlink(askpass_path)
                except OSError:
                    pass

    # ------------------------------------------------------------------
    async def sync_repository(
        self,
        library_name: str,
        repo: PatternRepository,
        *,
        token: Optional[str] = None,
    ) -> SyncOutcome:
        """Clone-or-pull (idempotent/incremental, reference
        PatternSyncService.java:42-58)."""
        target = Path(self.config.pattern_cache_directory) / library_name / (repo.name or "repo")
        outcome = SyncOutcome(repo_name=repo.name or "repo")
        try:
            if (target / ".git").is_dir():
                await self._git("-C", str(target), "fetch", "origin", token=token)
                await self._git(
                    "-C", str(target), "reset", "--hard", f"origin/{repo.branch}", token=token
                )
            else:
                target.parent.mkdir(parents=True, exist_ok=True)
                await self._git(
                    "clone",
                    "--depth", "1",
                    "--branch", repo.branch,
                    repo.url or "",
                    str(target),
                    token=token,
                )
            commit = (await self._git("-C", str(target), "rev-parse", "HEAD")).strip()
            outcome.commit = commit
            outcome.pattern_count = len(discover_library_files(target))
            if outcome.pattern_count == 0:
                log.warning("repo %s synced but contains no pattern YAMLs (reference "
                            "validatePatterns warning, PatternSyncService.java:228-245)",
                            repo.name)
        except GitSyncError as exc:
            outcome.error = str(exc)
        except OSError as exc:
            outcome.error = f"filesystem error: {exc}"
        return outcome


class PatternLibraryReconciler:
    def __init__(
        self,
        api: KubeApi,
        sync: Optional[GitSyncService] = None,
        *,
        engine: Optional[PatternEngine] = None,
        config: Optional[OperatorConfig] = None,
    ) -> None:
        self.api = api
        self.config = config or OperatorConfig()
        self.sync = sync or GitSyncService(self.config)
        self.engine = engine

    # ------------------------------------------------------------------
    def needs_sync(self, library: PatternLibrary, *, now: Optional[datetime.datetime] = None) -> bool:
        """now > lastSyncTime + refreshInterval (reference :207-245)."""
        status = library.status
        if status is None or not status.last_sync_time:
            return True
        try:
            last = datetime.datetime.fromisoformat(status.last_sync_time.replace("Z", "+00:00"))
        except ValueError:
            return True
        interval = parse_refresh_interval(library.spec.refresh_interval)
        now = now or datetime.datetime.now(datetime.timezone.utc)
        return now >= last + datetime.timedelta(seconds=interval)

    async def _credentials_for(self, library: PatternLibrary, repo: PatternRepository) -> Optional[str]:
        """Token from the repo's secretRef; namespace defaults to the CR's
        (fixing the reference's hardcoded podmortem-system, :145-161)."""
        creds = repo.credentials
        if creds is None or creds.secret_ref is None or not creds.secret_ref.name:
            return None
        ref = creds.secret_ref
        namespace = ref.namespace or library.metadata.namespace or "default"
        try:
            secret = Secret.parse(await asyncio.wait_for(
                self.api.get("Secret", ref.name, namespace),
                timeout=self.config.kube_call_timeout_s,
            ))
        except NotFoundError:
            log.warning("credentials secret %s/%s not found", namespace, ref.name)
            return None
        except (ApiError, asyncio.TimeoutError) as exc:
            log.warning("credentials secret fetch failed: %s",
                        str(exc) or "timed out")
            return None
        return secret.decoded(ref.key or "token")

    # ------------------------------------------------------------------
    async def reconcile(self, library: PatternLibrary, *, force: bool = False) -> Optional[int]:
        """Sync all repos if due; returns seconds until next sync (the
        rescheduleAfter contract, reference :94-95), or None on no-op."""
        interval = parse_refresh_interval(library.spec.refresh_interval)
        if not force and not self.needs_sync(library):
            return None
        name = library.qualified_name()
        await self._patch_status(library, {"phase": "Syncing", "message": "sync in progress"})
        outcomes: list[SyncOutcome] = []
        for repo in library.spec.repositories:
            token = await self._credentials_for(library, repo)
            outcome = await self.sync.sync_repository(
                library.metadata.name or "library", repo, token=token
            )
            outcomes.append(outcome)
            if outcome.ok:
                log.info("synced %s/%s @ %s (%d pattern files)",
                         name, outcome.repo_name, (outcome.commit or "")[:12], outcome.pattern_count)
            else:
                log.error("sync failed %s/%s: %s", name, outcome.repo_name, outcome.error)
        from ..patterns.loader import available_libraries

        libs = available_libraries(self.config.pattern_cache_directory)
        failures = [o for o in outcomes if not o.ok]
        phase = "Ready" if not failures else "Failed"
        message = (
            f"{len(outcomes) - len(failures)}/{len(outcomes)} repositories synced"
            if outcomes
            else "no repositories configured"
        )
        synced = [
            SyncedRepository(
                name=o.repo_name,
                last_sync_time=now_iso(),
                last_sync_commit=o.commit,
                status="Synced" if o.ok else "Failed",
                message=o.error,
                pattern_count=o.pattern_count,
            )
            for o in outcomes
        ]
        from ..schema.serde import to_dict

        await self._patch_status(
            library,
            {
                "phase": phase,
                "message": message,
                "lastSyncTime": now_iso(),
                "syncedRepositories": [to_dict(s) for s in synced],
                "availableLibraries": libs,
            },
        )
        if self.engine is not None:
            await asyncio.to_thread(self.engine.reload)
        return interval

    async def _patch_status(self, library: PatternLibrary, status: dict) -> None:
        try:
            await asyncio.wait_for(
                self.api.patch_status(
                    "PatternLibrary", library.metadata.name,
                    library.metadata.namespace, status,
                ),
                timeout=self.config.kube_call_timeout_s,
            )
        except (ApiError, asyncio.TimeoutError) as exc:
            log.warning("patternlibrary status patch failed for %s: %s",
                        library.qualified_name(), str(exc) or "timed out")

    # ------------------------------------------------------------------
    async def run(self, stop: asyncio.Event, *, poll_interval_s: float = 15.0) -> None:
        """Self-rescheduling loop: check each CR's due time periodically
        (the reference reschedules per-CR via the operator SDK; a poll at
        15s granularity gives the same behaviour within one tick)."""
        while not stop.is_set():
            try:
                libraries = await asyncio.wait_for(
                    self.api.list("PatternLibrary"),
                    timeout=self.config.kube_call_timeout_s,
                )
                for raw in libraries:
                    if stop.is_set():
                        return
                    await self.reconcile(PatternLibrary.parse(raw))
            except (ApiError, asyncio.TimeoutError) as exc:
                log.warning("patternlibrary list failed: %s",
                            str(exc) or "timed out")
            try:
                await asyncio.wait_for(stop.wait(), timeout=poll_interval_s)
            except asyncio.TimeoutError:
                pass
