"""The port's git pattern sync against the JAX package's
(``tests/test_patternsync.py``), on local git repositories.

Each case drives both packages over the same remote and compares what
comes out: clone then pull (commits and pattern counts), a bad remote's
error, the reconciler's full cycle (PatternLibrary status, per-repository
entries, the engine's reload and the synced pattern's match, the
not-due no-op), a partial failure, the refresh-interval arithmetic, the
credentials Secret lookup, and the ``git.<verb>`` fault seam.

Tolerance: exact, after ``test_torch_operator.normalise`` (timestamps
become placeholders) and with each package's cache directory replaced by
one placeholder.  Skipped when ``git`` is not installed.
"""

import asyncio
import base64
import datetime
import importlib
import shutil
import subprocess
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from test_torch_operator import normalise  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("git") is None, reason="git is not installed")

_MODULES = ("operator", "patterns.engine", "schema", "schema.crds", "utils.config",
            "utils.faultinject")


def _package(root: str) -> SimpleNamespace:
    mods = {name.replace(".", "_"): importlib.import_module(f"{root}.{name}") for name in _MODULES}
    return SimpleNamespace(name="port" if root == "operator_tpu_torch" else "jax", **mods)


PKGS = {"jax": _package("operator_tpu"), "port": _package("operator_tpu_torch")}


def run(coro):
    return asyncio.run(coro)


def git(*args, cwd=None):
    subprocess.run(["git", *args], cwd=cwd, check=True, capture_output=True,
                   env={"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
                        "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
                        "GIT_AUTHOR_DATE": "2026-07-28T09:00:00Z",
                        "GIT_COMMITTER_DATE": "2026-07-28T09:00:00Z",
                        "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": "/tmp"})


def make_remote(root, name="patterns-remote"):
    remote = root / name
    remote.mkdir(parents=True)
    git("init", "-b", "main", str(remote))
    (remote / "quarkus.yaml").write_text(yaml.safe_dump({
        "metadata": {"libraryId": "quarkus"},
        "patterns": [{"id": "q1", "name": "Q1", "severity": "HIGH",
                      "primaryPattern": {"regex": "QUARKUS_FAIL"}}],
    }))
    git("add", "-A", cwd=str(remote))
    git("commit", "-m", "init", cwd=str(remote))
    return remote


def _scrub(value, cache: str):
    """``normalise`` plus the package's cache directory as a placeholder."""
    if isinstance(value, dict):
        return {k: _scrub(v, cache) for k, v in value.items()}
    if isinstance(value, list):
        return [_scrub(v, cache) for v in value]
    if isinstance(value, str):
        return value.replace(cache, "<cache>")
    return value


def both(scenario, tmp_path):
    """(jax, port) results of ``scenario(pkg, cache_dir, remote_root)``,
    over one remote root shared by both packages."""
    out = []
    for name in ("jax", "port"):
        cache = str(tmp_path / name / "cache")
        out.append(normalise(_scrub(run(scenario(PKGS[name], cache, tmp_path)), cache)))
    return tuple(out)


def _outcome(o) -> dict:
    return {"repo": o.repo_name, "commit": o.commit, "count": o.pattern_count,
            "error": o.error, "ok": o.ok}


async def _clone_then_pull(pkg, cache, root) -> dict:
    remote = root / "remote" if (root / "remote").exists() else make_remote(root, "remote")
    config = pkg.utils_config.OperatorConfig(pattern_cache_directory=cache)
    sync = pkg.operator.GitSyncService(config)
    repo = pkg.schema.PatternRepository(name="main-repo", url=str(remote), branch="main")
    first = _outcome(await sync.sync_repository("mylib", repo))
    return {"first": first, "second": _outcome(await sync.sync_repository("mylib", repo))}


def test_clone_then_pull_is_idempotent_as_jax(tmp_path):
    ref, port = both(_clone_then_pull, tmp_path)
    assert port == ref
    first, second = port["first"], port["second"]
    assert first["ok"] and first["count"] == 1 and second["commit"] == first["commit"]


async def _pull_picks_up_a_new_commit(pkg, cache, root) -> list:
    remote = make_remote(root / pkg.name, "remote")
    config = pkg.utils_config.OperatorConfig(pattern_cache_directory=cache)
    sync = pkg.operator.GitSyncService(config)
    repo = pkg.schema.PatternRepository(name="main-repo", url=str(remote), branch="main")
    first = await sync.sync_repository("mylib", repo)
    (remote / "python.yaml").write_text(yaml.safe_dump({
        "patterns": [{"id": "p1", "primaryPattern": {"regex": "PY_FAIL"}}]}))
    git("add", "-A", cwd=str(remote))
    git("commit", "-m", "more", cwd=str(remote))
    second = await sync.sync_repository("mylib", repo)
    return [first.ok, second.ok, first.commit != second.commit, second.pattern_count]


def test_pull_picks_up_a_new_commit_as_jax(tmp_path):
    ref, port = both(_pull_picks_up_a_new_commit, tmp_path)
    assert port == ref == [True, True, True, 2]


async def _bad_remote(pkg, cache, root) -> dict:
    config = pkg.utils_config.OperatorConfig(pattern_cache_directory=cache, sync_timeout_s=10)
    repo = pkg.schema.PatternRepository(name="bad", url=str(root / "missing-remote"))
    return _outcome(await pkg.operator.GitSyncService(config).sync_repository("lib", repo))


def test_bad_remote_reports_the_git_error_as_jax(tmp_path):
    ref, port = both(_bad_remote, tmp_path)
    assert port == ref
    assert not port["ok"] and "git clone failed" in port["error"]


async def _full_cycle(pkg, cache, root) -> dict:
    remote = root / "remote" if (root / "remote").exists() else make_remote(root, "remote")
    s = pkg.schema
    config = pkg.utils_config.OperatorConfig(pattern_cache_directory=cache)
    api = pkg.operator.FakeKubeApi()
    engine = pkg.patterns_engine.PatternEngine(cache_dir=cache)
    reconciler = pkg.operator.PatternLibraryReconciler(
        api, pkg.operator.GitSyncService(config), engine=engine, config=config)
    library = s.PatternLibrary(
        metadata=s.ObjectMeta(name="mylib", namespace="ns"),
        spec=s.PatternLibrarySpec(repositories=[s.PatternRepository(name="r1", url=str(remote))],
                                  refresh_interval="30m"),
    )
    await api.create("PatternLibrary", library.to_dict())
    interval = await reconciler.reconcile(library)
    status = (await api.get("PatternLibrary", "mylib", "ns"))["status"]
    result = engine.analyze(s.PodFailureData(logs="x\nQUARKUS_FAIL boom\n"))
    fresh = s.PatternLibrary.parse(await api.get("PatternLibrary", "mylib", "ns"))
    return {"interval": interval, "status": status,
            "events": [(e.matched_pattern.id, e.score) for e in result.events],
            "not_due": await reconciler.reconcile(fresh)}


def test_reconciler_full_cycle_and_engine_reload_as_jax(tmp_path):
    ref, port = both(_full_cycle, tmp_path)
    assert port == ref
    assert port["interval"] == 1800 and port["not_due"] is None
    status = port["status"]
    assert status["phase"] == "Ready" and status["availableLibraries"] == ["quarkus"]
    (synced,) = status["syncedRepositories"]
    assert synced["status"] == "Synced" and synced["patternCount"] == 1
    assert len(synced["lastSyncCommit"]) == 40
    assert any(pid == "q1" for pid, _ in port["events"])


async def _partial_failure(pkg, cache, root) -> dict:
    remote = root / "remote" if (root / "remote").exists() else make_remote(root, "remote")
    s = pkg.schema
    config = pkg.utils_config.OperatorConfig(pattern_cache_directory=cache, sync_timeout_s=10)
    api = pkg.operator.FakeKubeApi()
    reconciler = pkg.operator.PatternLibraryReconciler(
        api, pkg.operator.GitSyncService(config), config=config)
    library = s.PatternLibrary(
        metadata=s.ObjectMeta(name="mixed", namespace="ns"),
        spec=s.PatternLibrarySpec(repositories=[
            s.PatternRepository(name="good", url=str(remote)),
            s.PatternRepository(name="bad", url=str(root / "nope")),
        ]),
    )
    await api.create("PatternLibrary", library.to_dict())
    await reconciler.reconcile(library)
    return (await api.get("PatternLibrary", "mixed", "ns"))["status"]


def test_partial_failure_sets_the_failed_phase_as_jax(tmp_path):
    ref, port = both(_partial_failure, tmp_path)
    assert port == ref
    assert port["phase"] == "Failed" and "1/2 repositories synced" in port["message"]


def _needs_sync(pkg) -> list:
    s = pkg.schema
    reconciler = pkg.operator.PatternLibraryReconciler(pkg.operator.FakeKubeApi())
    library = s.PatternLibrary(metadata=s.ObjectMeta(name="x", namespace="ns"),
                               spec=s.PatternLibrarySpec(refresh_interval="1h"))
    out = [reconciler.needs_sync(library)]
    library.status = pkg.schema_crds.PatternLibraryStatus(last_sync_time="2026-07-28T00:00:00Z")
    for minute in (30, 60, 61):
        now = datetime.datetime(2026, 7, 28, 0, 0, tzinfo=datetime.timezone.utc) + \
            datetime.timedelta(minutes=minute)
        out.append(reconciler.needs_sync(library, now=now))
    library.status.last_sync_time = "garbage"
    out.append(reconciler.needs_sync(library))
    return out


def test_needs_sync_time_arithmetic_matches_jax():
    ref, port = (_needs_sync(PKGS[name]) for name in ("jax", "port"))
    assert port == ref == [True, False, True, True, True]


async def _credentials(pkg, cache, root) -> list:
    s = pkg.schema
    api = pkg.operator.FakeKubeApi()
    await api.create("Secret", {"metadata": {"name": "git-token", "namespace": "ns"},
                                "data": {"token": base64.b64encode(b"user:tok").decode()}})
    reconciler = pkg.operator.PatternLibraryReconciler(
        api, config=pkg.utils_config.OperatorConfig(pattern_cache_directory=cache))
    library = s.PatternLibrary(metadata=s.ObjectMeta(name="lib", namespace="ns"))
    out = []
    for ref in ({"name": "git-token"}, {"name": "git-token", "namespace": "other"},
                {"name": "absent"}, None):
        repo = s.from_dict(s.PatternRepository, {
            "name": "r", "url": "https://example.invalid/r.git",
            **({"credentials": {"secretRef": ref}} if ref else {}),
        })
        out.append(await reconciler._credentials_for(library, repo))
    return out


def test_credentials_secret_lookup_matches_jax(tmp_path):
    ref, port = both(_credentials, tmp_path)
    assert port == ref
    assert port[0] == "user:tok" and port[1:] == [None, None, None]


async def _git_fault_seam(pkg, cache, root) -> dict:
    remote = root / "remote" if (root / "remote").exists() else make_remote(root, "remote")
    fi = pkg.utils_faultinject
    config = pkg.utils_config.OperatorConfig(pattern_cache_directory=cache)
    sync = pkg.operator.GitSyncService(config)
    plan = fi.FaultPlan(seed=7)
    GitSyncError = importlib.import_module(
        pkg.operator.GitSyncService.__module__).GitSyncError
    plan.rule("git.clone", fi.times(2, fi.raise_(lambda: GitSyncError("injected clone failure"),
                                                 "clone")))
    plan.rule("git.rev-parse", [fi.OK, fi.delay_(0.001)])
    sync.fault_plan = plan
    repo = pkg.schema.PatternRepository(name="r", url=str(remote), branch="main")
    outcomes = [await sync.sync_repository("lib", repo) for _ in range(3)]
    return {"ok": [o.ok for o in outcomes], "errors": [o.error for o in outcomes], "trace": plan.trace(), "fingerprint": plan.fingerprint(),
            "pending": plan.pending()}


def test_git_fault_seam_traces_as_jax(tmp_path):
    ref, port = both(_git_fault_seam, tmp_path)
    assert port == ref
    assert port["ok"] == [False, False, True]
    assert port["trace"][:2] == [["git.clone", 0, "<raise:clone>"], ["git.clone", 1, "<raise:clone>"]]
    assert port["pending"] == {"git.rev-parse": 1}
