"""Rule registry — one module per rule, imported here in catalogue order.

The JAX package's catalogue minus GL008 (Mosaic lowerability: the port's
kernels are CUDA C++, not Python kernel bodies).  The ids keep their JAX
meaning, so one pragma means the same thing to both linters."""

from __future__ import annotations

from ..core import Rule
from .gl001_host_sync import HostSyncInHotPath
from .gl002_tracer import TracerUnsafeControlFlow
from .gl003_deadline import DeadlinePropagation
from .gl004_locks import LockDiscipline
from .gl005_drift import GeneratedArtifactDrift
from .gl006_eventloop import EventLoopBlockingRule
from .gl007_replay import ReplayDeterminismRule
from .gl009_release import ResourceReleaseRule
from .gl010_config import ConfigDriftRule
from .gl011_await_atomicity import AwaitAtomicityRule
from .gl012_seam_coverage import ChaosSeamCoverage
from .gl013_mesh_axes import MeshAxisConsistency

ALL_RULES: list[Rule] = [
    HostSyncInHotPath(),
    TracerUnsafeControlFlow(),
    DeadlinePropagation(),
    LockDiscipline(),
    GeneratedArtifactDrift(),
    EventLoopBlockingRule(),
    ReplayDeterminismRule(),
    ResourceReleaseRule(),
    ConfigDriftRule(),
    AwaitAtomicityRule(),
    ChaosSeamCoverage(),
    MeshAxisConsistency(),
]


def rules_by_id(ids: list[str] | None = None) -> list[Rule]:
    if not ids:
        return list(ALL_RULES)
    table = {rule.id: rule for rule in ALL_RULES}
    missing = [i for i in ids if i not in table]
    if missing:
        raise KeyError(f"unknown rule id(s): {', '.join(missing)}")
    return [table[i] for i in ids]
