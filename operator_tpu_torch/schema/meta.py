"""Kubernetes object metadata.

Copy of ``operator_tpu/schema/meta.py`` as far as the analysis path needs
it (``ObjectMeta``, ``K8sObject``, ``now_iso``); the label selector comes
with the CRDs.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Any, Optional

from .serde import from_dict, to_dict


def now_iso() -> str:
    """RFC3339 UTC timestamp, the Kubernetes wire format for times."""
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds")
        .replace("+00:00", "Z")
    )


@dataclass
class OwnerReference:
    api_version: Optional[str] = None
    kind: Optional[str] = None
    name: Optional[str] = None
    uid: Optional[str] = None
    controller: Optional[bool] = None


@dataclass
class ObjectMeta:
    name: Optional[str] = None
    namespace: Optional[str] = None
    uid: Optional[str] = None
    resource_version: Optional[str] = None
    generation: Optional[int] = None
    creation_timestamp: Optional[str] = None
    deletion_timestamp: Optional[str] = None
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner_references: list[OwnerReference] = field(default_factory=list)


@dataclass
class K8sObject:
    """Base for anything with apiVersion/kind/metadata."""

    api_version: Optional[str] = None
    kind: Optional[str] = None
    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    def __post_init__(self) -> None:
        if self.metadata is None:
            self.metadata = ObjectMeta()

    # --- identity helpers -------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        return self.metadata.name

    @property
    def namespace(self) -> Optional[str]:
        return self.metadata.namespace

    def qualified_name(self) -> str:
        return f"{self.metadata.namespace or '_'}/{self.metadata.name}"

    # --- serde ------------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return to_dict(self)

    @classmethod
    def parse(cls, data: dict[str, Any]):
        return from_dict(cls, data)
