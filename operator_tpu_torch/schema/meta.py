"""Kubernetes object metadata + label-selector semantics.

Copy of ``operator_tpu/schema/meta.py``: ``ObjectMeta``, ``K8sObject``,
``now_iso`` and the full ``LabelSelector`` (``matchLabels`` and
``matchExpressions``).
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


@dataclass
class LabelSelectorRequirement:
    """One matchExpressions entry (podmortem-crd.yaml:29-39)."""

    key: Optional[str] = None
    operator: Optional[str] = None  # In | NotIn | Exists | DoesNotExist
    values: list[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: dict[str, str] = field(default_factory=dict)
    match_expressions: list[LabelSelectorRequirement] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.match_labels and not self.match_expressions

    def matches(self, labels: Optional[dict[str, str]]) -> bool:
        """Kubernetes label-selector semantics.

        An empty selector matches everything (the reference treats this the
        same way: PodFailureWatcher.java:251-254).
        """
        labels = labels or {}
        for key, want in self.match_labels.items():
            if labels.get(key) != want:
                return False
        for req in self.match_expressions:
            have = req.key in labels
            value = labels.get(req.key)
            op = (req.operator or "").lower()
            if op == "in":
                if value not in (req.values or []):
                    return False
            elif op == "notin":
                if have and value in (req.values or []):
                    return False
            elif op == "exists":
                if not have:
                    return False
            elif op == "doesnotexist":
                if have:
                    return False
            else:  # unknown operator: fail closed
                return False
        return True


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
