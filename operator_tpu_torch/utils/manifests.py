"""The port's deployment, read in Python: a kustomize overlay rendered
with its strategic-merge patches, and a Dockerfile's stages.

:func:`render` builds what ``kustomize build <dir>`` builds for the
subset the repo's overlays use: ``resources`` (files, and directories
holding their own ``kustomization.yaml``, recursively), ``namespace``,
and ``patches`` / ``patchesStrategicMerge`` of strategic-merge
documents, each applied to the object its ``target`` (else its own
``kind`` and ``metadata.name``) names.  The merge follows Kubernetes'
strategic-merge rules for what these manifests hold:

- maps merge key by key, and a null value deletes the key;
- the lists Kubernetes gives a merge key (``containers`` and ``env`` by
  ``name``, ``volumeMounts`` by ``mountPath``, ``ports`` by
  ``containerPort``, ...) merge element by element, an element of the
  patch with ``$patch: delete`` deletes its match, and a new element is
  appended;
- every other list (``command``, ``tolerations``, ...) is replaced
  whole.

:func:`read_dockerfile` splits a Dockerfile into its stages
(:class:`DockerStage`: base, name, ``ENV``, ``RUN``, ``COPY``,
``WORKDIR``, ``USER``, ``ENTRYPOINT``), so a test or a drive can read
what an image holds and runs without building it.
"""

from __future__ import annotations

import copy
import json
import os
import shlex
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

__all__ = [
    "DockerStage", "container", "deployment", "merge", "read_dockerfile", "render",
]

#: list field -> the key its elements merge on (Kubernetes' patchMergeKey)
MERGE_KEYS = {
    "containers": "name",
    "initContainers": "name",
    "env": "name",
    "volumes": "name",
    "volumeMounts": "mountPath",
    "ports": "containerPort",
    "imagePullSecrets": "name",
}


def merge(base: Any, patch: Any, key: Optional[str] = None) -> Any:
    """``patch`` applied to ``base`` as a strategic merge (a new object;
    neither argument changes).  ``key`` is the field both sit under."""
    if isinstance(base, dict) and isinstance(patch, dict):
        out = copy.deepcopy(base)
        for name, value in patch.items():
            if value is None:
                out.pop(name, None)
            elif name in out:
                out[name] = merge(out[name], value, name)
            else:
                out[name] = _without_directives(value)
        return out
    if isinstance(base, list) and isinstance(patch, list) and key in MERGE_KEYS:
        return _merge_list(base, patch, MERGE_KEYS[key])
    return _without_directives(patch)


def _merge_list(base: list, patch: list, on: str) -> list:
    out = copy.deepcopy(base)
    for element in patch:
        at = next((i for i, item in enumerate(out) if item.get(on) == element.get(on)), None)
        if element.get("$patch") == "delete":
            if at is not None:
                del out[at]
        elif at is None:
            out.append(_without_directives(element))
        else:
            out[at] = merge(out[at], element)
    return out


def _without_directives(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _without_directives(v) for k, v in value.items()
                if k != "$patch" and v is not None}
    if isinstance(value, list):
        return [_without_directives(v) for v in value]
    return copy.deepcopy(value)


def _documents(path: str) -> list:
    with open(path, encoding="utf-8") as fh:
        return [doc for doc in yaml.safe_load_all(fh) if doc]


def render(directory: str) -> list:
    """Every object ``kustomize build directory`` would print, in
    resource order."""
    with open(os.path.join(directory, "kustomization.yaml"), encoding="utf-8") as fh:
        kustomization = yaml.safe_load(fh)
    objects: list = []
    for resource in kustomization.get("resources") or []:
        path = os.path.normpath(os.path.join(directory, resource))
        if os.path.isdir(path):
            objects.extend(render(path))
        else:
            objects.extend(_documents(path))
    patches = [{"path": p} for p in kustomization.get("patchesStrategicMerge") or []]
    patches += kustomization.get("patches") or []
    for entry in patches:
        for doc in _documents(os.path.join(directory, entry["path"])):
            target = entry.get("target") or {}
            kind = target.get("kind") or doc.get("kind")
            name = target.get("name") or (doc.get("metadata") or {}).get("name")
            matched = [i for i, obj in enumerate(objects)
                       if obj.get("kind") == kind and obj["metadata"].get("name") == name]
            if not matched:
                raise ValueError(f"{entry['path']}: no {kind} {name!r} to patch in {directory}")
            for i in matched:
                objects[i] = merge(objects[i], doc)
    namespace = kustomization.get("namespace")
    if namespace:
        for obj in objects:
            if obj.get("kind") not in _CLUSTER_SCOPED:
                obj["metadata"]["namespace"] = namespace
    return objects


_CLUSTER_SCOPED = {"CustomResourceDefinition", "ClusterRole", "ClusterRoleBinding", "Namespace"}


def deployment(objects: list, name: str) -> dict:
    """The rendered Deployment called ``name``."""
    found = [o for o in objects if o.get("kind") == "Deployment" and o["metadata"]["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{len(found)} Deployments named {name!r}")
    return found[0]


def container(obj: dict) -> dict:
    """A Deployment's one container."""
    containers = obj["spec"]["template"]["spec"]["containers"]
    if len(containers) != 1:
        raise KeyError(f"{len(containers)} containers in {obj['metadata']['name']}")
    return containers[0]


# ---------------------------------------------------------------------------
# Dockerfiles
# ---------------------------------------------------------------------------


@dataclass
class DockerStage:
    """One ``FROM`` stage: its instructions in order, as ``(INSTRUCTION,
    argument text)``."""

    base: str
    name: Optional[str]
    instructions: list = field(default_factory=list)

    def arguments(self, instruction: str) -> list:
        return [text for op, text in self.instructions if op == instruction]

    @property
    def env(self) -> dict:
        """``ENV`` settings in order (``K=V ...`` or the legacy ``K V``)."""
        out: dict = {}
        for text in self.arguments("ENV"):
            words = shlex.split(text)
            if words and "=" not in words[0]:
                out[words[0]] = " ".join(words[1:])
                continue
            for word in words:
                name, _, value = word.partition("=")
                out[name] = value
        return out

    @property
    def runs(self) -> list:
        return self.arguments("RUN")

    @property
    def copies(self) -> list:
        """``COPY`` as ``(sources, destination, from stage or None)``."""
        out = []
        for text in self.arguments("COPY"):
            words = shlex.split(text)
            origin = next((w.split("=", 1)[1] for w in words if w.startswith("--from=")), None)
            paths = [w for w in words if not w.startswith("--")]
            out.append((paths[:-1], paths[-1], origin))
        return out

    @property
    def workdir(self) -> Optional[str]:
        found = self.arguments("WORKDIR")
        return found[-1] if found else None

    @property
    def user(self) -> Optional[str]:
        found = self.arguments("USER")
        return found[-1] if found else None

    @property
    def entrypoint(self) -> Optional[list]:
        found = self.arguments("ENTRYPOINT")
        return json.loads(found[-1]) if found else None


def read_dockerfile(path: str) -> list:
    """The stages of the Dockerfile at ``path``, in order (comments
    dropped, continued lines joined)."""
    with open(path, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    logical, pending = [], ""
    for line in lines:
        stripped = line.strip()
        if not pending and (not stripped or stripped.startswith("#")):
            continue
        if pending and stripped.startswith("#"):
            continue  # a comment inside a continued instruction
        if stripped.endswith("\\"):
            pending += stripped[:-1].rstrip() + " "
            continue
        logical.append(pending + stripped)
        pending = ""
    if pending:
        logical.append(pending.strip())
    stages: list = []
    for line in logical:
        op, _, text = line.partition(" ")
        op, text = op.upper(), text.strip()
        if op == "FROM":
            words = text.split()
            name = words[2] if len(words) >= 3 and words[1].upper() == "AS" else None
            stages.append(DockerStage(base=words[0], name=name))
        elif not stages:
            raise ValueError(f"{path}: {op} before the first FROM")
        else:
            stages[-1].instructions.append((op, text))
    return stages
