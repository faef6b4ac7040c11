"""CRD YAML generation — the user-facing API surface of the system.

The port's own copy of ``operator_tpu/schema/crdgen.py``: host code, the same names and
behaviour.

Produces CustomResourceDefinition manifests for Podmortem / AIProvider /
PatternLibrary with the same structural schema the reference ships by hand
(reference podmortem-crd.yaml, aiprovider-crd.yaml, patternlibrary-crd.yaml),
generated from one source of truth so code and API can't drift.
"""

from __future__ import annotations

from typing import Any

import yaml

from .crds import GROUP, VERSION


def _obj(properties: dict[str, Any], required: list[str] | None = None) -> dict[str, Any]:
    out: dict[str, Any] = {"type": "object", "properties": properties}
    if required:
        out["required"] = required
    return out


def _arr(items: dict[str, Any]) -> dict[str, Any]:
    return {"type": "array", "items": items}


_STR = {"type": "string"}
_INT = {"type": "integer"}
_NUM = {"type": "number"}
_BOOL = {"type": "boolean"}
_STR_ARR = _arr(_STR)
_STR_MAP = {"type": "object", "additionalProperties": _STR}


_LABEL_SELECTOR = _obj(
    {
        "matchLabels": _STR_MAP,
        "matchExpressions": _arr(
            _obj(
                {
                    "key": _STR,
                    "operator": {
                        "type": "string",
                        "enum": ["In", "NotIn", "Exists", "DoesNotExist"],
                    },
                    "values": _STR_ARR,
                },
                required=["key", "operator"],
            )
        ),
    }
)

_POD_FAILURE_STATUS = _obj(
    {
        "podName": _STR,
        "podNamespace": _STR,
        "failureTime": _STR,
        "analysisStatus": _STR,
        "explanation": _STR,
        "severity": _STR,
        "deadlineOutcome": {
            "type": "string",
            "enum": [
                "completed", "truncated", "degraded", "shed",
                "deadline-exceeded",
            ],
        },
        # incident-memory classification (memory/): stable
        # failure fingerprint + fleet-wide recurrence accounting
        "recurrence": _obj(
            {
                "fingerprint": _STR,
                "seenCount": _INT,
                "firstSeen": _STR,
                "reusedAnalysis": _BOOL,
            }
        ),
        # flight-recorder trace id (obs/): GET /traces/{id}
        # on the operator health port replays this analysis's span tree
        "traceId": _STR,
    }
)


def podmortem_crd() -> dict[str, Any]:
    """Parity: reference podmortem-crd.yaml:1-92."""
    spec_schema = _obj(
        {
            "podSelector": _LABEL_SELECTOR,
            "aiProviderRef": _obj({"name": _STR, "namespace": _STR}),
            "aiAnalysisEnabled": {"type": "boolean", "default": True},
            # end-to-end analysis budget ("90s"/"2m"/"1h30m", or bare
            # seconds); unset = the operator's 180 s default (the
            # reference's LLM envelope).  Every compound term requires a
            # unit — exactly the grammar parse_refresh_interval accepts,
            # so a value the apiserver admits can never silently fall
            # back to the default
            "analysisDeadline": {"type": "string", "pattern": r"^\d+$|^(\s*\d+\s*[smhd])+\s*$"},
        }
    )
    status_schema = _obj(
        {
            "phase": {"type": "string", "enum": ["Pending", "Ready", "Processing", "Error"]},
            "message": _STR,
            "lastUpdateTime": _STR,
            "recentFailures": _arr(_POD_FAILURE_STATUS),
            "observedGeneration": _INT,
        }
    )
    return _crd("podmortems", "Podmortem", "pm", spec_schema, status_schema)


def aiprovider_crd() -> dict[str, Any]:
    """Parity: reference aiprovider-crd.yaml:1-86 (defaults :36-62)."""
    spec_schema = _obj(
        {
            "providerId": _STR,
            "apiUrl": _STR,
            "modelId": _STR,
            "authenticationRef": _obj({"secretName": _STR, "secretKey": _STR}),
            "timeoutSeconds": {"type": "integer", "default": 30},
            "maxRetries": {"type": "integer", "default": 3},
            "cachingEnabled": {"type": "boolean", "default": True},
            "promptTemplate": _STR,
            "maxTokens": {"type": "integer", "default": 500},
            "temperature": {"type": "number", "default": 0.3},
            "additionalConfig": _STR_MAP,
        }
        # NB: no required fields — matches the reference, which declares none
        # (aiprovider-crd.yaml:16-62); validation happens in the reconciler.
    )
    status_schema = _obj(
        {
            "phase": {"type": "string", "enum": ["Pending", "Ready", "Failed"]},
            "message": _STR,
            "lastValidated": _STR,
            "observedGeneration": _INT,
        }
    )
    return _crd("aiproviders", "AIProvider", "aip", spec_schema, status_schema)


def patternlibrary_crd() -> dict[str, Any]:
    """Parity: reference patternlibrary-crd.yaml:1-99."""
    spec_schema = _obj(
        {
            "repositories": _arr(
                _obj(
                    {
                        "name": _STR,
                        "url": _STR,
                        "branch": {"type": "string", "default": "main"},
                        "credentials": _obj(
                            {"secretRef": _obj({"name": _STR, "namespace": _STR, "key": _STR})}
                        ),
                    },
                    required=["name", "url"],
                )
            ),
            "refreshInterval": {"type": "string", "default": "1h"},
            "enabledLibraries": _STR_ARR,
        }
    )
    status_schema = _obj(
        {
            "phase": {"type": "string", "enum": ["Pending", "Syncing", "Ready", "Failed"]},
            "message": _STR,
            "lastSyncTime": _STR,
            "syncedRepositories": _arr(
                _obj(
                    {
                        "name": _STR,
                        "lastSyncTime": _STR,
                        "lastSyncCommit": _STR,
                        "status": _STR,
                        "message": _STR,
                        "patternCount": _INT,
                    }
                )
            ),
            "availableLibraries": _STR_ARR,
        }
    )
    return _crd("patternlibraries", "PatternLibrary", "pl", spec_schema, status_schema)


def _crd(
    plural: str,
    kind: str,
    short: str,
    spec_schema: dict[str, Any],
    status_schema: dict[str, Any],
) -> dict[str, Any]:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": kind,
                "listKind": f"{kind}List",
                "plural": plural,
                "singular": kind.lower(),
                "shortNames": [short],
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    # status subresource, as in all three reference CRDs
                    "subresources": {"status": {}},
                    "schema": {
                        "openAPIV3Schema": _obj(
                            {"spec": spec_schema, "status": status_schema}
                        )
                    },
                }
            ],
        },
    }


def all_crds() -> list[dict[str, Any]]:
    return [podmortem_crd(), aiprovider_crd(), patternlibrary_crd()]


class _NoAliasDumper(yaml.SafeDumper):
    """The schema builders share leaf dicts (e.g. ``_STR``); without this the
    emitter would render them as YAML anchors/aliases, which is unreadable in
    a CRD manifest."""

    def ignore_aliases(self, data):  # noqa: ANN001
        return True


def render_all() -> str:
    """Multi-document YAML of all three CRDs (for ``kubectl apply -f -``)."""
    return yaml.dump_all(all_crds(), Dumper=_NoAliasDumper, sort_keys=False)


def check_manifest(path: str) -> bool:
    """True when the committed manifest at ``path`` matches the generated
    output (modulo trailing whitespace) — the drift check graftlint rule
    GL005 runs in CI; exposed here so ``--check`` works in regen loops."""
    import pathlib

    committed = pathlib.Path(path)
    if not committed.exists():
        return False
    return committed.read_text(encoding="utf-8").strip() == render_all().strip()


if __name__ == "__main__":
    import sys

    if "--check" in sys.argv[1:]:
        import pathlib

        args = [a for a in sys.argv[1:] if a != "--check"]
        target = args[0] if args else "deploy/crds/podmortem-crds.yaml"
        if not pathlib.Path(target).exists():
            # a path error must not read as a drift diagnosis
            print(f"{target} not found (run from the repo root, or pass "
                  f"the manifest path)", file=sys.stderr)
            sys.exit(2)
        if check_manifest(target):
            print(f"{target} matches crdgen output")
            sys.exit(0)
        print(
            f"{target} drifted from crdgen output — regenerate with "
            f"`python -m operator_tpu_torch.schema.crdgen > {target}`",
            file=sys.stderr,
        )
        sys.exit(1)
    try:
        print(render_all())
    except BrokenPipeError:
        sys.stderr.close()
