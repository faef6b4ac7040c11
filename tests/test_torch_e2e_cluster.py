"""The port's operator end to end against a REAL Kubernetes apiserver:
the counterpart of ``tests/test_e2e_cluster.py`` with the port's
``Operator`` and ``HttpKubeApi`` on the CPU (``device="cpu"``).

Opt-in: ``E2E_CLUSTER=1`` with a reachable cluster in KUBECONFIG —
normally launched by ``scripts/torch_e2e_kind.sh``, which creates a kind
cluster, applies ``deploy/crds`` + RBAC, and tears down afterwards.

What only a genuine apiserver can validate about the hand-rolled client
(operator/httpapi.py): merge-patch + status-subresource semantics against
the real CRD schema, watch line framing + bookmarks + resourceVersion
resume, and a failure detected from a REAL kubelet-written pod status (a
busybox container that exits 1), not a fixture.
"""

import asyncio
import os
import time
import uuid

import pytest

RUN = os.environ.get("E2E_CLUSTER") == "1"
pytestmark = pytest.mark.skipif(
    not RUN, reason="set E2E_CLUSTER=1 with a cluster in KUBECONFIG "
    "(scripts/torch_e2e_kind.sh)"
)


def test_port_operator_against_real_apiserver():
    from operator_tpu_torch.operator.app import Operator
    from operator_tpu_torch.operator.httpapi import HttpKubeApi
    from operator_tpu_torch.operator.storage import ANNOTATION_ANALYZED_AT
    from operator_tpu_torch.schema import (
        AIProvider, AIProviderRef, AIProviderSpec, LabelSelector, ObjectMeta,
        Podmortem, PodmortemSpec,
    )
    from operator_tpu_torch.utils.config import OperatorConfig

    api = HttpKubeApi.from_env()
    run_id = uuid.uuid4().hex[:8]
    ns = "podmortem-system"
    pod_ns = "default"
    pod_name = f"e2e-crash-{run_id}"

    async def main():
        config = OperatorConfig(
            pattern_cache_directory="/nonexistent", health_port=-1,
            completion_api_host="127.0.0.1", completion_api_port=0,
            model_id="tiny-test", allow_random_weights=True,
            max_batch_size=4, watch_namespaces=[pod_ns],
        )
        app = Operator(api, config=config, device="cpu")
        await app.start()
        try:
            await asyncio.wait_for(app.completion_task, timeout=900)
            assert app.completion_server is not None
            await api.create("AIProvider", AIProvider(
                metadata=ObjectMeta(name=f"e2e-prov-{run_id}", namespace=ns),
                spec=AIProviderSpec(provider_id="tpu-native",
                                    model_id="tiny-test", max_tokens=16),
            ).to_dict())
            await api.create("Podmortem", Podmortem(
                metadata=ObjectMeta(name=f"e2e-pm-{run_id}", namespace=ns),
                spec=PodmortemSpec(
                    pod_selector=LabelSelector(
                        match_labels={"e2e-run": run_id}
                    ),
                    ai_provider_ref=AIProviderRef(
                        name=f"e2e-prov-{run_id}", namespace=ns
                    ),
                ),
            ).to_dict())
            await asyncio.sleep(2)  # CR cache picks the new Podmortem up

            # a REAL crashing container: kubelet writes the terminated
            # status, the watch delivers it, nothing is faked
            await api.create("Pod", {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {
                    "name": pod_name, "namespace": pod_ns,
                    "labels": {"e2e-run": run_id},
                },
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": "crash", "image": "busybox:1.36",
                        "command": ["sh", "-c",
                                    "echo FATAL: e2e simulated crash; exit 1"],
                    }],
                },
            })

            deadline = time.monotonic() + 300
            annotations = {}
            while time.monotonic() < deadline:
                pod = await api.get("Pod", pod_name, pod_ns)
                annotations = (pod.get("metadata") or {}).get("annotations") or {}
                if ANNOTATION_ANALYZED_AT in annotations:
                    break
                await asyncio.sleep(3)
            assert ANNOTATION_ANALYZED_AT in annotations, (
                f"pod never analyzed; annotations={annotations}"
            )

            pm = await api.get("Podmortem", f"e2e-pm-{run_id}", ns)
            failures = (pm.get("status") or {}).get("recentFailures") or []
            assert any(f.get("podName") == pod_name for f in failures), failures

            events = await api.list("Event", pod_ns)
            ours = [
                e for e in events
                if (e.get("regarding") or {}).get("name") == pod_name
                and (e.get("reportingController") or "").startswith("podmortem")
            ]
            assert ours, "no podmortem events emitted for the crashed pod"
            print(f"\nE2E-CLUSTER-OK (port) pod={pod_name} "
                  f"events={len(ours)} failures={len(failures)}")
        finally:
            await app.stop()
            for kind, name, namespace in (
                ("Pod", pod_name, pod_ns),
                ("Podmortem", f"e2e-pm-{run_id}", ns),
                ("AIProvider", f"e2e-prov-{run_id}", ns),
            ):
                try:
                    await api.delete(kind, name, namespace)
                except Exception:
                    pass

    asyncio.run(main())
