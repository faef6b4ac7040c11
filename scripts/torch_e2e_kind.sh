#!/bin/bash
# One-command end-to-end run of the PyTorch port's operator
# (operator_tpu_torch) against a REAL Kubernetes apiserver, as
# scripts/e2e_kind.sh runs the JAX package's: the port's operator tests run
# against the in-repo fake (operator/kubeapi.py) or the stub apiserver
# (operator/kubefacade.py); this validates the port's HTTP client —
# merge-patch semantics, watch line framing + resourceVersion resume,
# status subresource writes, RBAC and CRD schema correctness — against a
# real one.  The operator runs on the CPU, out of cluster.
#
# Requires: kind (or an existing cluster via KUBECONFIG + E2E_SKIP_KIND=1),
# kubectl, and network to pull the busybox image for the crashing pod.
# Not runnable in the offline build image — run it on a workstation/CI:
#
#   bash scripts/torch_e2e_kind.sh            # create kind cluster, test, delete
#   E2E_KEEP=1 bash scripts/torch_e2e_kind.sh # keep the cluster for inspection
#   E2E_SKIP_KIND=1 KUBECONFIG=... bash scripts/torch_e2e_kind.sh  # your cluster
set -euo pipefail
cd "$(dirname "$0")/.."

CLUSTER=${E2E_CLUSTER_NAME:-podmortem-torch-e2e}

if [ "${E2E_SKIP_KIND:-0}" != "1" ]; then
  command -v kind >/dev/null || { echo "kind not found (https://kind.sigs.k8s.io)"; exit 2; }
  kind create cluster --name "$CLUSTER" --wait 120s
  trap '[ "${E2E_KEEP:-0}" = "1" ] || kind delete cluster --name "$CLUSTER"' EXIT
  kind export kubeconfig --name "$CLUSTER"
fi
command -v kubectl >/dev/null || { echo "kubectl not found"; exit 2; }

# the operator's own API surface: CRDs + namespace + RBAC, exactly what a
# production install applies (deploy/); the operator process itself runs
# OUT of cluster against the kubeconfig, so the Deployment is not applied
kubectl apply -f deploy/crds/podmortem-crds.yaml
kubectl create namespace podmortem-system --dry-run=client -o yaml | kubectl apply -f -
kubectl apply -f deploy/operator-serviceaccount.yaml -n podmortem-system
kubectl apply -f deploy/operator-rbac.yaml
for crd in podmortems aiproviders patternlibraries; do
  kubectl wait --for condition=established "crd/${crd}.podmortem.tpu.dev" --timeout=60s
done

E2E_CLUSTER=1 python -m pytest tests/test_torch_e2e_cluster.py -x -q -s
