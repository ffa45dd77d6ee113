#!/usr/bin/env bash
# Deploy to a GKE cluster with an NVIDIA H100 node pool (counterpart of the
# reference's scripts/deploy-gcp.sh GPU flow).
set -euo pipefail
PROJECT="${PROJECT:?set PROJECT}"
CLUSTER="${CLUSTER:-vdb-gpu}"
ZONE="${ZONE:-us-central1-a}"
IMAGE="gcr.io/${PROJECT}/vdb-gpu:latest"

echo "[deploy] building image ${IMAGE}"
docker build -t "${IMAGE}" .
docker push "${IMAGE}"

echo "[deploy] ensuring GPU node pool"
gcloud container node-pools describe h100 --cluster "${CLUSTER}" \
    --zone "${ZONE}" --project "${PROJECT}" >/dev/null 2>&1 || \
gcloud container node-pools create h100 \
    --cluster "${CLUSTER}" --zone "${ZONE}" --project "${PROJECT}" \
    --machine-type a3-highgpu-1g \
    --accelerator type=nvidia-h100-80gb,count=1,gpu-driver-version=latest \
    --num-nodes 2

echo "[deploy] applying manifests"
kubectl apply -f k8s/namespace.yaml
kubectl apply -f k8s/rbac.yaml
kubectl apply -f k8s/configmap.yaml
kubectl apply -f k8s/persistent-volume.yaml
kubectl set image -f k8s/deployment.yaml vdb-server="${IMAGE}" --local -o yaml | kubectl apply -f -
kubectl apply -f k8s/service.yaml
kubectl apply -f k8s/hpa.yaml
kubectl apply -f k8s/servicemonitor.yaml || true   # needs prometheus-operator
kubectl -n vdb rollout status deployment/vdb-server --timeout=600s
echo "[deploy] done"
