#!/usr/bin/env bash
# Build everything: native host runtime, protos, wheel, (optional) image.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "[build] native host runtime"
make -C cuda_acceleratedvectordatabaseengine/native

echo "[build] protobuf codegen"
bash cuda_acceleratedvectordatabaseengine/server/proto/regen.sh

if [[ "${1:-}" == "--wheel" ]]; then
  echo "[build] wheel"
  python -m build --wheel
fi
if [[ "${1:-}" == "--image" ]]; then
  echo "[build] docker image"
  docker build -t vdb-gpu:latest .
fi
echo "[build] done"
