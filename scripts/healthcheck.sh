#!/usr/bin/env bash
# Operational healthcheck (role of the reference's scripts/healthcheck.sh:
# 7 checks incl. a functional gRPC probe). Exit 0 = healthy.
set -uo pipefail
TARGET="${1:-127.0.0.1:50051}"
METRICS="${2:-127.0.0.1:8080}"
fails=0

check() {
  local name="$1"; shift
  if "$@" >/dev/null 2>&1; then
    echo "ok   $name"
  else
    echo "FAIL $name"; fails=$((fails + 1))
  fi
}

# 1. process listening on the gRPC port
check "grpc port open" python - <<EOF
import socket, sys
host, port = "$TARGET".rsplit(":", 1)
s = socket.create_connection((host, int(port)), timeout=3); s.close()
EOF

# 2. grpc.health.v1 Check == SERVING
check "grpc health SERVING" python - <<EOF
import grpc
from cuda_acceleratedvectordatabaseengine.server.grpc_api import HealthClient
from cuda_acceleratedvectordatabaseengine.server.proto import health_pb2
ch = grpc.insecure_channel("$TARGET")
assert HealthClient(ch).Check(health_pb2.HealthCheckRequest(), timeout=5).status == 1
EOF

# 3. device usable — via the SERVER's exported device gauge, not a local
# probe: a second JAX process here would contend with the server for the
# card's memory. The server's health poller owns the device probe.
check "device usable (server gauge)" python - <<EOF
import urllib.request
text = urllib.request.urlopen("http://$METRICS/metrics", timeout=5).read()
assert b"vdb_gpu_memory_bytes" in text
EOF

# 4. metrics endpoint serving
check "metrics endpoint" python - <<EOF
import urllib.request
text = urllib.request.urlopen("http://$METRICS/metrics", timeout=5).read()
assert b"vdb_" in text or b"python_info" in text
EOF

# 5. HTTP /health endpoint healthy (reference README.md:133-136)
check "http /health healthy" python - <<EOF
import json, urllib.request
resp = urllib.request.urlopen("http://$METRICS/health", timeout=5)
assert resp.status == 200 and json.loads(resp.read())["status"] == "healthy"
EOF

# 6. functional search RPC error contract (INVALID_ARGUMENT on empty query)
check "search validation" python - <<EOF
import grpc
from cuda_acceleratedvectordatabaseengine.server.grpc_api import QueryServiceClient
from cuda_acceleratedvectordatabaseengine.server.proto import vdb_pb2
ch = grpc.insecure_channel("$TARGET")
try:
    QueryServiceClient(ch).Search(vdb_pb2.SearchRequest(topk=1, index="x"), timeout=5)
    raise SystemExit(1)
except grpc.RpcError as e:
    assert e.code() == grpc.StatusCode.INVALID_ARGUMENT
EOF

echo "---"
if [[ $fails -eq 0 ]]; then echo "HEALTHY"; exit 0; fi
echo "$fails check(s) failed"; exit 1
