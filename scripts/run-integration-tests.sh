#!/usr/bin/env bash
# Server-lifecycle integration harness (role of the reference's
# test/integration/run_integration_tests.sh): boot the real server against a
# throwaway data dir, poll readiness, run the operational healthcheck,
# exercise ingest→build→activate→search over the wire, optionally load-test,
# and always clean up.
set -uo pipefail
cd "$(dirname "$0")/.."

PORT="${PORT:-50251}"
MPORT="${MPORT:-18280}"
DATA="$(mktemp -d)"
LOG="${DATA}/server.log"
RUN_LOAD_TEST="${RUN_LOAD_TEST:-false}"

cleanup() {
  if [[ -n "${SRV_PID:-}" ]]; then kill "${SRV_PID}" 2>/dev/null; wait "${SRV_PID}" 2>/dev/null; fi
  rm -rf "${DATA}"
}
trap cleanup EXIT

echo "[it] starting server (data=${DATA})"
python -m cuda_acceleratedvectordatabaseengine.server.main \
    --address "127.0.0.1:${PORT}" --data-path "${DATA}/vdb" \
    --metrics-port "${MPORT}" > "${LOG}" 2>&1 &
SRV_PID=$!

echo "[it] waiting for readiness"
for i in $(seq 1 60); do
  if python - <<EOF 2>/dev/null
import socket; socket.create_connection(("127.0.0.1", ${PORT}), timeout=1).close()
EOF
  then break; fi
  kill -0 "${SRV_PID}" 2>/dev/null || { echo "[it] server died:"; tail -20 "${LOG}"; exit 1; }
  sleep 1
done

echo "[it] healthcheck"
bash scripts/healthcheck.sh "127.0.0.1:${PORT}" "127.0.0.1:${MPORT}" || exit 1

echo "[it] functional lifecycle over the wire"
python - <<EOF || exit 1
import time, grpc, numpy as np
from cuda_acceleratedvectordatabaseengine.server.grpc_api import (
    AdminServiceClient, QueryServiceClient)
from cuda_acceleratedvectordatabaseengine.server.proto import vdb_pb2
ch = grpc.insecure_channel("127.0.0.1:${PORT}")
grpc.channel_ready_future(ch).result(timeout=10)
admin, query = AdminServiceClient(ch), QueryServiceClient(ch)
rng = np.random.default_rng(0)
admin.CreateIndex(vdb_pb2.CreateIndexRequest(name="it", dimension=16, nlist=8))
admin.AddVectors(vdb_pb2.AddVectorsRequest(index="it",
    vectors=[vdb_pb2.Vector(id=i, values=rng.standard_normal(16)) for i in range(500)]))
admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="it"))
deadline = time.time() + 300  # tolerates cold compiles
while True:
    try:
        admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index="it")); break
    except grpc.RpcError:
        assert time.time() < deadline, "build timed out"; time.sleep(0.3)
r = query.Search(vdb_pb2.SearchRequest(
    queries=[vdb_pb2.Vector(values=rng.standard_normal(16))],
    topk=5, nprobe=8, index="it"))
assert len(r.results[0].neighbors) == 5
# deletion over the wire: the top hit for a stored vector is itself;
# remove it and it must never come back
probe = rng.standard_normal(16).astype(np.float32)
admin.AddVectors(vdb_pb2.AddVectorsRequest(index="it",
    vectors=[vdb_pb2.Vector(id=777777, values=probe)]))
r = query.Search(vdb_pb2.SearchRequest(
    queries=[vdb_pb2.Vector(values=probe)], topk=1, nprobe=8, index="it"))
assert r.results[0].neighbors[0].id == 777777
out = admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(index="it",
                                                       ids=[777777]))
assert out.removed == 1
r = query.Search(vdb_pb2.SearchRequest(
    queries=[vdb_pb2.Vector(values=probe)], topk=5, nprobe=8, index="it"))
assert all(n.id != 777777 for n in r.results[0].neighbors)
# bidirectional StreamSearch over the wire
reqs = [vdb_pb2.SearchRequest(
    queries=[vdb_pb2.Vector(values=rng.standard_normal(16))],
    topk=5, nprobe=8, index="it") for _ in range(6)]
resps = list(query.StreamSearch(iter(reqs)))
assert len(resps) == 6 and all(len(r.results[0].neighbors) == 5 for r in resps)
print("lifecycle OK (incl. RemoveVectors + StreamSearch)")
EOF

if [[ "${RUN_LOAD_TEST}" == "true" ]]; then
  echo "[it] load test"
  python -m cuda_acceleratedvectordatabaseengine.tools.load_test \
      --target "127.0.0.1:${PORT}" --index it --dimension 16 \
      --threads 4 --requests 25 --nprobe 8 || exit 1
fi

echo "[it] graceful shutdown"
kill -TERM "${SRV_PID}"
for i in $(seq 1 10); do
  kill -0 "${SRV_PID}" 2>/dev/null || break
  sleep 1
done
if kill -0 "${SRV_PID}" 2>/dev/null; then
  echo "[it] FAIL: server did not exit"; exit 1
fi
unset SRV_PID
echo "[it] ALL PASS"
