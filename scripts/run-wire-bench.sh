#!/usr/bin/env bash
# Wire-level latency + throughput benchmark against the live server.
#
# Phases (one JAX process per GPU: a JAX process reserves most of the
# card's memory, so only the server opens the card):
#   1. wire_bench.py prepare  — build index + server data dir, exit
#   2. server boot            — recovers the active epoch, warms all buckets
#   3. tools.load_test        — latency ladder then stream-throughput ladder;
#                               the client runs with JAX_PLATFORMS=cpu so it
#                               never opens the card
#   4. wire_bench.py report   — merge into WIRE.json (under $OUT)
#
# Usage: bash scripts/run-wire-bench.sh [N]
set -uo pipefail
cd "$(dirname "$0")/.."

N="${1:-1000000}"
PORT="${PORT:-50351}"
MPORT="${MPORT:-18380}"
DATA="${DATA:-$(mktemp -d)}"
OUT="${OUT:-/tmp/wirebench}"
mkdir -p "${OUT}"
LOG="${OUT}/server.log"

cleanup() {
  if [[ -n "${SRV_PID:-}" ]]; then
    kill "${SRV_PID}" 2>/dev/null; wait "${SRV_PID}" 2>/dev/null
  fi
}
trap cleanup EXIT

echo "[wire] phase 1: prepare (data=${DATA})"
if [[ -f "${DATA}/epochs/epochs.json" ]]; then
  echo "[wire] reusing existing epoch snapshot in ${DATA}"
else
  python scripts/wire_bench.py prepare --data-path "${DATA}" --n "${N}" \
    || exit 1
fi

echo "[wire] phase 2: server boot"
# Throughput-mode config: device batches up to 2048 QUERIES (the coalescer
# bounds drained batches by query weight, so every batch lands on a warmed
# bucket), bf16 query upload (halves the host-to-device query bytes),
# pipelined dispatch/finalize overlap. default_nprobe pinned to the
# bench's serving point so warmup compiles exactly the traffic shapes.
cat > "${OUT}/server.yaml" <<EOF
grpc_workers: 64
max_batch_size: 2048
stream_window: 16
max_concurrent_requests: 1024
max_queued_requests: 4096
coalesce_window_ms: 1.0
query_upload_dtype: bfloat16
default_nprobe: 32
warm_nprobes: [32]
EOF
python -m cuda_acceleratedvectordatabaseengine.server.main \
    --config "${OUT}/server.yaml" \
    --address "127.0.0.1:${PORT}" --data-path "${DATA}" \
    --metrics-port "${MPORT}" \
    > "${LOG}" 2>&1 &
SRV_PID=$!

# Readiness: wait for the warmed index to serve a real search (bucket warmup
# on recovery compiles every batch bucket).
echo "[wire] waiting for warmed readiness"
for i in $(seq 1 900); do
  if JAX_PLATFORMS=cpu python - "$PORT" <<'EOF' 2>/dev/null
import sys, grpc, numpy as np
from cuda_acceleratedvectordatabaseengine.server.grpc_api import QueryServiceClient
from cuda_acceleratedvectordatabaseengine.server.proto import vdb_pb2
ch = grpc.insecure_channel(f"127.0.0.1:{sys.argv[1]}")
grpc.channel_ready_future(ch).result(timeout=2)
q = [vdb_pb2.Vector(values=np.zeros(768).astype(float))]
QueryServiceClient(ch).Search(vdb_pb2.SearchRequest(
    queries=q, topk=10, nprobe=32, index="default"), timeout=15)
EOF
  then READY=1; break; fi
  kill -0 "${SRV_PID}" 2>/dev/null || { echo "[wire] server died:"; tail -30 "${LOG}"; exit 1; }
  sleep 2
done
[[ -n "${READY:-}" ]] || { echo "[wire] never became ready"; tail -30 "${LOG}"; exit 1; }

echo "[wire] phase 3: load tests"
FAILED=""
run_load() {  # name threads requests nprobe batch [extra-flags]
  JAX_PLATFORMS=cpu python -m cuda_acceleratedvectordatabaseengine.tools.load_test \
    --target "127.0.0.1:${PORT}" --index default --dimension 768 \
    --threads "$2" --requests "$3" --topk 10 --nprobe "$4" --batch "$5" \
    --metrics-url "http://127.0.0.1:${MPORT}/metrics" \
    ${6:-} > "${OUT}/$1.json" \
    || { echo "[wire] scenario $1 FAILED (recorded, continuing)"; FAILED="${FAILED} $1"; }
  echo "[wire] $1:"; cat "${OUT}/$1.json" 2>/dev/null || true
}
run_load warm 8 50 32 1                  # post-boot warm pass (not reported)
# --- latency ladder: the packed/unpacked same-shape pair runs TWICE,
#     alternating (…_a early, …_b late), so a time-correlated stall shows
#     at shared wall offsets across formats while a code-path cost shows
#     only in one format. ---
run_load b1_seq 1 200 32 1 --packed
run_load t16_np32_a 16 200 32 1
run_load t16_np32_packed_a 16 200 32 1 --packed
run_load t16_np32_b 16 200 32 1
run_load t16_np32_packed_b 16 200 32 1 --packed
run_load b64_unpacked 16 100 32 64
run_load b64_packed 16 200 32 64 --packed
# --- throughput ladder (the reference's 10K rps design point,
#     query_service.h:172-173): streams pipeline multi-query requests
#     through the weight-bounded coalescer into 2048-query device batches ---
run_load s16_b64_packed_stream 16 200 32 64 "--packed --stream"
run_load s32_b32_packed_stream 32 200 32 32 "--packed --stream"

echo "[wire] phase 3b: capture final stage decomposition"
curl -s "http://${MPORT_HOST:-127.0.0.1}:${MPORT}/metrics" > "${OUT}/stages.txt" || true

echo "[wire] phase 4: report"
RUNS=""
for f in b1_seq t16_np32_a t16_np32_packed_a t16_np32_b t16_np32_packed_b \
         b64_unpacked b64_packed \
         s16_b64_packed_stream s32_b32_packed_stream; do
  [[ -s "${OUT}/$f.json" ]] && RUNS="${RUNS} --run ${OUT}/$f.json"
done
JAX_PLATFORMS=cpu python scripts/wire_bench.py report ${RUNS} \
  --stages "${OUT}/stages.txt" \
  --output "${OUT}/WIRE.json" || exit 1
[[ -n "${FAILED}" ]] && echo "[wire] NOTE: failed scenarios:${FAILED}"
echo "[wire] done -> ${OUT}/WIRE.json"
