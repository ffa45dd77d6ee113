# Multi-stage image for the vector DB server on NVIDIA GPUs.
# Counterpart of the reference's CUDA image (Dockerfile:3-133): builder
# stage compiles the native host runtime; the runtime stage is a slim
# Python image with the CUDA-enabled JAX stack (CUDA libraries come as pip
# wheels; the host needs only the NVIDIA driver). Runs as non-root with a
# gRPC-health healthcheck, as the reference does (Dockerfile:108-127).

FROM python:3.12-slim AS builder
RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make protobuf-compiler && rm -rf /var/lib/apt/lists/*
WORKDIR /build
COPY pyproject.toml ./
COPY cuda_acceleratedvectordatabaseengine ./cuda_acceleratedvectordatabaseengine
# native host runtime (libvdbhost.so) + generated protos
RUN make -C cuda_acceleratedvectordatabaseengine/native \
    && bash cuda_acceleratedvectordatabaseengine/server/proto/regen.sh \
    && pip install --no-cache-dir build && python -m build --wheel

FROM python:3.12-slim AS runtime
RUN apt-get update && apt-get install -y --no-install-recommends \
        libgomp1 && rm -rf /var/lib/apt/lists/* \
    && useradd --create-home --uid 10001 vdb
# GPU runtime: jax[cuda12] pulls the CUDA 12 libraries and JAX's CUDA
# plugin (XLA and the Pallas Triton kernels); grpcio/pyarrow/prometheus for
# serving.
RUN pip install --no-cache-dir "jax[cuda12]" \
        grpcio protobuf pyarrow prometheus-client pyyaml numpy
COPY --from=builder /build/dist/*.whl /tmp/
RUN pip install --no-cache-dir /tmp/*.whl && rm /tmp/*.whl

USER vdb
ENV VDB_DATA_PATH=/data/vdb
EXPOSE 50051 8080
# Liveness: the standard grpc.health.v1 protocol this server implements —
# probeable with grpc_health_probe or the bundled client.
HEALTHCHECK --interval=30s --timeout=10s --start-period=60s \
  CMD python -c "import grpc; \
from cuda_acceleratedvectordatabaseengine.server.grpc_api import HealthClient; \
from cuda_acceleratedvectordatabaseengine.server.proto import health_pb2; \
ch = grpc.insecure_channel('127.0.0.1:50051'); \
assert HealthClient(ch).Check(health_pb2.HealthCheckRequest(), timeout=5).status == 1"

ENTRYPOINT ["vdb-server"]
CMD ["--address", "0.0.0.0:50051", "--data-path", "/data/vdb"]
