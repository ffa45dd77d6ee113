"""Server configuration: one real system (dataclass ← YAML ← CLI).

The reference has two disconnected layers — 5 hand-parsed argv flags
(``server/main.cpp:134-176``) and a rich ``configs/production.yaml`` that no
code ever reads (SURVEY.md §5). Here the same schema is actually parsed and
drives the server; CLI flags override YAML.
"""

from __future__ import annotations

import dataclasses

import yaml


@dataclasses.dataclass
class ServerConfig:
    # server (reference flags, main.cpp:134-176)
    address: str = "0.0.0.0:50051"
    data_path: str = "/data/vdb"
    max_batch_size: int = 64
    coalesce_window_ms: float = 2.0
    # StreamSearch: max requests pipelined into the coalescer per stream
    # before responses are awaited (in-order delivery; bounds per-stream
    # admission-slot hold).
    stream_window: int = 8
    max_message_mb: int = 100
    grpc_workers: int = 16

    # device
    device_memory_limit_gb: float = 0.0     # 0 = no explicit cap
    arena_dtype: str = "bfloat16"
    # H2D transport dtype for search-query batches ("float32" |
    # "bfloat16"). bf16 halves the per-batch query upload, and the device
    # program widens back to fp32 before the coarse matmul (only the query
    # mantissa rounds). Applied to every index at epoch activation, before
    # warmup.
    query_upload_dtype: str = "float32"
    # HBM budget for a streaming-tier index's list cache (0 = auto:
    # ~nlist/4 slots). Tier is chosen per index at CreateIndex.
    streaming_cache_bytes: int = 0
    # Eviction policy for that cache. lfu (default) pins the hot working
    # set when it exceeds the slot count; lru degenerates to ~0% hits on
    # cyclic wave scans over a too-large working set.
    streaming_cache_policy: str = "lfu"
    # PQ capacity tier (tier: pq_capacity): device-side ADC shortlist depth
    # fed to the host-store exact reranker on rerank_exact searches.
    pq_rerank_k: int = 128
    # Adaptive rerank depth: candidates beyond (1+margin)x the query's
    # k-th ADC distance skip the host gather+dot (0 = fixed depth). Easy
    # queries then cost a fraction of pq_rerank_k on the host stage.
    pq_rerank_margin: float = 0.0

    # Multi-chip serving (SURVEY §2.9). The reference *claims* multi-GPU
    # (configs/production.yaml:11 ``enable_multi_gpu: true``) but no code
    # reads the flag; here epoch activation loads resident and streaming
    # indices into the sharded SPMD views (``parallel/``) and the
    # coalescer dispatches one mesh-wide search per batch.
    #   auto — shard when more than one device is visible (default)
    #   on   — always build a mesh (1-device mesh allowed, for tests)
    #   off  — single-chip serving regardless of topology
    shard_serving: str = "auto"
    mesh_shards: int = 0        # 0 = all visible devices
    # jax.profiler trace server for op-level device inspection (the
    # reference's dormant Jaeger tracing block,
    # configs/production.yaml:49-51). 0 = disabled.
    profile_port: int = 0

    # rate limiting (configs/production.yaml:32-33)
    rate_limit_rps: float = 10000.0
    rate_limit_burst: int = 200

    # circuit breaker (load_balancer.cpp:193-268)
    breaker_error_threshold: float = 0.5
    breaker_open_seconds: float = 30.0
    breaker_decay: float = 0.95
    max_concurrent_requests: int = 256
    # Fail-fast bound on the per-index coalescer backlog (0 = unbounded):
    # submissions past this are shed with RESOURCE_EXHAUSTED instead of
    # queueing work that will outlive its adaptive deadline.
    max_queued_requests: int = 1024

    # metrics
    metrics_port: int = 8080
    metrics_enabled: bool = True

    # security — the reference DECLARES these knobs and wires none of them
    # (configs/production.yaml:84-91 `enable_tls`/`enable_auth` are read by
    # no code). Here they are real: TLS terminates in grpc's server
    # credentials; auth is a static bearer token checked by a server
    # interceptor on every vdb.* RPC (health stays open for k8s probes).
    enable_tls: bool = False
    tls_cert_file: str = ""          # PEM server certificate chain
    tls_key_file: str = ""           # PEM private key
    tls_ca_file: str = ""            # set → mutual TLS (client certs
                                     # verified against this CA)
    # Non-empty → require `authorization: Bearer <token>` metadata.
    # "$VAR" reads the token from the environment at startup (keeps
    # secrets out of YAML/k8s ConfigMaps; pair with a Secret-env).
    auth_token: str = ""

    # Hotness-driven residency (the declared GpuCache/ListPrefetcher
    # semantics, engine/prefetcher.h:139-230): every this-many seconds the
    # server re-stages each streaming-tier index's decayed-hot lists into
    # its HBM cache through the throttled PrefetchScheduler, so a hot
    # working set evicted by cold traffic is resident again before the
    # next hot query. 0 = disabled.
    prefetch_hot_interval_s: float = 5.0
    # P4 byte-rate throttle for background staging (reference default
    # 10 GB/s, engine/prefetcher.h:185-230).
    prefetch_bandwidth_bps: float = 10e9

    # Chunked epoch builds: rows streamed off the source file per chunk
    # (peak host RAM ≈ one chunk; same chunk size the headline bench
    # build uses). BuildEpoch never concatenates the corpus in RAM.
    build_chunk_rows: int = 500_000

    # index defaults (configs/production.yaml + README tuning table)
    default_nlist: int = 1024
    default_nprobe: int = 8                  # reference Search default
    # Opt-in: calibrate nprobe from measured probe coverage at every
    # epoch build and persist it in the manifest (vdb-tune's measurement,
    # run automatically). Requests with nprobe unset then serve at the
    # tuned point instead of default_nprobe.
    auto_calibrate_nprobe: bool = False
    keep_epochs: int = 3
    # Serving operating points warmed at activation. nprobe is
    # SHAPE-STATIC in the jitted search: an nprobe that warmup skipped
    # pays a multi-second cold compile on its first request (the server
    # p99 outlier of rounds 1-2). default_nprobe is always included.
    warm_nprobes: tuple = (32,)

    @classmethod
    def from_yaml(cls, path: str) -> "ServerConfig":
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        # Accept both flat keys and the reference's nested production.yaml
        # style ({server: {...}, batching: {...}, ...}).
        flat: dict = {}
        for key, val in raw.items():
            if isinstance(val, dict):
                flat.update(val)
            else:
                flat[key] = val
        known = {f.name for f in dataclasses.fields(cls)}
        aliases = {
            "listen_address": "address",
            "window_ms": "coalesce_window_ms",
            "requests_per_second": "rate_limit_rps",
            "burst": "rate_limit_burst",
            "error_threshold": "breaker_error_threshold",
            "port": "metrics_port",
            "nlist": "default_nlist",
            "nprobe": "default_nprobe",
            # the reference's security block key names
            # (configs/production.yaml:84-91)
            "cert_file": "tls_cert_file",
            "key_file": "tls_key_file",
            "ca_file": "tls_ca_file",
        }
        kwargs = {}
        for k, v in flat.items():
            k = aliases.get(k, k)
            if k in known:
                kwargs[k] = v
        # The reference's multi-GPU bool maps onto the mesh mode (an
        # explicit shard_serving key wins over the legacy alias).
        if "enable_multi_gpu" in flat and "shard_serving" not in kwargs:
            kwargs["shard_serving"] = (
                "auto" if flat["enable_multi_gpu"] else "off"
            )
        # The reference's `enable_auth` flag is accepted, but never as a
        # dead knob: enabling it without a token is a config error.
        if flat.get("enable_auth") and not kwargs.get("auth_token"):
            raise ValueError(
                "enable_auth: true requires auth_token "
                "(use auth_token: \"$VDB_AUTH_TOKEN\" to read it from "
                "the environment)"
            )
        return cls(**kwargs)

    def resolved_auth_token(self) -> str:
        """The bearer token with `$VAR` indirection resolved (empty =
        auth disabled). A $VAR that is unset is a startup error, not a
        silently-open server."""
        tok = self.auth_token
        if tok.startswith("$"):
            import os

            val = os.environ.get(tok[1:], "")
            if not val:
                raise ValueError(
                    f"auth_token references unset environment "
                    f"variable {tok[1:]}"
                )
            return val
        return tok

    def apply_overrides(self, **kv) -> "ServerConfig":
        updates = {k: v for k, v in kv.items() if v is not None}
        return dataclasses.replace(self, **updates)
