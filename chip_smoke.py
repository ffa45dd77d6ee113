#!/usr/bin/env python3
"""End-to-end check that the vector database runs on one NVIDIA GPU.

Run from the repository root::

    python chip_smoke.py [--seed N]      # one card: kernel, main, served
    python chip_smoke.py --mesh4         # four cards: the sharded path only

Every phase prints one JSON object with its wall time:

``kernel``
    The list-grouped Triton scan kernel (``ops/grouped_scan``), compiled for
    the card, against the plain XLA reference scan (``ops/scan``, run at
    ``Precision.HIGHEST``) on 768-D int8 lists with per-row scales and
    residual anchors, 2,560 slots, partly filled tiles; nprobe 4 and 32,
    k 10, L2 and inner product. Then the shapes outside the kernel's native
    tiling, each still on the kernel: k 100 (two top-k passes; a rerank
    shortlist), 100-D lists (GloVe-100; masked last feature chunk) and
    12-slot lists (masked sub-tile capacity).
``main``
    The BASELINE store: a 10M×768 clustered corpus generated on the device
    from ``--seed``, ``IVFFlatIndex`` (nlist 4096, int8) trained and built
    chunk by chunk (``train_from_device`` + ``append_balanced``), searched
    through ``IVFFlatIndex.search`` at batch 64 and 8192, nprobe 32;
    recall@10 against an exact ``Precision.HIGHEST`` oracle must reach 0.95.
``served``
    A 1M×768 epoch written to disk, recovered by an in-process gRPC server
    (``server.main.build_server``) and queried with packed ``Search`` RPCs;
    the wire ids must match a library search of the server's own index.
``mesh4`` (``--mesh4``, instead of the phases above)
    ``ShardedIVFFlatIndex.build_on_mesh`` over the same 10M corpus on four
    cards, compared with a one-card index built from the same centroids and
    assignment, plus ``ShardedIVFPQIndex`` against its one-card base.

The line before the last is the card's name and power limit from
``nvidia-smi``; the last line is ``{"ok": true, "device": {...}}``, printed
only when every phase passed. Without a GPU the script exits nonzero and
prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K = 10
DIM = 768
NLIST = 4096               # BASELINE coarse lists
MAIN_N = 10_000_000        # BASELINE corpus rows
SERVED_N = 1_000_000       # rows of the served epoch
PQ_N = 1_000_000           # rows of the sharded IVF-PQ check
CHUNK = 500_000            # corpus rows generated per build step
KERNEL_LISTS, KERNEL_CAP, KERNEL_BATCH = 512, 2560, 256


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def id_agreement(ids, ref) -> float:
    """Mean fraction of each reference row's ids found in the result row."""
    return float(np.mean([
        len(set(a.tolist()) & set(b.tolist())) / len(b)
        for a, b in zip(np.asarray(ids), np.asarray(ref))
    ]))


def timed(fn, *args, reps: int = 3):
    """(result, median wall ms) of ``fn(*args)`` after one warm call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        walls.append((time.perf_counter() - t) * 1e3)
    return out, float(np.median(walls))


def mixture_queries(seed: int, n: int, centers):
    """In-distribution queries: fresh draws from the corpus mixture."""
    import jax
    import jax.numpy as jnp

    kc, kn = jax.random.split(jax.random.PRNGKey(seed))
    ci = jax.random.randint(kc, (n,), 0, centers.shape[0])
    return centers[ci] + 0.25 * jax.random.normal(
        kn, (n, centers.shape[1]), jnp.float32
    )


# ---------------------------------------------------------------------- #
# kernel
# ---------------------------------------------------------------------- #

def phase_kernel(seed: int) -> dict:
    import functools

    import jax
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.ops.distance import (
        Metric,
        pairwise_distance,
    )
    from cuda_acceleratedvectordatabaseengine.ops.grouped_scan import (
        scan_probed_lists_grouped,
    )
    from cuda_acceleratedvectordatabaseengine.ops.scan import (
        scan_probed_lists,
    )

    t0 = time.perf_counter()
    nlist, batch = KERNEL_LISTS, KERNEL_BATCH

    @functools.partial(jax.jit, static_argnames=("cap",))
    def make_lists(keys, anchors, cap):
        def one(args):
            key, anchor = args
            res = 0.25 * jax.random.normal(key, (cap, anchor.shape[0]),
                                           jnp.float32)
            scale = jnp.maximum(jnp.max(jnp.abs(res), -1), 1e-12) / 127.0
            codes = jnp.clip(jnp.round(res / scale[:, None]), -127, 127)
            deq = anchor[None, :] + codes * scale[:, None]
            return (codes.astype(jnp.int8), scale,
                    jnp.sum(deq * deq, -1))
        return jax.lax.map(one, (keys, anchors))

    stores = {}

    def store(dim, cap):
        """int8 lists with per-row scales and residual anchors; one list
        ends mid-tile and one is completely full."""
        if (dim, cap) not in stores:
            ka, kl, kc = jax.random.split(jax.random.PRNGKey(seed + dim), 3)
            anchors = jax.random.normal(ka, (nlist, dim), jnp.float32)
            arena, scale, arena_sq = make_lists(
                jax.random.split(kl, nlist), anchors, cap
            )
            counts = jax.random.randint(kc, (nlist,), cap // 2, cap + 1)
            counts = counts.at[0].set(max(cap - 37, 1)).at[1].set(cap)
            queries = mixture_queries(seed + 1, batch, anchors)
            with jax.default_matmul_precision("highest"):
                coarse = pairwise_distance(queries, anchors, Metric.L2)
            stores[dim, cap] = (queries, arena, arena_sq,
                                counts.astype(jnp.int32), scale, anchors,
                                coarse)
        return stores[dim, cap]

    store(DIM, KERNEL_CAP)
    setup_s = time.perf_counter() - t0

    ref_fn = jax.jit(scan_probed_lists, static_argnames=("k", "metric"))
    ok, cases = True, []
    shapes = [(DIM, KERNEL_CAP, nprobe, metric, K)
              for nprobe in (4, 32)
              for metric in (Metric.L2, Metric.INNER_PRODUCT)]
    shapes += [(DIM, KERNEL_CAP, 32, Metric.L2, 100),
               (100, KERNEL_CAP, 32, Metric.L2, K),
               (DIM, 12, 32, Metric.L2, K)]
    for dim, cap, nprobe, metric, k in shapes:
        queries, arena, arena_sq, counts, scale, anchors, coarse = store(
            dim, cap
        )
        probe = jax.lax.top_k(-coarse, nprobe)[1].astype(jnp.int32)
        args = (queries, arena, arena_sq, counts, probe)
        kw = dict(k=k, metric=metric, arena_scale=scale,
                  arena_anchors=anchors)
        kern = jax.jit(functools.partial(scan_probed_lists_grouped, **kw))
        t = time.perf_counter()
        compiled = kern.lower(*args).compile()
        compile_s = time.perf_counter() - t
        mem = compiled.memory_analysis()
        (d, pos), kernel_ms = timed(compiled, *args)
        with jax.default_matmul_precision("highest"):
            (rd, rp), ref_ms = timed(functools.partial(ref_fn, **kw), *args)
        d, rd = np.asarray(d), np.asarray(rd)
        scale_d = float(np.abs(rd).max())
        max_abs = float(np.abs(d - rd).max())
        agree = id_agreement(pos, rp)
        case_ok = bool(
            np.isfinite(d).all() and d.shape == (batch, k)
            and max_abs <= 1e-4 * scale_d and agree >= 0.99
        )
        ok &= case_ok
        cases.append({
            "dim": dim, "cap": cap, "nprobe": nprobe,
            "metric": metric.value, "k": k, "ok": case_ok,
            "max_abs_err": max_abs,
            "max_rel_err": max_abs / max(scale_d, 1e-30),
            "id_agreement": agree, "compile_s": compile_s,
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "kernel_ms_b256": kernel_ms, "reference_ms_b256": ref_ms,
        })
    return {"phase": "kernel", "ok": ok, "tolerance":
            "max |d - d_ref| <= 1e-4 * max |d_ref|, id agreement >= 0.99",
            "setup_s": setup_s, "cases": cases,
            "wall_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------- #
# main: the BASELINE store
# ---------------------------------------------------------------------- #

def build_baseline(seed: int, n: int, dim: int, nlist: int, n_queries: int,
                   chunk: int):
    """Chunked on-device build of the clustered corpus into an int8
    IVF-Flat index, with the exact oracle updated chunk by chunk (the
    corpus is never whole on the device). Returns (index, queries,
    truth ids, timings)."""
    import jax
    import jax.numpy as jnp

    from bench import clustered_corpus, make_oracle_updater
    from cuda_acceleratedvectordatabaseengine import (
        IVFFlatConfig,
        IVFFlatIndex,
    )

    t0 = time.perf_counter()
    centers = jax.random.normal(jax.random.PRNGKey(seed + 1), (nlist, dim))
    queries = mixture_queries(seed + 2, n_queries, centers)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=dim, nlist=nlist,
                                     dtype="int8"))
    capacity = -(-int(n / nlist * 1.35) // 128) * 128
    oracle = make_oracle_updater(K)
    q_slice = 512
    slices = [slice(s, s + q_slice) for s in range(0, n_queries, q_slice)]
    gt_d = [jnp.full((q_slice, K), jnp.inf, jnp.float32) for _ in slices]
    gt_i = [jnp.full((q_slice, K), -1, jnp.int32) for _ in slices]
    keys = jax.random.split(jax.random.PRNGKey(seed), -(-n // chunk))
    t_train = 0.0
    for ci, start in enumerate(range(0, n, chunk)):
        m = min(chunk, n - start)
        xc, _ = clustered_corpus(keys[ci], m, dim, nlist, 0.25,
                                 centers=centers, base=start)
        if ci == 0:
            t = time.perf_counter()
            idx.train_from_device(xc)
            jax.block_until_ready(idx.centroids)
            t_train = time.perf_counter() - t
        idx.append_balanced(
            xc, ids=np.arange(start, start + m, dtype=np.uint64),
            capacity=capacity,
        )
        for j, s in enumerate(slices):
            gt_d[j], gt_i[j] = oracle(gt_d[j], gt_i[j], queries[s], xc,
                                      jnp.int32(start))
        del xc
    jax.block_until_ready(idx.arena.arena)
    truth = np.concatenate([np.asarray(g) for g in gt_i])
    return idx, np.asarray(queries), truth, {
        "build_s": time.perf_counter() - t0, "train_s": t_train,
    }


def recall_at_k(ids, truth) -> float:
    return id_agreement(ids.astype(np.int64), truth.astype(np.int64))


def phase_main(seed: int) -> dict:
    import jax

    from cuda_acceleratedvectordatabaseengine import SearchParams

    t0 = time.perf_counter()
    n, dim, nlist, nprobe = MAIN_N, DIM, NLIST, 32
    idx, queries, truth, timing = build_baseline(seed, n, dim, nlist, 8192,
                                                 CHUNK)
    params = SearchParams(nprobe=nprobe, k=K)
    out = {"phase": "main", "n": n, "dim": dim, "nlist": nlist,
           "dtype": "int8", "nprobe": nprobe, "k": K, **timing}
    searches = {}
    for b in (64, 8192):
        t = time.perf_counter()
        d, ids = idx.search(queries[:b], params)
        first_s = time.perf_counter() - t
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            d, ids = idx.search(queries[:b], params)
            walls.append((time.perf_counter() - t) * 1e3)
        searches[b] = (d, ids)
        out[f"b{b}"] = {
            "first_call_s": first_s,
            "wall_ms_median": float(np.median(walls)),
            "recall_at_10": recall_at_k(ids, truth[:b]),
            "finite": bool(np.isfinite(d).all()),
            "shape": list(ids.shape),
        }
    d8, i8 = searches[8192]
    out["b64_matches_b8192"] = id_agreement(searches[64][1], i8[:64])
    stats = idx.memory_stats()
    out["arena_bytes"] = stats["arena_bytes"]
    out["capacity_per_list"] = stats["capacity_per_list"]
    out["total_vectors"] = stats["total_vectors"]
    out["device_peak_bytes"] = (
        jax.devices()[0].memory_stats() or {}
    ).get("peak_bytes_in_use")
    out["ok"] = bool(
        out["b8192"]["recall_at_10"] >= 0.95
        and out["b64"]["recall_at_10"] >= 0.90
        and out["b64"]["finite"] and out["b8192"]["finite"]
        and out["b8192"]["shape"] == [8192, K]
        and out["b64_matches_b8192"] >= 0.99
        and stats["total_vectors"] == n
    )
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------- #
# served: one epoch through the gRPC server
# ---------------------------------------------------------------------- #

def phase_served(seed: int) -> dict:
    import grpc
    import jax

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from wire_bench import prepare_epoch

    from cuda_acceleratedvectordatabaseengine import SearchParams
    from cuda_acceleratedvectordatabaseengine.server.config import (
        ServerConfig,
    )
    from cuda_acceleratedvectordatabaseengine.server.grpc_api import (
        QueryServiceClient,
    )
    from cuda_acceleratedvectordatabaseengine.server.main import (
        build_server,
    )
    from cuda_acceleratedvectordatabaseengine.server.proto import vdb_pb2

    t0 = time.perf_counter()
    n, dim, nlist, nprobe, b = SERVED_N, DIM, NLIST, 32, 16
    out = {"phase": "served", "n": n, "dim": dim, "nlist": nlist}
    with tempfile.TemporaryDirectory() as data:
        out["prepare"] = prepare_epoch(data, n, dim, nlist, "int8",
                                       "default", seed)
        gc.collect()
        config = ServerConfig(
            address="127.0.0.1:0", data_path=data, coalesce_window_ms=1.0,
            warm_nprobes=(), shard_serving="off", metrics_enabled=False,
        )
        server, engine, _health, port = build_server(config)
        server.start()
        try:
            index = engine.get_state("default").index
            # queries drawn from the epoch's own mixture (prepare_epoch's
            # corpus generator derives its centers from the seed this way)
            kc, _ = jax.random.split(jax.random.PRNGKey(seed))
            centers = jax.random.normal(kc, (nlist, dim))
            queries = np.asarray(mixture_queries(seed + 3, 4 * b, centers))
            channel = grpc.insecure_channel(f"127.0.0.1:{port}")
            grpc.channel_ready_future(channel).result(timeout=60)
            query = QueryServiceClient(channel)
            wire, walls = [], []
            for i in range(4):
                q = np.ascontiguousarray(queries[i * b:(i + 1) * b], "<f4")
                t = time.perf_counter()
                resp = query.Search(vdb_pb2.SearchRequest(
                    index="default", topk=K, nprobe=nprobe,
                    packed_queries=q.tobytes(), packed_response=True,
                ))
                walls.append((time.perf_counter() - t) * 1e3)
                wire.append(np.frombuffer(resp.packed_ids, "<u8")
                            .reshape(b, K))
            channel.close()
            wire = np.concatenate(wire)
            _, lib = index.search(queries, SearchParams(nprobe=nprobe, k=K))
            out["rpc_wall_ms"] = walls
            out["ids_equal_fraction"] = float((wire == lib).mean())
            out["id_agreement"] = id_agreement(wire, lib)
            out["index_vectors"] = int(index.ntotal)
        finally:
            server.stop(grace=None)
            engine.close()
    out["ok"] = bool(out["id_agreement"] >= 0.99
                     and out["index_vectors"] == n)
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------- #
# mesh4: the sharded path on four cards
# ---------------------------------------------------------------------- #

def phase_mesh4(seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from bench import clustered_corpus
    from cuda_acceleratedvectordatabaseengine import (
        IVFFlatConfig,
        IVFFlatIndex,
        SearchParams,
    )
    from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
        IVFPQConfig,
        IVFPQIndex,
    )
    from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
        kmeans_assign,
    )
    from cuda_acceleratedvectordatabaseengine.parallel import (
        ShardedIVFFlatIndex,
        ShardedIVFPQIndex,
        make_mesh,
    )

    t0 = time.perf_counter()
    n, dim, nlist, nprobe, chunk = MAIN_N, DIM, NLIST, 32, CHUNK
    mesh = make_mesh(4)
    centers = jax.random.normal(jax.random.PRNGKey(seed + 1), (nlist, dim))
    x, _ = clustered_corpus(jax.random.PRNGKey(seed), n, dim, nlist, 0.25,
                            centers=centers)
    queries = np.asarray(mixture_queries(seed + 2, 1024, centers))
    cfg = IVFFlatConfig(dimension=dim, nlist=nlist, dtype="int8")
    t = time.perf_counter()
    sharded = ShardedIVFFlatIndex.build_on_mesh(
        mesh, cfg, x, key=jax.random.PRNGKey(seed), chunk_rows=chunk,
    )
    jax.block_until_ready(sharded.arena_s)
    out = {"phase": "mesh4", "n": n, "dim": dim, "nlist": nlist,
           "mesh_build_s": time.perf_counter() - t}
    arena = sharded.arena_s
    out["arena_devices"] = len(arena.sharding.device_set)
    out["arena_bytes_per_device"] = {
        str(s.device.id): int(s.data.nbytes)
        for s in arena.addressable_shards
    }

    # The one-card index from the same centroids and the same (nearest-
    # centroid) assignment, so both hold identical int8 codes. Sized once
    # up front: growing step by step would hold old and new arenas at once.
    t = time.perf_counter()
    single = IVFFlatIndex(cfg)
    single.centroids = jax.device_put(sharded.centroids, jax.devices()[0])
    single.trained = True
    single._publish_anchors()
    single.arena = single.arena.grow(sharded.global_cap)
    for start in range(0, n, chunk):
        xc = x[start:start + chunk]
        a = np.asarray(kmeans_assign(xc, single.centroids, cfg.metric))
        single.arena = single.arena.append(
            xc, np.arange(start, start + xc.shape[0], dtype=np.uint64), a
        )
    jax.block_until_ready(single.arena.arena)
    out["single_build_s"] = time.perf_counter() - t
    params = SearchParams(nprobe=nprobe, k=K)
    t = time.perf_counter()
    _, ids_m = sharded.search(queries, params)
    out["mesh_search_first_s"] = time.perf_counter() - t
    _, ids_s = single.search(queries, params)
    out["flat_id_agreement"] = id_agreement(ids_m, ids_s)
    del single
    gc.collect()

    # IVF-PQ through the striped XLA ADC scan vs its one-card base.
    t = time.perf_counter()
    n_pq = PQ_N
    pq = IVFPQIndex(IVFPQConfig(dimension=dim, nlist=nlist // 4,
                                m=dim // 8, keep_raw=False))
    xp = x[:n_pq]
    pq.train_from_device(xp)
    pq.add_from_device(xp)
    spq = ShardedIVFPQIndex(pq, mesh)
    out["pq_build_s"] = time.perf_counter() - t
    pq_params = SearchParams(nprobe=16, k=K)
    _, ids_pm = spq.search(queries[:256], pq_params)
    _, ids_ps = pq.search(queries[:256], pq_params)
    out["pq_id_agreement"] = id_agreement(ids_pm, ids_ps)
    out["pq_code_devices"] = len(spq.codes_t_s.sharding.device_set)

    sizes = list(out["arena_bytes_per_device"].values())
    out["ok"] = bool(
        out["arena_devices"] == 4 and len(sizes) == 4
        and max(sizes) <= 1.01 * min(sizes)
        and sum(sizes) == arena.nbytes
        and out["flat_id_agreement"] >= 0.99
        and out["pq_id_agreement"] >= 0.99
        and out["pq_code_devices"] == 4
    )
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------- #

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh4", action="store_true",
                   help="run only the four-card sharded phase")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX found {devices[0].platform!r} devices")
    if args.mesh4 and len(devices) < 4:
        fail(f"--mesh4 needs four GPUs, found {len(devices)}")
    sys.path.insert(0, REPO)
    from cuda_acceleratedvectordatabaseengine.utils.compile_cache import (
        enable_compile_cache,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    emit({"phase": "device", "device_kind": devices[0].device_kind,
          "count": len(devices), "compile_cache": enable_compile_cache()})

    phases = ([phase_mesh4] if args.mesh4
              else [phase_kernel, phase_main, phase_served])
    for phase in phases:
        result = phase(args.seed)
        emit(result)
        if not result["ok"]:
            fail(f"phase {result['phase']} failed")
        gc.collect()

    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
