"""Mesh-sharded streaming tier: slot-striped device cache + all-gather merge.

Completes the multi-chip story for the capacity tier (SURVEY §2.9 + §5
">HBM corpus scaling"): the reference *claimed* multi-GPU for everything
including its prefetcher stack (``/root/reference/README.md:25``,
``engine/prefetcher.h:139-183``) but shipped zero sharding code. Here the
:class:`~cuda_acceleratedvectordatabaseengine.io_host.streaming.StreamingIVFFlatIndex`
design extends to a ``jax.sharding.Mesh`` the same way the resident index
does (``parallel/sharded``):

- The **cache arena's slot-capacity axis is round-robin striped** across
  the mesh (chip ``s`` holds logical slots ``j*N + s`` of every cached
  list). An N-chip mesh therefore serves an N× larger HBM working set —
  cache capacity scales with the slice, which is the whole point of a
  capacity tier.
- **Miss uploads scatter shard-locally**: the host stack is permuted into
  physical stripe order and ``device_put`` with the matching
  ``NamedSharding``, so the donating scatter compiles to N local updates
  with no cross-chip traffic (each chip ingests 1/N of every uploaded
  list's bytes — H2D bandwidth also scales with the slice).
- **Scans run SPMD** with the striping-aware kernels
  (``slot_stride=N, slot_offset=shard``) and merge ``[B, k]`` candidates
  with one tiny ``all_gather`` — identical to the resident
  sharded search.

Host-side bookkeeping (LRU/LFU, wave planning, id lookup) is inherited
unchanged: slot residency is a *logical* property, independent of how a
slot's bytes are laid out across chips.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from cuda_acceleratedvectordatabaseengine.io_host.cache import (
    HbmListCache,
)
from cuda_acceleratedvectordatabaseengine.io_host.streaming import (
    HostListStore,
    StreamingIVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine.ops.dispatch import (
    resolve_scan_impl,
    run_scan,
)
from cuda_acceleratedvectordatabaseengine.ops.topk import topk_smallest
from cuda_acceleratedvectordatabaseengine.parallel.mesh import SHARD_AXIS
from cuda_acceleratedvectordatabaseengine.parallel.sharded import (
    _striping_perm,
    sharded_zeros,
)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "k", "metric", "n_shards", "global_cap",
                     "scan_impl", "has_scale"),
)
def _sharded_cache_scan(
    q, arena_s, sq_s, counts, scale_s, anchors, slot_probe,
    mesh, k, metric, n_shards, global_cap, scan_impl="gather",
    has_scale=False,
):
    """SPMD wave scan over the striped cache arena.

    ``slot_probe`` is the wave's slot-remapped probe table (replicated;
    ``-1`` = padding). Positions come back in LOGICAL slot space
    (``slot * global_cap + logical_offset``) so the caller's
    (slot, offset) decomposition is striping-oblivious."""

    def local_fn(q, arena_l, sq_l, cnt, scale, anch, probe):
        s = jax.lax.axis_index(SHARD_AXIS)
        d, pos = run_scan(
            scan_impl, q, arena_l, sq_l, cnt, probe, k, metric,
            arena_scale=scale if has_scale else None,
            arena_anchors=anch if has_scale else None,
            slot_stride=n_shards, slot_offset=s, global_capacity=global_cap,
            vma_axes=(SHARD_AXIS,),
        )
        d_all = jax.lax.all_gather(d, SHARD_AXIS, axis=-1, tiled=True)
        p_all = jax.lax.all_gather(pos, SHARD_AXIS, axis=-1, tiled=True)
        return topk_smallest(d_all, k, idx=p_all)

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(), P(None, SHARD_AXIS, None), P(None, SHARD_AXIS), P(),
            P(None, SHARD_AXIS), P(), P(),
        ),
        out_specs=(P(), P()),
        # Outputs ARE replicated (identical all_gather + top-k everywhere)
        # but the static vma checker can't prove it through top_k.
        check_vma=False,
    )
    return fn(q, arena_s, sq_s, counts, scale_s, anchors, slot_probe)


class ShardedHbmListCache(HbmListCache):
    """:class:`HbmListCache` whose device arrays are slot-striped over a
    mesh. Capacity is padded up so every device's stripe is 16-aligned
    (the grouped kernel's smallest slot tile); the padding rows carry count
    0 and never scan."""

    def __init__(self, mesh, n_slots, capacity, dim, dtype=jnp.bfloat16,
                 policy: str = "lru"):
        self.mesh = mesh
        self.n_shards = n = mesh.devices.size
        capacity = -(-capacity // (16 * n)) * (16 * n)
        # physical stripe position p ← logical slot perm[p]
        self._perm = _striping_perm(capacity, n)
        self._shard = {
            2: NamedSharding(mesh, P(None, SHARD_AXIS)),
            3: NamedSharding(mesh, P(None, SHARD_AXIS, None)),
        }
        self._repl = NamedSharding(mesh, P())
        super().__init__(n_slots, capacity, dim, dtype, policy)

    def _device_zeros(self, shape, dtype, cap_axis=None):
        sharding = (
            self._shard[len(shape)] if cap_axis is not None else self._repl
        )
        return sharded_zeros(shape, dtype, sharding)

    def _stage_update(self, arr, cap_axis=None):
        arr = np.asarray(arr)
        if cap_axis is not None:
            # Host rows are in logical slot order; physical stripe order is
            # the striping permutation, after which a contiguous axis split
            # puts logical slots {j*N+s} on chip s.
            arr = np.take(arr, self._perm, axis=cap_axis)
            return jax.device_put(arr, self._shard[arr.ndim])
        return jax.device_put(arr, self._repl)


class ShardedStreamingIVFFlatIndex(StreamingIVFFlatIndex):
    """>HBM streaming tier over a device mesh.

    Same serving surface as the single-chip tier; ``cache_slots`` /
    ``max_device_bytes`` now describe the AGGREGATE mesh budget (each chip
    holds 1/N of every slot). Exactness vs the single-chip tier is
    CI-tested on the virtual 8-device mesh."""

    def __init__(
        self,
        mesh,
        store: HostListStore,
        centroids,
        config,
        cache_slots: int | None = None,
        max_device_bytes: int | None = None,
        policy: str = "lru",
        scan_impl: str = "auto",
        capacity: int | None = None,
    ):
        self.mesh = mesh
        self.n_shards = mesh.devices.size
        self._repl = NamedSharding(mesh, P())
        self._init_from_store(
            store, jax.device_put(jnp.asarray(centroids), self._repl),
            config, cache_slots, max_device_bytes, policy, scan_impl,
            capacity,
        )

    @classmethod
    def from_base(cls, base, mesh, **kw) -> "ShardedStreamingIVFFlatIndex":
        """Snapshot a resident single-chip index into a mesh-served
        streaming tier (host store keeps the stored representation
        verbatim — int8 codes stay int8)."""
        store = HostListStore.from_arena(base.arena)
        return cls(mesh, store, base.centroids, base.config,
                   capacity=base.arena.capacity, **kw)

    def _make_cache(self, cache_slots, cap, dim, dtype, policy):
        return ShardedHbmListCache(
            self.mesh, cache_slots, cap, dim, dtype, policy
        )

    def _run_cache_scan(self, q, slot_probe: np.ndarray, k: int):
        cache = self.cache
        quantized = cache.quantized
        scale_s = (
            cache.cache_scale if quantized
            # zeros placeholder so the shard_map signature is static; the
            # capacity axis just needs to split evenly over the mesh.
            else jax.device_put(
                jnp.zeros((cache.n_slots + 1, 16 * self.n_shards),
                          jnp.float32),
                cache._shard[2],
            )
        )
        anchors = (
            cache.cache_anchors if quantized
            else jax.device_put(
                jnp.zeros((cache.n_slots + 1, self.config.dimension),
                          jnp.float32),
                self._repl,
            )
        )
        scan_impl = resolve_scan_impl(
            self.scan_impl, self.mesh.devices.flat[0].platform
        )
        return _sharded_cache_scan(
            jax.device_put(q, self._repl),
            cache.cache_arena, cache.cache_sq, cache.cache_counts,
            scale_s, anchors,
            jax.device_put(jnp.asarray(slot_probe), self._repl),
            self.mesh, k, self.metric, self.n_shards, cache.capacity,
            scan_impl, quantized,
        )
