"""Product quantization ops (K3/K4 + the never-implemented PQ trainer).

Reference counterparts:
  - ``pq_distance_table_kernel`` (K3, ``engine/kernels.cuh:188-223``): one
    thread per (query, subspace, codeword) computing an L2 table entry.
  - ``pq_scan_kernel`` (K4, ``engine/kernels.cuh:226-312``): ADC scan with the
    distance table staged in shared memory.
  - ``pq_trainer.cpp`` — a build ghost (``indexmgr/CMakeLists.txt:8-47``
    references it; the file does not exist). Implemented here as vmapped
    per-subspace k-means.

Design: the distance tables are one batched matrix product per query
batch (``bmd,mkd->bmk``); the ADC scan is a vectorized table gather +
reduction over subspaces. This engine quantizes *residuals* (vector minus its
coarse centroid) — the standard IVF-PQ formulation — so tables are built per
(query, probed list) from the query's residual.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda_acceleratedvectordatabaseengine.ops.kmeans import kmeans_fit
from cuda_acceleratedvectordatabaseengine.ops.topk import topk_smallest


def train_product_quantizer(
    key: jax.Array,
    x: jax.Array,          # [n, dim] fp32 training sample (residuals)
    m: int,
    ks: int = 256,
    iters: int = 10,
) -> jax.Array:
    """Train per-subspace codebooks: ``[m, ks, dsub]`` fp32 (the
    reference's ghost ``pq_trainer``).

    Sequential (one jitted k-means per subspace, same executable reused m
    times) rather than vmapped: the vmapped ``[m, n, dsub]`` layout puts
    dsub=8 on the minor dimension, which tiled layouts pad many-fold.
    Per-subspace ``[n, dsub]`` slices bound that waste to one subspace at
    a time."""
    n, dim = x.shape
    assert dim % m == 0, f"dim {dim} not divisible by m {m}"
    dsub = dim // m
    keys = jax.random.split(key, m)

    @jax.jit
    def fit_one(k_i, xs):
        centroids, _ = kmeans_fit(k_i, xs, ks, iters=iters, init="random")
        return centroids

    out = []
    for j in range(m):
        cb = fit_one(keys[j], x[:, j * dsub:(j + 1) * dsub])
        # Serialize: a deep async queue of m programs keeps every
        # in-flight program's buffers live.
        cb.block_until_ready()
        out.append(cb)
    return jnp.stack(out)                               # [m, ks, dsub]


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def _refresh_codebooks(xr, codes, codebooks, chunk_size: int = 2048):
    """One warm Lloyd step per subspace: codewords ← mean of their assigned
    (rotated) subvectors. Chunked one-hot matmul accumulation — the naive
    ``[n, m, ks]`` one-hot is ~6 GB at the 768-D training shape."""
    n, dim = xr.shape
    m, ks, dsub = codebooks.shape
    pad = (-n) % chunk_size
    xp = jnp.pad(xr, ((0, pad), (0, 0))).reshape(-1, chunk_size, dim)
    # Padded rows point at codeword 0 but are masked via a validity column.
    cp = jnp.pad(codes, ((0, pad), (0, 0))).reshape(-1, chunk_size, m)
    valid = jnp.pad(
        jnp.ones((n,), jnp.float32), (0, pad)
    ).reshape(-1, chunk_size)

    def body(carry, inp):
        sums, cnts = carry
        xc, cc, vc = inp
        x_sub = xc.reshape(chunk_size, m, dsub)
        onehot = jax.nn.one_hot(
            cc.astype(jnp.int32), ks, dtype=jnp.float32
        ) * vc[:, None, None]                           # [c, m, ks]
        sums = sums + jnp.einsum(
            "cmk,cmd->mkd", onehot, x_sub,
            preferred_element_type=jnp.float32,
        )
        cnts = cnts + jnp.sum(onehot, axis=0)
        return (sums, cnts), None

    (sums, cnts), _ = jax.lax.scan(
        body,
        (jnp.zeros((m, ks, dsub), jnp.float32),
         jnp.zeros((m, ks), jnp.float32)),
        (xp, cp, valid),
    )
    return jnp.where(
        cnts[..., None] > 0,
        sums / jnp.maximum(cnts[..., None], 1.0),
        codebooks,
    )


# Rotation algebra must NOT ride the platform's default matmul precision:
# fp32 matmuls may lower to reduced precision (TF32 on the GPU), so even
# U @ Vᵀ of a perfectly orthogonal SVD pair can come back with
# max|RᵀR−I| far above fp32 rounding. A non-isometric
# "rotation" silently distorts every rotated-frame distance by ~|RᵀR−I|;
# the exact rerank inherits that as a systematic ~0.3% metric error, an
# order of magnitude above bf16 STORAGE noise — the OPQ deep-rerank recall
# plateau of rounds 3-4 (recall 0.981 at shortlist containment 1.0).
_PREC_HI = jax.lax.Precision.HIGHEST


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.matmul(a, b, precision=_PREC_HI)


def _orthonormalize(R: jax.Array) -> jax.Array:
    """Pull a near-orthogonal matrix back onto the orthogonal manifold with
    two Newton–Schulz iterations (R ← ½R(3I − RᵀR), quadratic convergence)
    at HIGHEST precision — the final guarantee that the published rotation
    is an isometry to fp32 roundoff regardless of how it was produced."""
    eye = jnp.eye(R.shape[0], dtype=R.dtype)
    for _ in range(2):
        R = 0.5 * _mm(R, 3.0 * eye - _mm(R.T, R))
    return R


@jax.jit
def _opq_step(x, R, codebooks):
    """One OPQ-NP alternation: Procrustes rotation update from the current
    code reconstruction, then a warm Lloyd refresh of the codebooks in the
    new rotated frame."""
    xr = _mm(x, R)
    codes = pq_encode(xr, codebooks)
    y = pq_decode(codes, codebooks)
    # min_R ‖xR − y‖_F over orthogonal R → R = U Vᵀ with U S Vᵀ = svd(xᵀy)
    u, _, vt = jnp.linalg.svd(_mm(x.T, y), full_matrices=False)
    R = _orthonormalize(_mm(u, vt))
    xr = _mm(x, R)
    codes = pq_encode(xr, codebooks)
    return R, _refresh_codebooks(xr, codes, codebooks)


def opq_fit(
    key: jax.Array,
    x: jax.Array,          # [n, dim] fp32 training sample (residuals)
    m: int,
    ks: int = 256,
    iters: int = 10,
    opq_iters: int = 6,
) -> tuple[jax.Array, jax.Array]:
    """Optimized Product Quantization (OPQ-NP, Ge et al. CVPR'13): learn an
    ORTHOGONAL rotation ``R [dim, dim]`` + codebooks minimizing
    ``‖xR − decode(encode(xR))‖²``. The rotation redistributes correlated
    variance across subspaces, which plain PQ's fixed axis-aligned split
    cannot (the reference has no PQ trainer at all — ``pq_trainer.cpp`` is
    a build ghost, ``indexmgr/CMakeLists.txt:8-47``).

    One refinement over the plain alternation (a deep-rerank recall
    plateau named the alternation's warm Lloyd-refreshed codebooks —
    dragged through a moving rotation — as a bias source): a FRESH
    per-subspace k-means retrain at the converged rotation replaces
    them. Measured on the anisotropic probe workload: mean distortion
    1.3075→1.2981 and the p99.9 tail 3.16→2.98 (the tail is what deep
    shortlists die on). Eigenvalue-allocation init (OPQ-P) was also
    tried and measured WORSE than identity on rotated decaying spectra
    (1.62 vs 1.31 post-alternation) — not used.

    Returns ``(R, codebooks)``. Rotation is an isometry, so callers apply
    it once at the index boundary (rotate centroids/ingest/queries) and
    every distance downstream is unchanged — no kernel changes needed."""
    x = x.astype(jnp.float32)
    k1, k2 = jax.random.split(key)
    codebooks = train_product_quantizer(k1, x, m, ks, iters)
    R = jnp.eye(x.shape[1], dtype=jnp.float32)
    for _ in range(opq_iters):
        # One jitted alternation per step (executable reused across iters).
        R, codebooks = _opq_step(x, R, codebooks)
    R.block_until_ready()
    codebooks = train_product_quantizer(k2, _mm(x, R), m, ks, iters)
    return R, codebooks


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def pq_encode(
    x: jax.Array,          # [n, dim] fp32 (residuals)
    codebooks: jax.Array,  # [m, ks, dsub] fp32
    chunk_size: int = 4096,
) -> jax.Array:
    """Encode vectors to ``[n, m]`` uint8 codes: per-subspace nearest
    codeword (argmin over a distance contraction). Chunked over n —
    the [n, m, ks] distance tensor would otherwise scale to tens of GB."""
    n, dim = x.shape
    m, ks, dsub = codebooks.shape
    c_sq = jnp.sum(codebooks * codebooks, axis=-1)      # [m, ks]

    def encode_chunk(xc):
        x_sub = xc.reshape(xc.shape[0], m, dsub)
        dots = jnp.einsum(
            "nmd,mkd->nmk", x_sub, codebooks,
            preferred_element_type=jnp.float32,
        )
        d = c_sq[None] - 2.0 * dots                     # r² constant in argmin
        return jnp.argmin(d, axis=-1).astype(jnp.uint8)

    if n <= chunk_size:
        return encode_chunk(x)
    pad = (-n) % chunk_size
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    chunks = xp.reshape(-1, chunk_size, dim)
    _, codes = jax.lax.scan(
        lambda _, xc: (None, encode_chunk(xc)), None, chunks
    )
    return codes.reshape(-1, m)[:n]


def pq_distance_tables(
    residuals: jax.Array,  # [B, dim] fp32 (query minus coarse centroid)
    codebooks: jax.Array,  # [m, ks, dsub] fp32
) -> jax.Array:
    """ADC distance tables ``[B, m, ks]`` fp32 (K3,
    ``engine/kernels.cuh:188-223``): table[b, j, c] = ||r_j - codebook_jc||²,
    as one batched matmul + fused elementwise."""
    b, dim = residuals.shape
    m, ks, dsub = codebooks.shape
    r_sub = residuals.reshape(b, m, dsub)
    dots = jnp.einsum(
        "bmd,mkd->bmk", r_sub, codebooks,
        preferred_element_type=jnp.float32,
    )
    r_sq = jnp.sum(r_sub * r_sub, axis=-1)               # [B, m]
    c_sq = jnp.sum(codebooks * codebooks, axis=-1)       # [m, ks]
    return r_sq[:, :, None] - 2.0 * dots + c_sq[None]


def pq_adc_lookup(
    tables: jax.Array,     # [B, m, ks] fp32
    codes: jax.Array,      # [B, m, L] uint8 (code-major / transposed layout)
) -> jax.Array:
    """ADC scan (K4, ``engine/kernels.cuh:226-312``): distance of each coded
    vector = Σ_j table[b, j, code[b, j, l]]. Returns ``[B, L]`` fp32.

    Codes arrive subspace-major (the device storage layout); the lookup is
    a straight ``take_along_axis`` over the table's codeword axis, which
    XLA lowers to a native gather."""
    gathered = jnp.take_along_axis(
        tables, codes.astype(jnp.int32), axis=-1
    )                                                    # [B, m, L]
    return jnp.sum(gathered, axis=1)


def scan_probed_codes(
    q: jax.Array,           # [B, D] fp32 (index frame; unit norm if cosine)
    codes_t: jax.Array,     # [nlist, m, L] uint8 (L = local capacity)
    counts: jax.Array,      # [nlist] int32 live rows per list (GLOBAL)
    centroids: jax.Array,   # [nlist, D] fp32 coarse centroids
    codebooks: jax.Array,   # [m, ks, dsub] fp32
    probe_ids: jax.Array,   # [B, P] int32, -1 = no probe
    k: int,
    inner_product: bool = False,
    k_inner: int | None = None,
    slot_stride: int = 1,
    slot_offset: jax.Array | int = 0,
    global_capacity: int | None = None,
    vma_axes: tuple = (),
) -> tuple[jax.Array, jax.Array]:
    """IVF-PQ ADC scan over each query's probed lists with a running top-k
    merge: per probe step, residual distance tables (or inner-product
    tables plus a ``-q·c`` bias), a gather lookup over the list's codes,
    and a merge into the best ``k``.

    Returns ``(dists [B, k] ascending, global positions [B, k], -1
    empty)``. The result is the exact ADC top-k over the probe union unless
    ``k_inner`` is set: then each (query, list) pair contributes only its
    best ``k_inner`` candidates, a shortlist for a following exact rerank
    (a candidate ranked below ``k_inner`` within its own list is lost).

    Slot striping (``parallel/sharded``): with the code arena's slot axis
    striped round-robin over N devices, pass ``slot_stride=N``,
    ``slot_offset=axis_index`` and the global capacity; validity and
    positions are then in logical slot space (see
    ``ops/scan.scan_probed_lists``)."""
    b, dim = q.shape
    nlist, m, cap = codes_t.shape
    nprobe = probe_ids.shape[1]
    global_cap = global_capacity if global_capacity is not None else cap
    ki = None
    if k_inner:
        ki = min(max(k_inner, -(-k // nprobe)), cap, k)
    slot_logical = (
        jnp.arange(cap, dtype=jnp.int32) * slot_stride + slot_offset
    )
    init_d = jnp.full((b, k), jnp.inf, jnp.float32)
    init_p = jnp.full((b, k), -1, jnp.int32)
    if vma_axes:
        init_d = jax.lax.pcast(init_d, vma_axes, to="varying")
        init_p = jax.lax.pcast(init_p, vma_axes, to="varying")

    def step(carry, lists):
        best_d, best_p = carry
        safe = jnp.maximum(lists, 0)
        c = centroids[safe]                             # [B, D]
        if inner_product:
            # d = -(q·x) = -(q·c) - (q·r): table term from q, bias from c.
            tables = -jnp.einsum(
                "bmd,mkd->bmk", q.reshape(b, m, dim // m), codebooks,
                preferred_element_type=jnp.float32,
            )
            bias = -jnp.sum(q * c, axis=-1)
        else:
            # L2 (and cosine as L2 over unit vectors): ADC over residual
            # tables, exact for the quantized representation.
            tables = pq_distance_tables(q - c, codebooks)
            bias = jnp.zeros((b,), jnp.float32)
        d = pq_adc_lookup(tables, codes_t[safe]) + bias[:, None]
        valid = (slot_logical[None, :] < counts[safe][:, None]) & (
            lists >= 0
        )[:, None]
        d = jnp.where(valid, d, jnp.inf)
        pos = jnp.where(
            valid, safe[:, None] * global_cap + slot_logical[None, :], -1
        )
        if ki is not None:
            d, pos = topk_smallest(d, ki, idx=pos)
        best_d, best_p = topk_smallest(
            jnp.concatenate([best_d, d], axis=-1), k,
            idx=jnp.concatenate([best_p, pos], axis=-1),
        )
        return (best_d, best_p), None

    (best_d, best_p), _ = jax.lax.scan(step, (init_d, init_p), probe_ids.T)
    return best_d, best_p


def pq_decode(
    codes: jax.Array,      # [n, m] uint8
    codebooks: jax.Array,  # [m, ks, dsub] fp32
    chunk_size: int = 8192,
) -> jax.Array:
    """Reconstruct residuals from codes: ``[n, m·dsub]`` fp32 (the decode
    the reference never needed on-GPU; used for stored-point norms and
    snapshot-free rebuilds).

    Chunked over n: the gathered ``[n, m, dsub]`` intermediate has a tiny
    last dim that tiled layouts pad many-fold; per chunk (8192 rows) the
    result reshapes to ``[c, m·dsub]`` immediately."""
    m = codebooks.shape[0]
    n = codes.shape[0]

    def decode_chunk(cc):
        picked = codebooks[jnp.arange(m)[None, :], cc.astype(jnp.int32)]
        return picked.reshape(cc.shape[0], -1)

    if n <= chunk_size:
        return decode_chunk(codes)
    pad = (-n) % chunk_size
    cp = jnp.pad(codes, ((0, pad), (0, 0)))
    chunks = cp.reshape(-1, chunk_size, m)
    _, out = jax.lax.scan(
        lambda _, cc: (None, decode_chunk(cc)), None, chunks
    )
    return out.reshape(-1, m * codebooks.shape[2])[:n]
