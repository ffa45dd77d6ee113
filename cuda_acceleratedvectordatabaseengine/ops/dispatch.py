"""One place that chooses the probed-list scan for a platform.

Every search path (single device, mesh, streaming tiers) resolves its
``scan_impl`` here and runs the result through :func:`run_scan`:

  - ``"gpu"``: the list-grouped Triton kernel
    (``ops/grouped_scan.scan_probed_lists_grouped``), which takes every
    feature width, capacity and k;
  - ``"cpu"``: the XLA reference scan (``ops/scan.scan_probed_lists``), for
    tests and tools;
  - any other platform raises.

A kernel never falls back to the Pallas interpreter or to the reference on
the GPU; interpret mode is something only tests ask for. An explicit
``"gather"`` or ``"grouped"`` is taken as asked.
"""

from __future__ import annotations

from cuda_acceleratedvectordatabaseengine.ops import grouped_scan
from cuda_acceleratedvectordatabaseengine.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine.ops.scan import scan_probed_lists

SCAN_IMPLS = ("auto", "grouped", "gather")
_AUTO = {"gpu": "grouped", "cpu": "gather"}


def resolve_scan_impl(impl: str, platform: str) -> str:
    """Concrete scan name for ``impl`` on ``platform``."""
    if impl not in SCAN_IMPLS:
        raise ValueError(f"unknown scan_impl {impl!r}; one of {SCAN_IMPLS}")
    if impl != "auto":
        return impl
    if platform not in _AUTO:
        raise ValueError(f"no scan implementation for platform {platform!r}")
    return _AUTO[platform]


def run_scan(
    impl: str,
    queries,
    arena,
    arena_sq,
    counts,
    probe_ids,
    k: int,
    metric: Metric = Metric.L2,
    *,
    approx: bool = False,
    arena_scale=None,
    arena_anchors=None,
    slot_stride: int = 1,
    slot_offset=0,
    global_capacity: int | None = None,
    vma_axes: tuple = (),
):
    """Run the resolved scan ``impl`` (see :func:`resolve_scan_impl`);
    every implementation returns ``(dists [B, k], global positions [B, k])``
    under the same striping contract."""
    stripe = dict(slot_stride=slot_stride, slot_offset=slot_offset,
                  global_capacity=global_capacity)
    if impl == "grouped":
        return grouped_scan.scan_probed_lists_grouped(
            queries, arena, arena_sq, counts, probe_ids, k, metric,
            approx=approx, arena_scale=arena_scale,
            arena_anchors=arena_anchors, **stripe,
        )
    if impl == "gather":
        return scan_probed_lists(
            queries, arena, arena_sq, counts, probe_ids, k, metric,
            vma_axes=vma_axes, arena_scale=arena_scale,
            arena_anchors=arena_anchors, **stripe,
        )
    raise ValueError(f"unresolved scan_impl {impl!r}")
