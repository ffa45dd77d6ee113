"""Host-side utilities: batch bucketing, logging, profiling, config."""

from cuda_acceleratedvectordatabaseengine.utils.batching import bucket_size

__all__ = ["bucket_size"]
