"""Index manifest: JSON metadata describing a persisted index epoch.

Mirror of ``IndexManifest`` (``format/storage.h:15-42``,
``format/storage.cpp:22-132``): name, epoch, dimension, nlist, metric,
PQ {m, nbits}, per-list shard table, created_at (ns). Same on-disk role,
plus the fields this engine actually needs to reload (arena capacity,
storage dtype, index kind).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time


@dataclasses.dataclass
class ShardEntry:
    """One inverted list's extent inside the packed vectors file
    (reference keeps {list_id, path, num_vectors, file_size} per shard,
    ``format/storage.h:24-30``; here shards share one Arrow file and the
    entry records the row offset)."""

    list_id: int
    row_offset: int
    num_vectors: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ShardEntry":
        return cls(**d)


@dataclasses.dataclass
class IndexManifest:
    name: str = ""
    epoch: str = ""
    kind: str = "ivf_flat"            # ivf_flat | ivf_pq | flat
    dimension: int = 0
    nlist: int = 0
    metric: str = "L2"
    pq_m: int = 0                     # 0 = no PQ
    pq_nbits: int = 0
    num_vectors: int = 0
    capacity_per_list: int = 0
    dtype: str = "bfloat16"
    created_at_ns: int = 0
    shards: list[ShardEntry] = dataclasses.field(default_factory=list)
    extra: dict = dataclasses.field(default_factory=dict)

    FILENAME = "manifest.json"

    def save(self, directory: str) -> str:
        if not self.created_at_ns:
            self.created_at_ns = time.time_ns()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, self.FILENAME)
        payload = dataclasses.asdict(self)
        payload["shards"] = [s.to_dict() for s in self.shards]
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, path)          # atomic publish
        return path

    @classmethod
    def load(cls, directory: str) -> "IndexManifest":
        with open(os.path.join(directory, cls.FILENAME)) as f:
            payload = json.load(f)
        shards = [ShardEntry.from_dict(s) for s in payload.pop("shards", [])]
        return cls(shards=shards, **payload)
