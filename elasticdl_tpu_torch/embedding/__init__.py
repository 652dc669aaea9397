"""Elastic sharded embedding tier (ROADMAP 1).

Reference parity: the reference ElasticDL's parameter-service embedding
tier — tables sharded by id across PS pods (`id % ps_num`,
elasticdl/python/worker/ps_client.py), per-minibatch
pull_embedding_vectors / push_gradients round-trips, and the Go PS
applying sparse gradients row by row (elasticdl/pkg/ps/optimizer.go).

Rebuilt here as a TIER, not a sidecar process: tables are id-sharded
across owning workers (`sharding.shard_of`), the shard map is owned by
the master and committed through the control-plane journal
(`sharding.ShardMapOwner` — it survives master crash-restart), and the
per-batch protocol dedupes ids and batches per-shard calls
(`tier.EmbeddingTierClient`) before the owning store
(`store.EmbeddingShardStore`) hits the fused gather / deduped
scatter-add kernels in ops/embedding.py + ops/pallas_scatter.py.
Resharding on world change rides the same announce → quiesce → handoff
shape as mesh rescale: shards migrate via `reshard.apply_moves`
(device-to-device through parallel/elastic.reshard_state) with
exactly-once update semantics fenced by shard-map version + master
generation.

The serving-grade READ path (ISSUE 13) stacks three switchable layers
on the tier: a worker-local staleness-bounded hot-row cache fenced by
per-shard push watermarks (`cache.HotRowCache`), journal-committed read
replicas with watermark-delta sync and owner-death promotion, and a
pull/compute overlap pipeline (`tier.EmbeddingPullPipeline`).

See docs/architecture.md "Embedding tier" and docs/performance.md
"Embedding tier sizing" / "Embedding read path".
"""

from elasticdl_tpu_torch.embedding.cache import HotRowCache  # noqa: F401
from elasticdl_tpu_torch.embedding.sharding import (  # noqa: F401
    ShardMapOwner,
    ShardMapView,
    TableSpec,
    assign_replicas,
    plan_moves,
    shard_of,
)
from elasticdl_tpu_torch.embedding.store import EmbeddingShardStore  # noqa: F401
from elasticdl_tpu_torch.embedding.tier import (  # noqa: F401
    EmbeddingPullPipeline,
    EmbeddingTierClient,
)
from elasticdl_tpu_torch.embedding.transport import LocalTransport  # noqa: F401
