"""Regenerate ``elasticdl_tpu_pb2.py`` WITHOUT protoc.

This image ships the protobuf runtime but no protoc / grpcio-tools (the
constraint that previously pushed new wire surfaces onto gRPC metadata —
the generation handshake, the worker-stats payload). A pb2 module,
however, is nothing but a serialized ``FileDescriptorProto`` plus builder
boilerplate — and the runtime's ``descriptor_pb2`` can build that proto in
pure Python. This tool loads the CURRENT serialized descriptor from the
checked-in pb2, applies the schema additions declared in ``PATCHES``
below, and re-emits the module in the standard generated style (including
the ``_serialized_start/_end`` offsets, recomputed by locating each
message's serialized sub-descriptor inside the file bytes).

Keep ``elasticdl_tpu.proto`` — the human-readable source of truth — in
sync by hand; ``tests/test_master_servicer.py`` pins the fields this tool
adds so the two cannot drift silently.

Run from the repo root:

    python -m elasticdl_tpu.proto.gen_pb2

Proto3 back/forward compatibility does the rest: an old worker never sets
the new fields (defaults decode as absent), a new worker talking to an old
master sends fields the old descriptor skips as unknown.
"""

from __future__ import annotations

import os

from google.protobuf import descriptor_pb2

_HERE = os.path.dirname(os.path.abspath(__file__))
_PB2_PATH = os.path.join(_HERE, "elasticdl_tpu_pb2.py")

# (message, field name, field number, type, extras)
_SCALAR = {
    "int32": descriptor_pb2.FieldDescriptorProto.TYPE_INT32,
    "int64": descriptor_pb2.FieldDescriptorProto.TYPE_INT64,
    "string": descriptor_pb2.FieldDescriptorProto.TYPE_STRING,
    "float": descriptor_pb2.FieldDescriptorProto.TYPE_FLOAT,
    "bool": descriptor_pb2.FieldDescriptorProto.TYPE_BOOL,
    "bytes": descriptor_pb2.FieldDescriptorProto.TYPE_BYTES,
}


def _add_field(msg, name, number, ftype, *, repeated=False, type_name=""):
    if any(f.name == name for f in msg.field):
        return False
    f = msg.field.add()
    f.name = name
    f.number = number
    f.label = (
        descriptor_pb2.FieldDescriptorProto.LABEL_REPEATED
        if repeated else descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL
    )
    if type_name:
        f.type = descriptor_pb2.FieldDescriptorProto.TYPE_MESSAGE
        f.type_name = type_name
    else:
        f.type = _SCALAR[ftype]
    f.json_name = _json_name(name)
    return True


def _json_name(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.capitalize() for p in parts[1:])


def apply_patches(fd: descriptor_pb2.FileDescriptorProto) -> int:
    """The schema additions this repo has accrued post-protoc. Idempotent —
    re-running against an already-patched descriptor changes nothing."""
    msgs = {m.name: m for m in fd.message_type}
    changed = 0

    # Batched task leases: the worker asks for up to max_tasks in one
    # round-trip; the master answers with `tasks` (the legacy singular
    # `task` stays populated with the first lease for old workers).
    changed += _add_field(msgs["GetTaskRequest"], "max_tasks", 2, "int32")
    changed += _add_field(
        msgs["GetTaskResponse"], "tasks", 4, "",
        repeated=True, type_name=".elasticdl_tpu.Task",
    )

    # Cohort-aggregated membership: a leader registers its member
    # processes in the SAME RegisterWorker round-trip, and its single
    # heartbeat carries one MemberBeat per member — reap scans and
    # version bumps stay O(cohorts), telemetry stays O(workers).
    if "MemberBeat" not in msgs:
        mb = fd.message_type.add()
        mb.name = "MemberBeat"
        _add_field(mb, "worker_id", 1, "int32")
        _add_field(mb, "model_version", 2, "int32")
        # same compact JSON payload as the edl-worker-stats metadata
        # (observability/health.py encode_stats/decode_stats bounds apply)
        _add_field(mb, "stats_json", 3, "string")
        changed += 1
        msgs["MemberBeat"] = mb
    changed += _add_field(
        msgs["HeartbeatRequest"], "members", 3, "",
        repeated=True, type_name=".elasticdl_tpu.MemberBeat",
    )
    changed += _add_field(
        msgs["RegisterWorkerRequest"], "member_names", 3, "string",
        repeated=True,
    )
    changed += _add_field(
        msgs["RegisterWorkerResponse"], "member_ids", 4, "int32",
        repeated=True,
    )

    # Elastic sharded embedding tier (embedding/): the master owns the
    # id-sharded table map; workers fetch it (GetEmbeddingShardMap) and
    # confirm installed shard migrations (ReportEmbeddingReshard). The
    # tier's DATA plane (pull/push) is worker-to-worker and does not
    # cross the master — only the map does.
    def _new_msg(name, fields):
        if name in msgs:
            return 0
        m = fd.message_type.add()
        m.name = name
        for fname, num, ftype, kw in fields:
            _add_field(m, fname, num, ftype, **kw)
        msgs[name] = m
        return 1

    changed += _new_msg("EmbeddingTableSpec", [
        ("name", 1, "string", {}),
        # PADDED vocab rows (ops/embedding.padded_vocab — the checkpoint
        # geometry rule) and the deterministic init params that let any
        # owner materialize a fresh shard bit-identically
        ("vocab", 2, "int32", {}),
        ("dim", 3, "int32", {}),
        ("seed", 4, "int32", {}),
        ("init_scale", 5, "float", {}),
    ])
    changed += _new_msg("GetEmbeddingShardMapRequest", [
        ("worker_id", 1, "int32", {}),
    ])
    changed += _new_msg("GetEmbeddingShardMapResponse", [
        ("version", 1, "int32", {}),
        ("num_shards", 2, "int32", {}),
        # shard id -> owning worker id, dense
        ("shard_owners", 3, "int32", {"repeated": True}),
        ("tables", 4, "", {
            "repeated": True,
            "type_name": ".elasticdl_tpu.EmbeddingTableSpec",
        }),
        # a move plan is in flight (or was interrupted by a master
        # crash): clients conservatively requeue unacked pushes
        ("resharding", 5, "bool", {}),
    ])
    changed += _new_msg("ReportEmbeddingReshardRequest", [
        ("worker_id", 1, "int32", {}),
        ("version", 2, "int32", {}),
        ("shard_ids", 3, "int32", {"repeated": True}),
    ])
    changed += _new_msg("ReportEmbeddingReshardResponse", [
        ("accepted", 1, "bool", {}),
    ])

    # Closed-loop autoscaler (ISSUE 14, master/autoscaler.py): the
    # graceful-eviction drain handshake. The master sets `evict` on a
    # worker's heartbeat response; the worker drains through its
    # existing preempt path (drain checkpoint + preempted report — the
    # remainder requeues FRONT like a death) and exits EX_TEMPFAIL.
    # Old workers skip the unknown field and keep training (the policy
    # falls back to lease-expiry recovery); old masters never set it.
    changed += _add_field(msgs["HeartbeatResponse"], "evict", 7, "bool")

    # Read replicas (ISSUE 13): per-shard replica assignments ride the
    # same map response, flattened row-major at `replica_count` slots
    # per shard with -1 padding (proto3 has no repeated-of-repeated
    # without a message per row; a flat stride keeps old workers
    # oblivious — they skip unknown fields and read primaries only).
    changed += _add_field(
        msgs["GetEmbeddingShardMapResponse"], "replica_count", 6, "int32")
    changed += _add_field(
        msgs["GetEmbeddingShardMapResponse"], "shard_replicas", 7, "int32",
        repeated=True)

    # Cross-host embedding data plane (ISSUE 15, embedding/data_plane.py):
    # every worker serves its owning store over a per-worker gRPC
    # endpoint; peers reach it through the OWNER ADDRESS BOOK that rides
    # the shard-map response (addr_worker_ids[i] serves at addrs[i]).
    # Workers report their data-plane address at registration; old
    # workers never set it and are simply absent from the book (their
    # shards stay reachable in-process / via LocalTransport only).
    changed += _add_field(
        msgs["RegisterWorkerRequest"], "data_plane_addr", 4, "string")
    changed += _add_field(
        msgs["GetEmbeddingShardMapResponse"], "addr_worker_ids", 8, "int32",
        repeated=True)
    changed += _add_field(
        msgs["GetEmbeddingShardMapResponse"], "addrs", 9, "string",
        repeated=True)

    # Skew-adaptive layout (ISSUE 20, master/layout_controller.py): the
    # controller's worker-replicated ultra-hot id set rides the same map
    # response — GLOBAL ids (int64, same width as the pull path's id
    # space), sorted. Old workers skip the unknown field and keep
    # serving the plain sharded layout.
    changed += _add_field(
        msgs["GetEmbeddingShardMapResponse"], "hot_ids", 10, "int64",
        repeated=True)

    # Data-plane RPC payloads. Id vectors travel as raw little-endian
    # int32 bytes and row matrices as raw float32 bytes + a dim field
    # (one memcpy each way — repeated scalar varint packing would cost
    # real CPU at serving rates). Watermarks are int64: they count every
    # applied push over a job's lifetime.
    changed += _new_msg("EmbeddingPullRequest", [
        ("table", 1, "string", {}),
        ("shard", 2, "int32", {}),
        ("ids", 3, "bytes", {}),          # int32 LE, pow2-padded (-1)
        ("map_version", 4, "int32", {}),
        ("with_watermark", 5, "bool", {}),
        ("replica", 6, "bool", {}),
    ])
    changed += _new_msg("EmbeddingPullResponse", [
        ("rows", 1, "bytes", {}),         # float32 LE, (n_ids, dim)
        ("dim", 2, "int32", {}),
        ("wm", 3, "int64", {}),
    ])
    changed += _new_msg("EmbeddingPushRequest", [
        ("table", 1, "string", {}),
        ("shard", 2, "int32", {}),
        ("ids", 3, "bytes", {}),
        ("rows", 4, "bytes", {}),
        ("dim", 5, "int32", {}),
        ("client_id", 6, "string", {}),
        ("seq", 7, "int64", {}),
        ("map_version", 8, "int32", {}),
        ("scale", 9, "float", {}),
        ("with_watermark", 10, "bool", {}),
    ])
    changed += _new_msg("EmbeddingPushResponse", [
        ("applied", 1, "bool", {}),
        ("wm", 2, "int64", {}),
    ])
    changed += _new_msg("EmbeddingFetchShardRequest", [
        ("table", 1, "string", {}),
        ("shard", 2, "int32", {}),
        ("replica", 3, "bool", {}),
    ])
    changed += _new_msg("EmbeddingFetchShardResponse", [
        ("rows", 1, "bytes", {}),
        ("rows_n", 2, "int32", {}),
        ("dim", 3, "int32", {}),
        # exactly-once seq watermarks as the same compact JSON dict the
        # checkpoint .npz files carry — the fence TRAVELS with the shard
        ("applied_json", 4, "string", {}),
        ("wm", 5, "int64", {}),
    ])
    changed += _new_msg("EmbeddingDeltaEntry", [
        ("wm", 1, "int64", {}),
        ("ids", 2, "bytes", {}),
        ("rows", 3, "bytes", {}),
        ("dim", 4, "int32", {}),
        ("scale", 5, "float", {}),
        ("client_id", 6, "string", {}),
        ("seq", 7, "int64", {}),
    ])
    changed += _new_msg("EmbeddingFetchDeltaRequest", [
        ("table", 1, "string", {}),
        ("shard", 2, "int32", {}),
        ("since_wm", 3, "int64", {}),
    ])
    changed += _new_msg("EmbeddingFetchDeltaResponse", [
        # False = the bounded delta log no longer reaches back to
        # since_wm; the caller falls back to a full FetchShard copy
        ("found", 1, "bool", {}),
        ("wm", 2, "int64", {}),
        ("entries", 3, "", {
            "repeated": True,
            "type_name": ".elasticdl_tpu.EmbeddingDeltaEntry",
        }),
    ])
    changed += _new_msg("EmbeddingWatermarkRequest", [
        ("table", 1, "string", {}),
        ("shard", 2, "int32", {}),
        ("replica", 3, "bool", {}),
    ])
    changed += _new_msg("EmbeddingWatermarkResponse", [
        ("wm", 1, "int64", {}),
    ])

    # Wire-speed data plane (ISSUE 18). One fused request carries every
    # (table, shard) sub-pull a step routes to one owner: ids travel as
    # ONE flat int32 blob segmented by `counts`, rows come back as ONE
    # flat float32 blob segmented by counts x dims — both decoded as
    # numpy frombuffer views, no per-table pack/unpack. The response
    # piggybacks the owner's FULL primary watermark set (wm_tables /
    # wm_shards / wm_values triples) so steady-state freshness probes
    # stop being calls at all.
    changed += _new_msg("EmbeddingPullMultiRequest", [
        ("tables", 1, "string", {"repeated": True}),
        ("shards", 2, "int32", {"repeated": True}),
        ("counts", 3, "int32", {"repeated": True}),
        ("ids", 4, "bytes", {}),          # flat int32 LE, all sub-pulls
        ("map_version", 5, "int32", {}),
        ("replica", 6, "bool", {}),
    ])
    changed += _new_msg("EmbeddingPullMultiResponse", [
        ("rows", 1, "bytes", {}),         # flat float32 LE, all sub-pulls
        ("dims", 2, "int32", {"repeated": True}),
        ("wms", 3, "int64", {"repeated": True}),
        ("wm_tables", 4, "string", {"repeated": True}),
        ("wm_shards", 5, "int32", {"repeated": True}),
        ("wm_values", 6, "int64", {"repeated": True}),
    ])
    changed += _new_msg("EmbeddingWatermarkMultiRequest", [
        ("tables", 1, "string", {"repeated": True}),
        ("shards", 2, "int32", {"repeated": True}),
        ("replica", 3, "bool", {}),
    ])
    changed += _new_msg("EmbeddingWatermarkMultiResponse", [
        ("wms", 1, "int64", {"repeated": True}),
    ])
    # Streaming replica sync / shard migration: server-streamed chunks
    # under ONE call instead of unary call-per-chunk. The seq fence
    # (applied_json + wm for a shard copy, the target watermark for a
    # delta) travels in the FIRST frame; `last` closes the stream so a
    # mid-stream drop is distinguishable from completion.
    changed += _new_msg("EmbeddingShardChunk", [
        ("rows", 1, "bytes", {}),         # this frame's row slab
        ("offset", 2, "int32", {}),       # first row index of the slab
        ("rows_n", 3, "int32", {}),       # total rows (first frame)
        ("dim", 4, "int32", {}),          # first frame
        ("applied_json", 5, "string", {}),  # seq fence (first frame)
        ("wm", 6, "int64", {}),           # first frame
        ("last", 7, "bool", {}),
    ])
    changed += _new_msg("EmbeddingDeltaChunk", [
        ("found", 1, "bool", {}),         # first frame
        ("wm", 2, "int64", {}),           # target watermark (first frame)
        ("entries", 3, "", {
            "repeated": True,
            "type_name": ".elasticdl_tpu.EmbeddingDeltaEntry",
        }),
        ("last", 4, "bool", {}),
    ])
    # Same-host shared-memory short-circuit: the client asks the owner
    # to create a dedicated SPSC ring segment for this (client, owner)
    # pair; the owner answers with the segment name to attach. Any
    # failure (no shm on the box, segment gone, payload too big) falls
    # back to gRPC transparently.
    changed += _new_msg("EmbeddingShmNegotiateRequest", [
        ("client_host", 1, "string", {}),
        ("client_pid", 2, "int32", {}),
        ("slot_bytes", 3, "int32", {}),
    ])
    changed += _new_msg("EmbeddingShmNegotiateResponse", [
        ("ok", 1, "bool", {}),
        ("segment", 2, "string", {}),
        ("slot_bytes", 3, "int32", {}),
    ])
    return changed


def _offsets(fd: descriptor_pb2.FileDescriptorProto, data: bytes):
    """(name, start, end) for every top-level message/enum, byte offsets of
    each serialized sub-descriptor inside the file's serialized bytes —
    what protoc emits as ``_serialized_start/_end``."""
    out = []
    for enum in fd.enum_type:
        sub = enum.SerializeToString()
        start = data.find(sub)
        out.append(("_" + enum.name.upper(), start, start + len(sub)))
    for msg in fd.message_type:
        sub = msg.SerializeToString()
        start = data.find(sub)
        out.append(("_" + msg.name.upper(), start, start + len(sub)))
        for nested in msg.nested_type:
            nsub = nested.SerializeToString()
            nstart = data.find(nsub)
            out.append((
                "_" + msg.name.upper() + "_" + nested.name.upper(),
                nstart, nstart + len(nsub),
            ))
    return out


_TEMPLATE = '''# -*- coding: utf-8 -*-
# Generated by elasticdl_tpu/proto/gen_pb2.py (no protoc on this image —
# the serialized descriptor is patched programmatically; schema source of
# truth: elasticdl_tpu.proto).  DO NOT EDIT BY HAND.
# source: elasticdl_tpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile({serialized!r})

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'elasticdl_tpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _JOBSTATUSRESPONSE_EVALMETRICSENTRY._options = None
  _JOBSTATUSRESPONSE_EVALMETRICSENTRY._serialized_options = b'8\\001'
{offset_lines}
# @@protoc_insertion_point(module_scope)
'''


def main() -> None:
    # read the CURRENT descriptor out of the checked-in pb2 without
    # importing it (importing would register it in the default pool and
    # block re-adding the patched file in this same process)
    with open(_PB2_PATH, encoding="utf-8") as f:
        src = f.read()
    marker = "AddSerializedFile("
    start = src.index(marker) + len(marker)
    # the literal sits on one line and may contain raw ')' bytes — take the
    # whole line and strip the closing paren of the call
    line = src[start:src.index("\n", start)]
    serialized = eval(line.rsplit(")", 1)[0])  # bytes literal from protoc

    fd = descriptor_pb2.FileDescriptorProto.FromString(serialized)
    changed = apply_patches(fd)
    data = fd.SerializeToString()

    lines = []
    for name, s, e in _offsets(fd, data):
        lines.append(f"  {name}._serialized_start={s}")
        lines.append(f"  {name}._serialized_end={e}")
    with open(_PB2_PATH, "w", encoding="utf-8") as f:
        f.write(_TEMPLATE.format(
            serialized=data, offset_lines="\n".join(lines) + "\n"))
    print(f"{_PB2_PATH}: {changed} schema addition(s), "
          f"{len(data)} descriptor bytes")


if __name__ == "__main__":
    main()
