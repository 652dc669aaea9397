"""The port's embedding tier against the reference's, on the CPU.

Both packages build the same tier from the same inputs (numpy seeds): the
reference runs in-process on JAX's CPU, its device-mode store with the
exact placement (`EDL_EMB_SCATTER=sorted`) and a compile cache of its
own; the port's device-mode store runs on `device="cpu"`, where K1's
wrapper takes its plain version. Cases:

- `_init_shard_rows` is bit-equal for several (table, shard, N);
- store pulls and pushes in host and device mode against the
  reference's store in both its modes, on one view and one push stream:
  deduped pushes (sorted unique ids, one term a row) bit-equal, pushes
  with duplicate ids within rtol 1e-6 with atol 1e-6 of the largest row
  (the sums' order differs), pulls bit-equal. The reference's own
  device mode fuses its update into one multiply-add on XLA:CPU, so it
  is held to the second tolerance on both streams;
- the exactly-once fence, stale-map rejection and the padding sentinels;
- a replica of a device-mode primary, synced by full copy and by delta,
  bit-equal to it, and promoted with its watermark and fence;
- shard files cross-read between the packages, bit-exact;
- the client's `pull_unique`/`push` stats equal the reference's;
- `TierEmbedding` under every combiner, with and without `inverse`, and
  its gradient, against the reference's layer;
- three `EmbeddingTierSession` steps: losses within rtol 1e-6 and
  tables within atol 1e-6 of the largest row (the float32 sums' order
  differs between jnp and torch);
- `reshard.apply_moves` bit-exact with a live donor, with a dead donor
  restored from a checkpoint, and through the staged lane
  (`parallel.elastic.stage_leaf`/`reshard_state`);
- the `CompileCache` (counts, LRU, the store's programs found again);
- one pull and one push through the copied `GrpcTransport` between two
  in-process stores equal `LocalTransport`'s.

All in one collected test (ROADMAP.md, conventions).
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu.embedding import reshard as r_reshard
from elasticdl_tpu.embedding import sharding as r_sharding
from elasticdl_tpu.embedding import store as r_store
from elasticdl_tpu.embedding import tier as r_tier
from elasticdl_tpu.embedding import transport as r_transport
from elasticdl_tpu.training import compile_cache as r_cc
from elasticdl_tpu_torch.embedding import data_plane as dp
from elasticdl_tpu_torch.embedding import reshard, sharding, store, tier
from elasticdl_tpu_torch.embedding import transport
from elasticdl_tpu_torch.ops import placement
from elasticdl_tpu_torch.parallel import elastic
from elasticdl_tpu_torch.training import compile_cache as cc

SPEC = dict(name="users", vocab=4096, dim=8, seed=3)


class Pkg:
    """One package's tier modules."""

    def __init__(self, sharding_, store_, tier_, transport_, cc_, reshard_):
        self.sharding, self.store, self.tier = sharding_, store_, tier_
        self.transport, self.cc, self.reshard = transport_, cc_, reshard_

    def spec(self, **kw):
        return self.sharding.TableSpec(**dict(SPEC, **kw))


PORT = Pkg(sharding, store, tier, transport, cc, reshard)
REF = Pkg(r_sharding, r_store, r_tier, r_transport, r_cc, r_reshard)


def device_arg(pkg, mode):
    """The store's `device=` for host ("host") or device ("device") mode:
    the port's device mode on the CPU, the reference's on JAX's CPU."""
    if mode == "host":
        return False
    return "cpu" if pkg is PORT else True


def make_tier(pkg, num_shards, owners, mode, dedupe=True, specs=None):
    specs = specs or (pkg.spec(),)
    view = pkg.sharding.ShardMapView(
        version=1, num_shards=num_shards,
        owners=tuple(pkg.sharding.assign_round_robin(num_shards, owners)),
        tables=tuple(specs))
    tr = pkg.transport.LocalTransport()
    stores = {}
    for o in owners:
        st = pkg.store.EmbeddingShardStore(
            o, compile_cache=pkg.cc.CompileCache(),
            device=device_arg(pkg, mode))
        st.attach(view)
        tr.register(st)
        stores[o] = st
    client = pkg.tier.EmbeddingTierClient(
        lambda: view, tr, client_id="t0", dedupe=dedupe,
        retry_backoff_s=0.001)
    return view, tr, stores, client


def full_table(view, tr, spec):
    out = np.zeros((spec.vocab, spec.dim), np.float32)
    for s in range(view.num_shards):
        rows = tr.store_of(view.owners[s]).extract_shard(spec.name, s)["rows"]
        idx = np.arange(s, spec.vocab, view.num_shards)
        out[idx] = rows[: len(idx)]
    return out


def assert_close_of_max(got, want, rtol):
    """|got - want| <= rtol * max|want| + rtol * |want| everywhere."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


# ------------------------------------------------------------------ #


def case_init_shard_rows_bit_equal():
    for kw in ({}, {"name": "items", "seed": 11, "vocab": 1000},
               {"vocab": 262144, "dim": 32}):
        for n in (1, 3, 8):
            for s in range(n):
                a = store._init_shard_rows(PORT.spec(**kw), s, n)
                b = r_store._init_shard_rows(REF.spec(**kw), s, n)
                assert a.dtype == b.dtype == np.float32
                assert np.array_equal(a, b), (kw, s, n)


def push_stream(seed, deduped):
    """(ids, grads, scale) pushes: sorted unique ids (one term a row), or
    a raw stream with duplicates and padding sentinels."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(4):
        ids = r.randint(0, SPEC["vocab"], (96,))
        if deduped:
            ids = np.unique(ids)
        else:
            ids[:8] = ids[8]            # a hot id
            ids[9] = -1                 # a padding sentinel
        out.append((ids.astype(np.int64),
                    r.randn(ids.shape[0], SPEC["dim"]).astype(np.float32),
                    -0.05 * (i + 1)))
    return out


def case_store_pull_push_against_reference(monkeypatch):
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    r = np.random.RandomState(0)
    pull_ids = r.randint(-2, SPEC["vocab"] + 5, (64, 3))
    for deduped in (True, False):
        tables = {}
        for pkg in (PORT, REF):
            for mode in ("host", "device"):
                view, tr, stores, client = make_tier(
                    pkg, 4, [0, 1], mode, dedupe=False)
                for ids, g, scale in push_stream(1, deduped):
                    client.push("users", ids, g, scale=scale)
                spec = view.tables[0]
                tables[pkg is PORT, mode] = (
                    full_table(view, tr, spec), client.pull("users", pull_ids))
                if pkg is PORT and mode == "device":
                    st = stores[0]
                    assert isinstance(
                        st._shards[("users", 0)].rows, torch.Tensor)
        want, want_pull = tables[False, "host"]
        for key, (got, got_pull) in tables.items():
            if deduped and key != (False, "device"):
                assert np.array_equal(got, want), (key, deduped)
            else:
                # duplicate ids: the sums' order differs. The reference's
                # device mode on XLA:CPU also contracts `tab + scale *
                # delta` into one fused multiply-add (one rounding where
                # its host mode and the port have two; ROADMAP queue 3)
                assert_close_of_max(got, want, 1e-6)
            # a pull reads the table as it stands: bit-equal to a gather
            # of this package's own table (zeros for sentinels)
            flat = pull_ids.reshape(-1)
            ok = (flat >= 0) & (flat < SPEC["vocab"])
            ref_rows = np.where(ok[:, None], got[np.where(ok, flat, 0)], 0)
            assert np.array_equal(got_pull.reshape(-1, 8), ref_rows), key


def case_fence_stale_map_and_sentinels():
    for pkg in (PORT, REF):
        for mode in ("host", "device"):
            view, tr, stores, _ = make_tier(pkg, 2, [0], mode)
            st = stores[0]
            ids = np.array([1, 2], np.int32)
            rows = np.ones((2, 8), np.float32)
            assert st.push("users", 0, ids, rows, client_id="c", seq=1) is True
            before = st.extract_shard("users", 0)["rows"].copy()
            assert st.push("users", 0, ids, rows, client_id="c", seq=1) is False
            assert st.push("users", 0, ids, rows, client_id="c", seq=0) is False
            assert np.array_equal(st.extract_shard("users", 0)["rows"], before)
            assert st.push("users", 0, ids, rows, client_id="c2", seq=1) is True
            with pytest.raises(pkg.store.StaleShardMapError):
                st.pull("users", 0, np.array([0], np.int32), map_version=99)
            with pytest.raises(pkg.store.StaleShardMapError):
                st.pull("users", 77, np.array([0], np.int32), map_version=1)
            before = st.extract_shard("users", 1)["rows"].copy()
            got = st.pull("users", 1, np.array([-1, 0, 10 ** 6], np.int32),
                          map_version=1)
            assert np.all(got[0] == 0) and np.all(got[2] == 0)
            assert np.array_equal(got[1], before[0])
            st.push("users", 1, np.array([-1, 3, 10 ** 6], np.int32),
                    np.ones((3, 8), np.float32), client_id="c", seq=2)
            after = st.extract_shard("users", 1)["rows"]
            assert np.array_equal(after[3], before[3] + np.float32(1.0))
            assert int((np.abs(after - before).sum(axis=1) > 0).sum()) == 1


def case_replica_sync_and_promotion():
    """A replica of a device-mode primary (in either mode) syncs by full
    copy, then by delta, to the primary's rows bit for bit, and is
    promoted with its watermark and fence."""
    spec = PORT.spec()
    view = sharding.ShardMapView(version=1, num_shards=2, owners=(0, 0),
                                 tables=(spec,), replicas=((1,), (1,)))
    for replica_mode in ("cpu", False):
        primary = store.EmbeddingShardStore(0, device="cpu")
        replica = store.EmbeddingShardStore(1, device=replica_mode)
        tr = transport.LocalTransport()
        for st in (primary, replica):
            st.attach(view)
            tr.register(st)
        primary.set_delta_logging(True)
        r = np.random.RandomState(8)
        for seq in range(1, 4):
            for s in (0, 1):
                ids = np.full((256,), -1, np.int32)
                ids[:40] = np.unique(r.randint(0, 2048, 60))[:40]
                primary.push("users", s, ids,
                             r.randn(256, 8).astype(np.float32),
                             client_id="c", seq=seq, scale=-0.1)
                replica.sync_replica_from(tr, 0, "users", s)
        for s in (0, 1):
            want = primary.extract_shard("users", s)
            got = replica.extract_shard("users", s, replica=True)
            assert np.array_equal(got["rows"], want["rows"])
            assert got["wm"] == want["wm"] == 3
        assert replica.promote_replica("users", 0) == 3
        assert replica.push("users", 0, np.array([0], np.int32),
                            np.ones((1, 8), np.float32), client_id="c",
                            seq=3) is False


def case_shard_files_cross_read(tmp_path):
    r = np.random.RandomState(3)
    payload = {"rows": r.rand(16, 8).astype(np.float32),
               "applied": {"w1": 12, "w2": 7}, "wm": 5}
    for writer, reader, sub in ((store, r_store, "a"), (r_store, store, "b")):
        d = str(tmp_path / sub)
        path = writer.save_shard_file(d, "users", 3, payload)
        assert path.endswith("emb/users-shard00003.npz")
        got = reader.load_shard_file(d, "users", 3)
        assert np.array_equal(got["rows"], payload["rows"])
        assert got["applied"] == payload["applied"] and got["wm"] == 5
        assert reader.peek_shard_watermark(d, "users", 3) == 5
    # a device-mode store's drain, read back by the reference's restore
    view, tr, stores, client = make_tier(PORT, 4, [0, 1], "device")
    client.push("users", np.arange(64), np.ones((64, 8), np.float32),
                scale=0.25)
    before = full_table(view, tr, view.tables[0])
    d = str(tmp_path / "tier")
    from elasticdl_tpu_torch.training.checkpoint import CheckpointManager

    mngr = CheckpointManager(d)
    assert sum(mngr.save_embedding_tier(st) for st in stores.values()) == 4
    rview = REF.sharding.ShardMapView(
        version=1, num_shards=4, owners=(5, 5, 5, 5), tables=(REF.spec(),))
    rst = r_store.EmbeddingShardStore(5, device=False)
    rst.attach(rview, checkpoint_dir=d)
    rtr = r_transport.LocalTransport()
    rtr.register(rst)
    assert np.array_equal(full_table(rview, rtr, rview.tables[0]), before)
    # and a fresh port store restores through the manager
    pst = store.EmbeddingShardStore(6, device="cpu")
    pst.attach(sharding.ShardMapView(version=1, num_shards=4,
                                     owners=(7, 7, 7, 7),
                                     tables=(PORT.spec(),)))
    pst._num_shards = 4
    assert mngr.restore_embedding_tier(pst) == 4
    assert all(np.array_equal(
        pst.extract_shard("users", s)["rows"],
        rst.extract_shard("users", s)["rows"]) for s in range(4))
    mngr.close()


def case_client_dedupe_stats(monkeypatch):
    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    r = np.random.RandomState(5)
    ids = (r.zipf(1.3, (128, 4)) % SPEC["vocab"]).astype(np.int64)
    ids[0, :2] = -1
    results = {}
    for pkg in (PORT, REF):
        view, tr, stores, client = make_tier(pkg, 4, [0, 1], "device")
        rows, inverse, uniq = client.pull_unique("users", ids)
        g = rows * np.float32(0.1)
        stats = client.push("users", uniq, g, scale=-0.5)
        raw = client.push("users", ids, np.ones(ids.shape + (8,),
                                                 np.float32), scale=0.01)
        results[pkg is PORT] = (rows, inverse, uniq, stats, raw,
                                full_table(view, tr, view.tables[0]))
    port, ref = results[True], results[False]
    for a, b in zip(port[:3], ref[:3]):
        assert np.array_equal(a, b)
    assert port[3] == ref[3] and port[4] == ref[4]
    assert port[3]["ids_sent"] == int((ref[2] >= 0).sum())
    # the reference's device-mode update is one fused multiply-add
    assert_close_of_max(port[5], ref[5], 1e-6)


def case_tier_embedding_layers():
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.api.layers import TierEmbedding as RTier
    from elasticdl_tpu_torch.api.layers import TierEmbedding, tier_table_spec
    from elasticdl_tpu_torch.ops import embedding as emb_ops

    r = np.random.RandomState(0)
    ids = np.array([[1, 2, -1], [3, -1, -1], [2, 2, 1]], np.int32)
    vecs = r.rand(3, 3, 8).astype(np.float32)
    uniq_vecs = r.rand(4, 8).astype(np.float32)
    inverse = np.array([[0, 1, 3], [2, 3, 3], [1, 1, 0]], np.int64)
    w = r.rand(3, 3).astype(np.float32)
    for combiner in (None, "sum", "mean", "sqrtn"):
        layer, rlayer = TierEmbedding(8, combiner), RTier(8, combiner)
        got = layer(torch.from_numpy(vecs), torch.from_numpy(ids))
        want = rlayer.apply({}, jnp.asarray(vecs), jnp.asarray(ids))
        assert np.allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                           atol=1e-7), combiner
        got = layer(torch.from_numpy(vecs), torch.from_numpy(ids),
                    weights=torch.from_numpy(w))
        want = rlayer.apply({}, jnp.asarray(vecs), jnp.asarray(ids),
                            jnp.asarray(w))
        assert np.allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                           atol=1e-7), combiner
        # deduped shape: the gradient w.r.t. the unique rows
        leaf = torch.from_numpy(uniq_vecs).requires_grad_(True)
        out = layer(leaf, torch.from_numpy(ids),
                    inverse=torch.from_numpy(inverse))
        (out ** 2).sum().backward()

        def loss(v):
            return jnp.sum(rlayer.apply({}, v, jnp.asarray(ids),
                                        inverse=jnp.asarray(inverse)) ** 2)

        want_g = np.asarray(jax.grad(loss)(jnp.asarray(uniq_vecs)))
        assert np.allclose(leaf.grad.numpy(), want_g, rtol=1e-6,
                           atol=1e-6 * np.abs(want_g).max()), combiner
    # the inverse gather's backward is K1's placement: rerun bit-equal
    grads = []
    for _ in range(2):
        leaf = torch.from_numpy(uniq_vecs).requires_grad_(True)
        TierEmbedding(8, "sum")(leaf, torch.from_numpy(ids),
                                inverse=torch.from_numpy(inverse)).sum().backward()
        grads.append(leaf.grad)
    assert torch.equal(grads[0], grads[1])
    spec = tier_table_spec("users", 1000, 16)
    assert spec.vocab == emb_ops.padded_vocab(1000) and spec.dim == 16


def case_session_steps(monkeypatch):
    import jax.numpy as jnp

    from elasticdl_tpu.api.layers import TierEmbedding as RTier
    from elasticdl_tpu_torch.api.layers import TierEmbedding

    monkeypatch.setenv("EDL_EMB_SCATTER", "sorted")
    r = np.random.RandomState(9)
    batches = [{"cat": (r.zipf(1.5, (16, 3)) % SPEC["vocab"]).astype(np.int64),
                "y": r.rand(16).astype(np.float32)} for _ in range(3)]
    layer, rlayer = TierEmbedding(8, "sum"), RTier(8, "sum")

    def port_loss(vectors, inverses, batch):
        pooled = layer(vectors["users"], batch["cat"],
                       inverse=inverses["users"])
        return ((pooled.sum(-1) - batch["y"]) ** 2).sum()

    def ref_loss(vectors, inverses, batch):
        pooled = rlayer.apply({}, vectors["users"],
                              jnp.asarray(batch["cat"], jnp.int32),
                              inverse=inverses["users"])
        return jnp.sum((pooled.sum(-1) - batch["y"]) ** 2)

    out = {}
    for pkg, loss_fn, kw in ((PORT, port_loss, {"device": "cpu"}),
                             (REF, ref_loss, {})):
        view, tr, stores, client = make_tier(pkg, 4, [0, 1], "device")
        session = pkg.tier.EmbeddingTierSession(
            client, {"users": "cat"}, compile_cache=pkg.cc.CompileCache(),
            **kw)
        # three steps, then the first batch again: its shapes find the
        # gradient function already built
        losses = [session.step(loss_fn, b, lr=0.1)[0]
                  for b in batches + batches[:1]]
        out[pkg is PORT] = (losses, full_table(view, tr, view.tables[0]),
                            session)
    (pl, pt, psess), (rl, rt, _) = out[True], out[False]
    assert np.allclose(pl, rl, rtol=1e-6), (pl, rl)
    assert_close_of_max(pt, rt, 1e-6)
    # one gradient function a (vectors, batch) shape, found again
    stats = psess._cache.stats()
    assert stats["misses"] + stats["hits"] == 4 and stats["hits"] >= 1


def case_apply_moves_bit_exact(tmp_path):
    spec = PORT.spec()
    for mode in ("host", "device"):
        # live donor (and the staged lane onto the recipient's device)
        for lane in (None, torch.device("cpu")):
            view, tr, stores, client = make_tier(PORT, 8, [0, 1, 2], mode)
            r = np.random.RandomState(1)
            ids = r.randint(0, SPEC["vocab"], 256)
            client.push("users", ids, r.rand(256, 8).astype(np.float32),
                        scale=-0.1)
            before = full_table(view, tr, spec)
            moves = sharding.plan_moves(list(view.owners), [0, 1])
            view2 = sharding.ShardMapView(
                version=2, num_shards=8, tables=(spec,),
                owners=tuple(sharding.apply_moves_to_assignment(
                    view.owners, moves)))
            confirmed = []
            stats = reshard.apply_moves(
                view2, moves, tr, mesh=lane,
                confirm=lambda v, s: confirmed.append((v, list(s))))
            assert stats["payloads_transferred"] == len(moves)
            assert confirmed == [(2, [m.shard for m in moves])]
            assert np.array_equal(full_table(view2, tr, spec), before)
            assert stores[2].resident_shards() == []
            assert stores[0].map_version == stores[1].map_version == 2
        # dead donor restored from its drained checkpoint
        view, tr, stores, client = make_tier(PORT, 4, [0, 1], mode)
        r = np.random.RandomState(2)
        ids = r.randint(0, SPEC["vocab"], 128)
        client.push("users", ids, r.rand(128, 8).astype(np.float32),
                    scale=-0.1)
        before = full_table(view, tr, spec)
        d = str(tmp_path / mode)
        assert reshard.drain_to_checkpoint(stores[1], d) == 2
        tr.deregister(1)
        moves = sharding.plan_moves(list(view.owners), [0], dead=[1])
        view2 = sharding.ShardMapView(
            version=2, num_shards=4, tables=(spec,),
            owners=tuple(sharding.apply_moves_to_assignment(
                view.owners, moves)))
        stats = reshard.apply_moves(view2, moves, tr, checkpoint_dir=d)
        assert stats["payloads_restored"] == len(moves)
        assert np.array_equal(full_table(view2, tr, spec), before)
    # the staged lane itself
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    staged = elastic.stage_leaf(t)
    assert isinstance(staged.array, np.ndarray) and staged.spec == ()
    back = elastic.reshard_state({"a": staged, "b": [t]}, "cpu")
    assert torch.equal(back["a"], t) and back["b"][0] is t


def case_compile_cache():
    c = cc.CompileCache(max_entries=2)
    built = []
    for key in ("a", "a", "b", "c", "a"):
        c.get_or_build((key,), lambda k=key: built.append(k) or k)
    assert built == ["a", "b", "c", "a"]        # "a" evicted by "c"
    s = c.stats()
    assert (s["hits"], s["misses"], s["entries"]) == (1, 4, 2)
    assert s["hit_rate"] == 0.2
    assert c.peek(("c",)) == "c" and c.peek(("zz",)) is None
    assert c.stats()["hits"] == 1          # peek does not count
    c.reset_stats()
    assert c.stats()["misses"] == 0
    # the store's programs: one pull and one push program a (shape, n)
    own = cc.CompileCache()
    st = store.EmbeddingShardStore(0, compile_cache=own, device="cpu")
    st.attach(sharding.ShardMapView(version=1, num_shards=2, owners=(0, 0),
                                    tables=(PORT.spec(),)))
    ids = np.full((256,), -1, np.int32)
    ids[:3] = [1, 2, 3]
    for seq in range(1, 4):
        st.pull("users", seq % 2, ids)
        st.push("users", seq % 2, ids, np.ones((256, 8), np.float32),
                client_id="c", seq=seq)
    assert own.stats()["misses"] == 2 and own.stats()["hits"] == 4
    assert cc.aval_signature({"b": np.zeros((2, 3)), "a": torch.zeros(4)}) == (
        ((4,), "torch.float32", "cpu"), ((2, 3), "float64", "cpu"))
    assert cc.mesh_fingerprint(None) == ((), (), ())
    with pytest.raises(NotImplementedError, match="item 19"):
        cc.SpeculativeCompiler(lambda s: None, 2)


def case_grpc_transport_equals_local():
    spec = PORT.spec()
    view = sharding.ShardMapView(version=1, num_shards=2, owners=(0, 1),
                                 tables=(spec,))
    stores = {o: store.EmbeddingShardStore(o, device="cpu") for o in (0, 1)}
    servers, addrs = {}, {}
    for o, st in stores.items():
        st.attach(view)
        servers[o] = dp.EmbeddingDataServer(st)
        addrs[o] = f"127.0.0.1:{servers[o].start()}"
    twins = {o: store.EmbeddingShardStore(o, device="cpu") for o in (0, 1)}
    local = transport.LocalTransport()
    for st in twins.values():
        st.attach(view)
        local.register(st)
    grpc_tr = dp.GrpcTransport(addrs)
    try:
        ids = np.array([0, 2, 4, -1], np.int32)
        g = np.arange(32, dtype=np.float32).reshape(4, 8)
        for o in (0, 1):
            a = grpc_tr.pull(o, "users", o, ids, map_version=1,
                             with_watermark=True)
            b = local.pull(o, "users", o, ids, map_version=1,
                           with_watermark=True)
            assert a[1] == b[1] and np.array_equal(a[0], b[0])
            a = grpc_tr.push(o, "users", o, ids, g, client_id="c", seq=1,
                             map_version=1, scale=-0.5, with_watermark=True)
            b = local.push(o, "users", o, ids, g, client_id="c", seq=1,
                           map_version=1, scale=-0.5, with_watermark=True)
            assert a == b == (True, 1)
            assert np.array_equal(stores[o].extract_shard("users", o)["rows"],
                                  twins[o].extract_shard("users", o)["rows"])
    finally:
        grpc_tr.close()
        for srv in servers.values():
            srv.stop()


def test_embedding_tier_against_reference(tmp_path, monkeypatch):
    """Every case above, in one collected test (ROADMAP.md, conventions:
    one collected test per port test file)."""
    placement.launches = 0
    case_init_shard_rows_bit_equal()
    case_store_pull_push_against_reference(monkeypatch)
    case_fence_stale_map_and_sentinels()
    case_replica_sync_and_promotion()
    case_shard_files_cross_read(tmp_path)
    case_client_dedupe_stats(monkeypatch)
    case_tier_embedding_layers()
    case_session_steps(monkeypatch)
    case_apply_moves_bit_exact(tmp_path)
    case_compile_cache()
    case_grpc_transport_equals_local()
    # every device-mode push above ran on CPU tensors: K1's plain version
    assert placement.launches == 0
