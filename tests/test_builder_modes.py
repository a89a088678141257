"""Builder mode tests: key-range batching, --on-disk external merge,
--keep-positions, --merge-branches, ghost strategies.

Invariant: every mode decomposition (batches, on-disk) must produce the exact
same database as the plain in-RAM build.
"""

import os

import numpy as np
import pytest

from ipk_tpu import serialize
from ipk_tpu.pipeline import BuildParams, build_database
from ipk_tpu.seq import AA, DNA

from fixtures import make_project


@pytest.fixture(scope="module")
def dna_project(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("modes")
    return tmp, *make_project(tmp, num_leaves=6, width=25, seed=21)


def build_with(tmp, tree_file, fasta_file, ar_dir, name, **overrides):
    out = str(tmp / f"{name}.ipk")
    params = BuildParams(
        refalign=fasta_file, reftree=tree_file, states="nucl",
        working_dir=str(tmp / f"wd_{name}"), ar_dir=ar_dir, kmer_size=5,
        omega=1.5, output_filename=out, verbosity=0)
    for key, val in overrides.items():
        setattr(params, key, val)
    build_database(params)
    return out


def assert_db_equal(f1, f2):
    a, b = serialize.load(f1), serialize.load(f2)
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.filter_values, b.filter_values)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.branches, b.branches)
    np.testing.assert_array_equal(a.scores, b.scores)


def test_key_batches_invariance(dna_project, monkeypatch):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    base = build_with(tmp, tree_file, fasta_file, ar_dir, "base")
    # force 4 key batches through the builder
    import ipk_tpu.builder as builder_mod
    monkeypatch.setattr(builder_mod, "pick_key_batches",
                        lambda *a, **k: 4)
    batched = build_with(tmp, tree_file, fasta_file, ar_dir, "batched")
    assert_db_equal(base, batched)


def test_on_disk_equals_in_ram(dna_project):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    base = build_with(tmp, tree_file, fasta_file, ar_dir, "ram")
    ondisk = build_with(tmp, tree_file, fasta_file, ar_dir, "disk",
                        on_disk=True)
    assert_db_equal(base, ondisk)
    # temp hashmaps dir removed after the build (db_builder.cpp:213)
    assert not os.path.exists(str(tmp / "wd_disk" / "hashmaps"))


def test_on_disk_with_batches(dna_project, monkeypatch):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    base = build_with(tmp, tree_file, fasta_file, ar_dir, "ram2")
    import ipk_tpu.builder as builder_mod
    monkeypatch.setattr(builder_mod, "pick_key_batches", lambda *a, **k: 4)
    ondisk = build_with(tmp, tree_file, fasta_file, ar_dir, "disk2",
                        on_disk=True)
    assert_db_equal(base, ondisk)


def test_merge_branches(dna_project):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    out = build_with(tmp, tree_file, fasta_file, ar_dir, "merged",
                     merge_branches=True)
    db = serialize.load(out)
    # exactly one entry (the max-scoring branch) per k-mer
    assert (np.diff(db.offsets) == 1).all()
    full = serialize.load(build_with(tmp, tree_file, fasta_file, ar_dir,
                                     "full"))
    # merged scores = per-key max over the full DB's entries
    full_max = {}
    for key, entries in full:
        full_max[key] = max(s for _, s in entries)
    for key, entries in db:
        assert np.float32(entries[0][1]) == np.float32(full_max[key])


def test_ghost_strategies(dna_project):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    both = serialize.load(build_with(tmp, tree_file, fasta_file, ar_dir,
                                     "both", ghosts="both"))
    inner = serialize.load(build_with(tmp, tree_file, fasta_file, ar_dir,
                                      "inner", ghosts="inner-only"))
    outer = serialize.load(build_with(tmp, tree_file, fasta_file, ar_dir,
                                      "outer", ghosts="outer-only"))
    # "both" takes the max over X0/X1, so per-(key, branch) its score equals
    # max(inner, outer) wherever both exist
    def to_map(db):
        return {(key, b): s for key, entries in db for b, s in entries}
    m_both, m_in, m_out = to_map(both), to_map(inner), to_map(outer)
    assert set(m_both) == set(m_in) | set(m_out)
    for kb, s in m_both.items():
        expect = max(m_in.get(kb, -np.inf), m_out.get(kb, -np.inf))
        assert np.float32(s) == np.float32(expect)


def test_keep_positions_amino(tmp_path):
    from fixtures import make_project
    tree_file, fasta_file, ar_dir = make_project(
        tmp_path, num_leaves=5, width=15, seed=5, traits=AA)
    out = str(tmp_path / "pos.ipk")
    params = BuildParams(
        refalign=fasta_file, reftree=tree_file, states="amino",
        working_dir=str(tmp_path / "wdp"), ar_dir=ar_dir, kmer_size=3,
        omega=4.0, output_filename=out, keep_positions=True, verbosity=0)
    result = build_database(params)
    assert result.db.positions is not None
    loaded = serialize.load(out)
    assert loaded.positions is not None
    np.testing.assert_array_equal(loaded.positions, result.db.positions)
    # positions are valid window starts: 0 <= pos <= S - k
    assert loaded.positions.max() <= 15 - 3
    # scores identical to the non-positions build
    plain = BuildParams(**{**params.__dict__, "keep_positions": False,
                           "working_dir": str(tmp_path / "wdq"),
                           "output_filename": str(tmp_path / "plain.ipk")})
    build_database(plain)
    p = serialize.load(str(tmp_path / "plain.ipk"))
    np.testing.assert_array_equal(loaded.keys, p.keys)
    np.testing.assert_array_equal(loaded.scores, p.scores)


def test_positions_earliest_window_tiebreak(tmp_path):
    """A constant matrix gives equal scores in every window: the stored
    position must be the earliest window (strict-greater put semantics)."""
    import ipk_tpu.builder as b
    from ipk_tpu.core import dense
    P = np.full((2, 10, 4), np.log10(0.25), dtype=np.float32)
    prefix = dense.best_score_prefix(P)
    eps = b.log_threshold_f32(0.9, 4, 2)  # strictly below the constant score
    L, R = None, None
    batches = list(b._enumerate_batches(
        P, prefix, k=2, sigma=4, eps=eps, ghosts_per_group=2,
        key_batches=1, backend="jnp", block_w=4, keep_positions=True))
    tag, lo, A, pos, count = batches[0]
    assert tag == "dense"
    surv = np.isfinite(A)
    assert surv.any()
    assert (pos[surv] == 0).all()


def test_on_disk_rejects_positions(tmp_path):
    from fixtures import make_project
    tree_file, fasta_file, ar_dir = make_project(
        tmp_path, num_leaves=4, width=12, seed=6, traits=AA)
    params = BuildParams(
        refalign=fasta_file, reftree=tree_file, states="amino",
        working_dir=str(tmp_path / "wd"), ar_dir=ar_dir, kmer_size=3,
        omega=4.0, output_filename=str(tmp_path / "x.ipk"),
        keep_positions=True, on_disk=True, verbosity=0)
    with pytest.raises(RuntimeError, match="Positions are not supported"):
        build_database(params)


def test_sparse_path_equals_dense(dna_project, monkeypatch):
    """Forced sparse (large-k) path produces a byte-identical DB."""
    tmp, tree_file, fasta_file, ar_dir = dna_project
    base = build_with(tmp, tree_file, fasta_file, ar_dir, "dense_ref")
    import ipk_tpu.builder as bm
    # force the sparse path by dropping the dense threshold
    monkeypatch.setattr(bm, "MAX_DENSE_KEYSPACE", 1)
    sparse = build_with(tmp, tree_file, fasta_file, ar_dir, "sparse_run")
    with open(base, "rb") as f1, open(sparse, "rb") as f2:
        assert f1.read() == f2.read()


def test_sparse_on_disk(dna_project, monkeypatch):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    base = build_with(tmp, tree_file, fasta_file, ar_dir, "dense_ref2")
    import ipk_tpu.builder as bm
    monkeypatch.setattr(bm, "MAX_DENSE_KEYSPACE", 1)
    sparse = build_with(tmp, tree_file, fasta_file, ar_dir, "sparse_disk",
                        on_disk=True)
    assert_db_equal(base, sparse)


def test_sparse_overflow_raises(dna_project, monkeypatch):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    import ipk_tpu.builder as bm
    monkeypatch.setattr(bm, "MAX_DENSE_KEYSPACE", 1)
    with pytest.raises(RuntimeError, match="capacity"):
        params = BuildParams(
            refalign=fasta_file, reftree=tree_file, states="nucl",
            working_dir=str(tmp / "wd_ovf"), ar_dir=ar_dir, kmer_size=5,
            omega=0.01, max_candidates=8,
            output_filename=str(tmp / "ovf.ipk"), verbosity=0)
        build_database(params)


def test_sparse_random_filter_and_merge_branches(dna_project, monkeypatch):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    import ipk_tpu.builder as bm
    base_r = build_with(tmp, tree_file, fasta_file, ar_dir, "rand_dense",
                        filter="random")
    base_m = build_with(tmp, tree_file, fasta_file, ar_dir, "mb_dense",
                        merge_branches=True)
    monkeypatch.setattr(bm, "MAX_DENSE_KEYSPACE", 1)
    sp_r = build_with(tmp, tree_file, fasta_file, ar_dir, "rand_sparse",
                      filter="random")
    sp_m = build_with(tmp, tree_file, fasta_file, ar_dir, "mb_sparse",
                      merge_branches=True)
    assert_db_equal(base_r, sp_r)
    assert_db_equal(base_m, sp_m)


# ---------------------------------------------------------------------------
# r2: every production path shards over the mesh; results must be byte-equal
# to the single-device build
# ---------------------------------------------------------------------------

def _build_pair(tmp, tree_file, fasta_file, ar_dir, name, monkeypatch,
                **overrides):
    monkeypatch.setenv("IPK_TPU_NO_SHARD", "1")
    single = build_with(tmp, tree_file, fasta_file, ar_dir,
                        name + "_1dev", **overrides)
    monkeypatch.delenv("IPK_TPU_NO_SHARD")
    sharded = build_with(tmp, tree_file, fasta_file, ar_dir,
                         name + "_mesh", **overrides)
    return single, sharded


def test_sharded_build_dense_equal(dna_project, monkeypatch):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    a, b = _build_pair(tmp, tree_file, fasta_file, ar_dir, "shd",
                       monkeypatch)
    assert_db_equal(a, b)


def test_sharded_build_batched_equal(dna_project, monkeypatch):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    import ipk_tpu.builder as builder_mod
    monkeypatch.setattr(builder_mod, "pick_key_batches", lambda *a, **k: 4)
    a, b = _build_pair(tmp, tree_file, fasta_file, ar_dir, "shb",
                       monkeypatch)
    assert_db_equal(a, b)


@pytest.mark.parametrize("key_batches", [1, 4])
def test_sharded_build_triton_equal(dna_project, monkeypatch, key_batches):
    """The Triton combine (interpret mode here; compiled on the card) under
    the builder's shard_map over the 8-device mesh and on one device: both
    byte-equal to the plain XLA build."""
    import functools
    import ipk_tpu.builder as builder_mod
    import ipk_tpu.core.pallas_kernels as pk
    tmp, tree_file, fasta_file, ar_dir = dna_project
    monkeypatch.setattr(builder_mod, "pick_key_batches",
                        lambda *a, **k: key_batches)
    base = build_with(tmp, tree_file, fasta_file, ar_dir,
                      f"tri_base{key_batches}")
    monkeypatch.setattr(builder_mod, "choose_backend", lambda: "triton")
    monkeypatch.setattr(pk, "combine_max",
                        functools.partial(pk.combine_max, interpret=True))
    a, b = _build_pair(tmp, tree_file, fasta_file, ar_dir,
                       f"tri{key_batches}", monkeypatch)
    assert_db_equal(base, a)
    assert_db_equal(base, b)


def test_sharded_build_sparse_equal(dna_project, monkeypatch):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    import ipk_tpu.builder as builder_mod
    monkeypatch.setattr(builder_mod, "MAX_DENSE_KEYSPACE", 1)
    a, b = _build_pair(tmp, tree_file, fasta_file, ar_dir, "shs",
                       monkeypatch)
    assert_db_equal(a, b)


def test_sharded_build_positions_equal(dna_project, monkeypatch):
    tmp, tree_file, fasta_file, ar_dir = dna_project
    a, b = _build_pair(tmp, tree_file, fasta_file, ar_dir, "shp",
                       monkeypatch, keep_positions=True)
    pa, pb = serialize.load(a), serialize.load(b)
    assert_db_equal(a, b)
    np.testing.assert_array_equal(pa.positions, pb.positions)


def test_device_mi_build(dna_project):
    """--device-mi: the MI filter runs on device (f32 collective psums,
    build_sharded._local_step) instead of the host f64 pass. Content must be
    identical (keys, entries, scores); filter values agree to f32 accuracy
    and only the serialization ORDER may differ where f32 rounding flips
    near-equal values."""
    tmp, tree_file, fasta_file, ar_dir = dna_project
    host = serialize.load(build_with(tmp, tree_file, fasta_file, ar_dir,
                                     "mi_host"))
    dev = serialize.load(build_with(tmp, tree_file, fasta_file, ar_dir,
                                    "mi_dev", device_mi=True))
    assert set(host.keys.tolist()) == set(dev.keys.tolist())

    def content(db):
        out = {}
        for i, key in enumerate(db.keys.tolist()):
            lo, hi = db.offsets[i], db.offsets[i + 1]
            out[key] = (db.branches[lo:hi].tolist(),
                        db.scores[lo:hi].tolist(),
                        db.filter_values[i])
        return out
    ch, cd = content(host), content(dev)
    for key in ch:
        assert ch[key][0] == cd[key][0], key
        assert ch[key][1] == cd[key][1], key
        np.testing.assert_allclose(cd[key][2], ch[key][2], rtol=2e-5,
                                   atol=1e-7)


def test_device_mi_build_multibatch(dna_project, monkeypatch):
    """--device-mi with key_batches > 1: mif0 is
    per-key separable, so the per-batch collective reduction must produce
    the same DB content as the host-f64 build, batch decomposition
    notwithstanding."""
    import ipk_tpu.builder as builder_mod
    monkeypatch.setattr(builder_mod, "pick_key_batches", lambda *a, **k: 4)
    tmp, tree_file, fasta_file, ar_dir = dna_project
    host = serialize.load(build_with(tmp, tree_file, fasta_file, ar_dir,
                                     "mib_host"))
    dev = serialize.load(build_with(tmp, tree_file, fasta_file, ar_dir,
                                    "mib_dev", device_mi=True))
    assert set(host.keys.tolist()) == set(dev.keys.tolist())
    hidx = {k: i for i, k in enumerate(host.keys.tolist())}
    for i, key in enumerate(dev.keys.tolist()):
        j = hidx[key]
        lo, hi = dev.offsets[i], dev.offsets[i + 1]
        hlo, hhi = host.offsets[j], host.offsets[j + 1]
        np.testing.assert_array_equal(dev.branches[lo:hi],
                                      host.branches[hlo:hhi])
        np.testing.assert_array_equal(dev.scores[lo:hi],
                                      host.scores[hlo:hhi])
        np.testing.assert_allclose(dev.filter_values[i],
                                   host.filter_values[j], rtol=2e-5,
                                   atol=1e-7)


def test_device_merge_overflow_reuses_enumeration(dna_project, monkeypatch):
    """When the device key merge hits a bucket overflow, the builder must
    fall back to the host merge REUSING the already-completed enumeration
    — not re-run stage 1 — and produce the identical DB."""
    import ipk_tpu.builder as builder_mod
    from ipk_tpu.parallel import key_merge as km
    tmp, tree_file, fasta_file, ar_dir = dna_project
    monkeypatch.setattr(builder_mod, "MAX_DENSE_KEYSPACE", 1)  # force sparse
    ref = build_with(tmp, tree_file, fasta_file, ar_dir, "ovf_ref")

    def blown(*a, **kw):
        raise km.KeyMergeOverflow("forced bucket overflow (test)")
    monkeypatch.setattr(km, "device_key_merge", blown)

    def no_rerun(*a, **kw):
        raise AssertionError("stage 1 was re-run instead of reused")
    monkeypatch.setattr(builder_mod, "_enumerate_sparse_branches", no_rerun)
    got = build_with(tmp, tree_file, fasta_file, ar_dir, "ovf_got")
    assert_db_equal(ref, got)


def test_transfer_representations_equal(dna_project, monkeypatch):
    """The three device→host transfer representations (compact idx stream,
    packed survivor bitmask, raw dense tensor) must produce byte-identical
    databases — they only change how survivors cross the link."""
    tmp, tree_file, fasta_file, ar_dir = dna_project
    outs = []
    for rep in ("idx", "bitmask", "dense"):
        monkeypatch.setenv("IPK_TPU_TRANSFER", rep)
        outs.append(build_with(tmp, tree_file, fasta_file, ar_dir,
                               f"rep_{rep}"))
    monkeypatch.delenv("IPK_TPU_TRANSFER")
    assert_db_equal(outs[0], outs[1])
    assert_db_equal(outs[0], outs[2])


def test_bitmask_survivors_matches_compact():
    from ipk_tpu.core import dense
    rng = np.random.default_rng(5)
    A = rng.uniform(-4, 0, (7, 1003)).astype(np.float32)
    A[rng.random(A.shape) < 0.6] = -np.inf
    idx, sc = dense.compact_survivors(A)
    packed, sc_dev, n = dense.bitmask_survivors(A)
    assert n == len(idx)
    flat = np.unpackbits(np.asarray(packed))[:A.size]
    np.testing.assert_array_equal(np.flatnonzero(flat), idx)
    np.testing.assert_array_equal(np.asarray(sc_dev)[:n], sc)
    # all-pruned block
    A[:] = -np.inf
    packed, sc_dev, n = dense.bitmask_survivors(A)
    assert n == 0 and not np.unpackbits(np.asarray(packed)).any()


def test_build_timing_breakdown(dna_project):
    """build() records the measured wall-time breakdown the benchmark
    artifact's full_build rows report (r4 verdict item 1a)."""
    tmp, tree_file, fasta_file, ar_dir = dna_project
    from ipk_tpu.pipeline import BuildParams, build_database
    params = BuildParams(
        refalign=fasta_file, reftree=tree_file, states="nucl",
        working_dir=str(tmp / "wd_breakdown"), ar_dir=ar_dir, kmer_size=5,
        omega=1.5, output_filename=str(tmp / "breakdown.ipk"), verbosity=0)
    result = build_database(params)
    t = result.timings
    for key in ("computation", "filter_merge", "device_compute", "transfer",
                "transfer_bytes", "host_extract", "sort", "serialize"):
        assert key in t, key
    assert t["transfer_bytes"] > 0
    assert t["device_compute"] > 0 and t["computation"] >= 0


def test_device_merge_budget_boundary(dna_project, monkeypatch):
    """Pin the _DEVICE_MERGE_BUDGET_BYTES routing boundary (r4 verdict weak
    #8): a workload over the budget must route to the chunked host merge
    (loudly, via the fallback note) and still produce the identical DB; the
    same workload under the budget must use the device merge."""
    import ipk_tpu.builder as builder_mod
    from ipk_tpu.parallel import key_merge as km
    tmp, tree_file, fasta_file, ar_dir = dna_project
    monkeypatch.setattr(builder_mod, "MAX_DENSE_KEYSPACE", 1)  # force sparse

    used = []
    orig = km.device_key_merge
    def spy(*a, **kw):
        used.append(True)
        return orig(*a, **kw)
    monkeypatch.setattr(km, "device_key_merge", spy)

    # generous budget -> device merge runs
    monkeypatch.setattr(builder_mod, "_DEVICE_MERGE_BUDGET_BYTES", 1 << 40)
    dev = build_with(tmp, tree_file, fasta_file, ar_dir, "budget_dev")
    assert used, "device merge not used under a generous budget"

    # one-byte budget -> over_budget fires BEFORE enumeration; host merge
    used.clear()
    monkeypatch.setattr(builder_mod, "_DEVICE_MERGE_BUDGET_BYTES", 1)
    host = build_with(tmp, tree_file, fasta_file, ar_dir, "budget_host")
    assert not used, "device merge ran despite an exceeded budget"
    assert_db_equal(dev, host)


def test_device_mi_build_amino(tmp_path):
    """--device-mi on an AMINO dense build (k small enough for the dense
    path): the σ=20 mixed-radix key space must survive the on-device MI
    reduction and key batching exactly like DNA. Added after the r5
    bit-packed key-merge bug showed power-of-two DNA masking σ=20 issues."""
    tree_file, fasta_file, ar_dir = make_project(
        tmp_path, num_leaves=4, width=12, seed=77, traits=AA)

    def build_aa(name, **overrides):
        out = str(tmp_path / f"{name}.ipk")
        params = BuildParams(
            refalign=fasta_file, reftree=tree_file, states="amino",
            working_dir=str(tmp_path / f"wd_{name}"), ar_dir=ar_dir,
            kmer_size=3, omega=4.0, output_filename=out, verbosity=0)
        for key, val in overrides.items():
            setattr(params, key, val)
        build_database(params)
        return out

    host = serialize.load(build_aa("aa_mi_host"))
    dev = serialize.load(build_aa("aa_mi_dev", device_mi=True))
    assert host.size() > 0
    assert set(host.keys.tolist()) == set(dev.keys.tolist())

    def content(db):
        out = {}
        for i, key in enumerate(db.keys.tolist()):
            lo, hi = db.offsets[i], db.offsets[i + 1]
            out[key] = (db.branches[lo:hi].tolist(),
                        db.scores[lo:hi].tolist(), db.filter_values[i])
        return out
    ch, cd = content(host), content(dev)
    for key in ch:
        assert ch[key][0] == cd[key][0], key
        assert ch[key][1] == cd[key][1], key
        np.testing.assert_allclose(cd[key][2], ch[key][2], rtol=2e-5,
                                   atol=1e-7)
