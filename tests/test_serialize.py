

# ---------------------------------------------------------------------------
# out-of-core merge (r2): streaming BatchLoader + RAM-bounded k-way merge
# ---------------------------------------------------------------------------

def _make_batch_db(path, keys, fvs, counts, rng):
    from ipk_tpu.db import PhyloKmerDB
    from ipk_tpu import serialize
    import numpy as np
    E = int(counts.sum())
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    db = PhyloKmerDB(5, 1.5, "nucl", "(a,b)r;", [])
    db.set_data(keys.astype(np.uint64), fvs.astype(np.float32), offsets,
                rng.integers(0, 100, E).astype(np.uint32),
                rng.uniform(-4, 0, E).astype(np.float32), None)
    serialize.save(db, str(path), compressed=False)
    return db


def test_batch_loader_streams_blocks(tmp_path):
    import numpy as np
    from ipk_tpu import serialize
    rng = np.random.default_rng(3)
    K = 1000
    keys = np.sort(rng.choice(4 ** 5, K, replace=False)).astype(np.uint64)
    fvs = np.sort(rng.uniform(-1, 0, K)).astype(np.float32)
    counts = rng.integers(1, 6, K).astype(np.int64)
    db = _make_batch_db(tmp_path / "b.ipk", keys, fvs, counts, rng)

    loader = serialize.BatchLoader(str(tmp_path / "b.ipk"), block_rows=64)
    got_k, got_f, got_b, got_s = [], [], [], []
    while (blk := loader.read_block()) is not None:
        bk, bf, bc, bb, bs, bp = blk
        assert len(bk) <= 64
        got_k.append(bk); got_f.append(bf); got_b.append(bb); got_s.append(bs)
    loader.close()
    np.testing.assert_array_equal(np.concatenate(got_k), db.keys)
    np.testing.assert_array_equal(np.concatenate(got_f), db.filter_values)
    np.testing.assert_array_equal(np.concatenate(got_b), db.branches)
    np.testing.assert_array_equal(np.concatenate(got_s), db.scores)


def test_out_of_core_merge_bounded(tmp_path):
    """The merged output must equal a monolithic sort while the merge holds
    only O(block_rows x batches) rows resident."""
    import numpy as np
    from ipk_tpu import serialize
    from ipk_tpu.builder import _merge_on_disk
    from ipk_tpu.db import PhyloKmerDB

    rng = np.random.default_rng(11)
    n_batches, K = 4, 5000
    # key-disjoint batches, each sorted ascending by (fv, key)
    all_keys = rng.permutation(4 ** 9)[:n_batches * K].astype(np.uint64)
    files, ref_rows = [], []
    for b in range(n_batches):
        keys = all_keys[b * K:(b + 1) * K]
        fvs = rng.uniform(-1, 0, K).astype(np.float32)
        order = np.lexsort((keys, fvs))
        keys, fvs = keys[order], fvs[order]
        counts = rng.integers(1, 4, K).astype(np.int64)
        path = tmp_path / f"batch{b}.ipk"
        db = _make_batch_db(path, keys, fvs, counts, rng)
        files.append(str(path))
        ref_rows.append((keys, fvs, db))

    header_db = PhyloKmerDB(5, 1.5, "nucl", "(a,b)r;", [])
    out = str(tmp_path / "merged.ipk")

    # instrument the loader to prove the block bound is respected
    max_block = 0
    orig = serialize.BatchLoader.read_block
    def counting(self, max_rows=None):
        nonlocal max_block
        blk = orig(self, max_rows)
        if blk is not None:
            max_block = max(max_block, len(blk[0]))
        return blk
    serialize.BatchLoader.read_block = counting
    try:
        _merge_on_disk(header_db, files, out, uncompressed=False,
                       block_rows=256)
    finally:
        serialize.BatchLoader.read_block = orig
    assert max_block <= 256

    merged = serialize.load(out)
    # expected: global ascending (fv, key) over all batches
    keys = np.concatenate([r[0] for r in ref_rows])
    fvs = np.concatenate([r[1] for r in ref_rows])
    order = np.lexsort((keys, fvs))
    np.testing.assert_array_equal(merged.keys, keys[order])
    np.testing.assert_array_equal(merged.filter_values, fvs[order])
    # entries follow their k-mer
    all_db = [r[2] for r in ref_rows]
    batch_of = np.repeat(np.arange(len(ref_rows)), K)[order]
    row_of = np.tile(np.arange(K), len(ref_rows))[order]
    got = 0
    for n, (b, i) in enumerate(zip(batch_of, row_of)):
        db = all_db[b]
        lo, hi = db.offsets[i], db.offsets[i + 1]
        mlo, mhi = merged.offsets[n], merged.offsets[n + 1]
        np.testing.assert_array_equal(merged.scores[mlo:mhi],
                                      db.scores[lo:hi])
        np.testing.assert_array_equal(merged.branches[mlo:mhi],
                                      db.branches[lo:hi])
        got += hi - lo
    assert got == merged.num_entries()


# ---------------------------------------------------------------------------
# docs/format.md contract: an independent reader written from the doc alone
# must parse the committed goldens identically to the library loader (r4
# verdict item 5 — the doc previously described a layout the serializer no
# longer wrote).
# ---------------------------------------------------------------------------

def _read_ipk_per_format_doc(path):
    """Parse an .ipk file following docs/format.md byte-for-byte, using only
    struct/zlib/numpy — deliberately NOT ipk_tpu.serialize."""
    import struct
    import zlib
    import numpy as np

    raw = open(path, "rb").read()
    try:
        data = zlib.decompress(raw)
    except zlib.error:
        data = raw
    pos = 0

    def take(n):
        nonlocal pos
        out = data[pos:pos + n]
        assert len(out) == n, "truncated"
        pos += n
        return out

    def unpack(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def string():
        return take(unpack("<Q")).decode("utf-8")

    # magic: u64 = 22, "serialization::archive", u16 = 18
    assert unpack("<Q") == 22
    assert take(22) == b"serialization::archive"
    assert unpack("<H") == 18
    hdr = {"version": unpack("<I"), "sequence_type": string()}
    n_index = unpack("<Q")
    hdr["tree_index"] = [(unpack("<Q"), unpack("<d")) for _ in range(n_index)]
    hdr["tree"] = string()
    hdr["kmer_size"] = unpack("<Q")
    hdr["omega"] = unpack("<f")
    has_positions = bool(take(1)[0])
    K = unpack("<Q")
    E = unpack("<Q")

    def col(dtype, n):
        dt = np.dtype(dtype)
        return np.frombuffer(take(n * dt.itemsize), dtype=dt)

    cols = {
        "keys": col("<u8", K), "filter_values": col("<f4", K),
        "counts": col("<u8", K), "branches": col("<u4", E),
        "scores": col("<f4", E),
        "positions": col("<u4", E) if has_positions else None,
    }
    assert pos == len(data), "trailing bytes not described by format.md"
    return hdr, cols


def test_format_doc_layout():
    import os
    import numpy as np
    from ipk_tpu import serialize
    here = os.path.dirname(__file__)
    goldens = [os.path.join(here, "data", "golden", "D-dna", "DB_k7_o2.0.ipk"),
               os.path.join(here, "data", "golden", "D-aa", "DB_k4_o10.ipk")]
    for path in goldens:
        hdr, cols = _read_ipk_per_format_doc(path)
        db = serialize.load(path)
        assert hdr["version"] == db.version
        assert hdr["sequence_type"] == db.sequence_type
        assert hdr["tree"] == db.tree
        assert hdr["kmer_size"] == db.kmer_size
        assert hdr["omega"] == np.float32(db.omega)
        assert hdr["tree_index"] == [(int(n), float(s))
                                     for n, s in db.tree_index]
        np.testing.assert_array_equal(cols["keys"], db.keys)
        np.testing.assert_array_equal(cols["filter_values"],
                                      db.filter_values)
        np.testing.assert_array_equal(cols["counts"].astype(np.int64),
                                      np.diff(db.offsets))
        np.testing.assert_array_equal(cols["branches"], db.branches)
        np.testing.assert_array_equal(cols["scores"], db.scores)
        if cols["positions"] is not None or db.positions is not None:
            np.testing.assert_array_equal(cols["positions"], db.positions)
        # rows are in ascending (filter_value, key) order as documented
        order = np.lexsort((cols["keys"], cols["filter_values"]))
        np.testing.assert_array_equal(order, np.arange(len(order)))
