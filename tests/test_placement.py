"""Placement (mini-EPIK) tests: DB consumption end-to-end."""

import json
import os

import numpy as np

from ipk_tpu import serialize
from ipk_tpu.cli import main
from ipk_tpu.pipeline import BuildParams, build_database
from ipk_tpu.placement import PlacementIndex, place_queries
from ipk_tpu.seq import decode_kmer, DNA

from fixtures import make_project


def build_db(tmp_path, **kw):
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=6,
                                                 width=30, seed=33)
    out = str(tmp_path / "DB.ipk")
    params = BuildParams(refalign=fasta_file, reftree=tree_file,
                         states="nucl", working_dir=str(tmp_path / "wd"),
                         ar_dir=ar_dir, kmer_size=5, omega=1.5,
                         output_filename=out, verbosity=0, **kw)
    build_database(params)
    return out, fasta_file


def test_query_kmers_skips_ambiguity(tmp_path):
    out, _ = build_db(tmp_path)
    index = PlacementIndex(serialize.load(out))
    keys = index.query_kmers("ACGTACGT")
    assert len(keys) == 4
    keys2 = index.query_kmers("ACGNACGT")  # N invalidates 4 of the windows
    assert len(keys2) == 0 or len(keys2) < 4
    assert len(index.query_kmers("ACG")) == 0  # shorter than k


def test_scoring_prefers_matching_branch(tmp_path):
    out, _ = build_db(tmp_path)
    db = serialize.load(out)
    index = PlacementIndex(db)
    # take the best k-mer of some branch as the query: that branch must come
    # out ahead of the all-absent baseline
    key, entries = next(iter(db))
    query = decode_kmer(key, db.kmer_size, DNA)
    branch_ids, totals, n = index.score_query(query)
    assert n == 1
    best_branch = branch_ids[np.argmax(totals)]
    present = {e[0] for e in entries}
    assert int(best_branch) in present
    baseline = index.log_threshold
    assert totals.max() > baseline


def test_place_queries_weights_sum_to_one(tmp_path):
    out, fasta = build_db(tmp_path)
    db = serialize.load(out)
    from ipk_tpu.alignment import read_fasta
    placements = place_queries(db, read_fasta(fasta), top=3)
    assert placements
    for pl in placements:
        weights = [p[2] for p in pl["p"]]
        assert abs(sum(weights) - 1.0) < 1e-9
        assert len(pl["p"]) <= 3


def test_place_cli_jplace(tmp_path, capsys):
    out, fasta = build_db(tmp_path)
    jp = str(tmp_path / "out.jplace")
    assert main(["place", out, fasta, "-o", jp]) == 0
    assert "Placed" in capsys.readouterr().out
    doc = json.load(open(jp))
    assert doc["version"] == 3
    assert doc["fields"] == ["edge_num", "likelihood", "like_weight_ratio"]
    assert "{" in doc["tree"]  # edge annotations
    assert len(doc["placements"]) > 0
    edge_nums = {p[0] for pl in doc["placements"] for p in pl["p"]}
    db = serialize.load(out)
    assert edge_nums <= set(int(b) for b in db.branches)


def test_device_index_matches_host(tmp_path):
    """Device batch scorer must agree with the host scorer exactly."""
    from ipk_tpu.placement import DevicePlacementIndex
    out, fasta = build_db(tmp_path)
    db = serialize.load(out)
    host = PlacementIndex(db)
    dev = DevicePlacementIndex(db)
    from ipk_tpu.alignment import read_fasta
    seqs = [s for _, s in read_fasta(fasta)]
    seqs.append("ACGNACGTAC")   # ambiguity
    seqs.append("ACG")          # shorter than k
    branch_ids, totals, counts = dev.place_batch(seqs)
    np.testing.assert_array_equal(branch_ids, host.branch_ids)
    # the device-ranked serving path returns the head of the same ranking
    top = 3
    ids_tk, scores_tk, counts_tk = dev.place_batch_topk(seqs, top=top)
    np.testing.assert_array_equal(counts_tk, counts)
    for qi in range(len(seqs)):
        order = np.argsort(-totals[qi].astype(np.float64), kind="stable")
        np.testing.assert_array_equal(ids_tk[qi],
                                      branch_ids[order[:top]])
        np.testing.assert_allclose(scores_tk[qi], totals[qi][order[:top]],
                                   rtol=1e-6, atol=1e-6)
    for qi, seq in enumerate(seqs):
        b, expected, n = host.score_query(seq)
        assert counts[qi] == n
        np.testing.assert_allclose(totals[qi], expected.astype(np.float32),
                                   rtol=1e-6, atol=1e-5)


def test_engines_agree(tmp_path):
    out, fasta = build_db(tmp_path)
    db = serialize.load(out)
    from ipk_tpu.alignment import read_fasta
    queries = list(read_fasta(fasta))
    host = place_queries(db, queries, top=3, engine="host")
    dev = place_queries(db, queries, top=3, engine="device")
    assert len(host) == len(dev)
    for a, b in zip(host, dev):
        assert a["n"] == b["n"]
        assert [p[0] for p in a["p"]] == [p[0] for p in b["p"]]
        np.testing.assert_allclose([p[1] for p in a["p"]],
                                   [p[1] for p in b["p"]], rtol=1e-5,
                                   atol=1e-4)


def test_placement_identical_single_vs_multidevice(tmp_path, monkeypatch):
    """BASELINE.json config 5: a DB built over the 8-device mesh (device
    key merge included on the sparse path) must place queries identically
    to the single-device build — asserted at the jplace level."""
    import ipk_tpu.builder as bm
    from ipk_tpu.placement import write_jplace

    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=6,
                                                 width=30, seed=33)
    monkeypatch.setattr(bm, "MAX_DENSE_KEYSPACE", 1)   # force sparse

    def build(name, no_shard):
        out = str(tmp_path / f"{name}.ipk")
        if no_shard:
            monkeypatch.setenv("IPK_TPU_NO_SHARD", "1")
        else:
            monkeypatch.delenv("IPK_TPU_NO_SHARD", raising=False)
        build_database(BuildParams(
            refalign=fasta_file, reftree=tree_file, states="nucl",
            working_dir=str(tmp_path / f"wd_{name}"), ar_dir=ar_dir,
            kmer_size=5, omega=1.5, output_filename=out, verbosity=0))
        return out

    queries = [("q1", "ACGTACGTACGTACG"), ("q2", "GGGTTTACACAT")]
    outputs = []
    for name, no_shard in (("one", True), ("mesh", False)):
        db = serialize.load(build(name, no_shard))
        placements = place_queries(db, queries)
        path = str(tmp_path / f"{name}.jplace")
        write_jplace(db, placements, path)
        with open(path) as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[1]
