"""CLI surface tests: build/diff/dump subcommands (cf. ipk.py + tools/)."""

import os

import numpy as np
import pytest

from ipk_tpu.cli import main
from fixtures import make_project


@pytest.fixture
def cli(capsys):
    """Run the CLI in-process → (exit code, stdout + stderr)."""
    def run(argv):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
        out = capsys.readouterr()
        return code, out.out + out.err
    return run


def test_build_help(cli):
    code, output = cli(["build", "--help"])
    assert code == 0
    # option surface mirrors ipk.py
    for opt in ["--refalign", "--reftree", "--states", "--workdir", "--omega",
                "--filter", "--ghosts", "--use-unrooted", "--ar-dir",
                "--ar-only", "--keep-positions", "--uncompressed", "--on-disk",
                "--merge-branches", "--reduction-ratio", "--no-reduction"]:
        assert opt in output, opt


def test_build_diff_dump_roundtrip(tmp_path, cli):
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=5,
                                                 width=20, seed=3)
    wd = str(tmp_path / "wd")
    out = str(tmp_path / "DB.ipk")
    code, output = cli(["build", "-r", fasta_file, "-t", tree_file,
                        "-w", wd, "-k", "4", "--omega", "1.5",
                        "--ar-dir", ar_dir, "-o", out, "-v", "0",
                        "-m", "GTR"])
    assert code == 0, output
    assert os.path.exists(out)

    # diff with itself: OK, exit 0
    code, output = cli(["diff", out, out])
    assert code == 0
    assert "DIFF" not in output

    # diff against a different build: exit 1 (unlike reference ipkdiff!)
    out2 = str(tmp_path / "DB2.ipk")
    code, output = cli(["build", "-r", fasta_file, "-t", tree_file,
                        "-w", str(tmp_path / "wd2"), "-k", "4",
                        "--omega", "2.0", "--ar-dir", ar_dir, "-o", out2,
                        "-v", "0", "-m", "GTR"])
    assert code == 0, output
    code, output = cli(["diff", out, out2])
    assert code == 1
    assert "DIFF" in output

    # dump format: kmer line then tab-indented entries with 10^score
    code, output = cli(["dump", out])
    assert code == 0
    lines = output.splitlines()
    assert len(lines) > 2
    assert not lines[0].startswith("\t")
    assert lines[1].startswith("\t")
    assert set(lines[0]) <= set("ACGT")


def test_keep_positions_rejected_for_dna(tmp_path, cli):
    code, output = cli(["build", "-r", __file__, "-t", __file__,
                        "-w", str(tmp_path), "--keep-positions",
                        "-m", "GTR"])
    assert code != 0
    assert "not supported for DNA" in output


def test_invalid_filter_and_model(tmp_path, cli):
    code, output = cli(["build", "-r", __file__, "-t", __file__,
                        "-w", str(tmp_path), "--filter", "bogus",
                        "-m", "GTR"])
    assert code != 0
    code, output = cli(["build", "-r", __file__, "-t", __file__,
                        "-w", str(tmp_path), "-m", "NOTAMODEL"])
    assert code != 0


def test_algorithm_flags_accepted(tmp_path, cli):
    """--BB/--DC/--DCLA/--DCCW parity: accepted; DCLA semantics always used
    (matching db_builder.cpp:648)."""
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=15, seed=8)
    outs = []
    for flag in ["--dcla", "--dccw", "--bb", "--dc"]:
        out = str(tmp_path / f"DB{flag.strip('-')}.ipk")
        code, output = cli(["build", "-r", fasta_file, "-t", tree_file,
                            "-w", str(tmp_path / f"w{flag.strip('-')}"),
                            "-k", "3", "--ar-dir", ar_dir, "-o", out,
                            "-v", "0", "-m", "GTR", flag])
        assert code == 0, output
        outs.append(out)
    ref = open(outs[0], "rb").read()
    for other in outs[1:]:
        assert open(other, "rb").read() == ref


def test_write_reduction(tmp_path, cli):
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=15, seed=9)
    red = str(tmp_path / "reduced.fasta")
    code, output = cli(["build", "-r", fasta_file, "-t", tree_file,
                        "-w", str(tmp_path / "w"), "-k", "3",
                        "--ar-dir", ar_dir, "-v", "0", "-m", "GTR",
                        "--write-reduction", red])
    assert code == 0, output
    assert os.path.exists(red)


def test_diff_text_command(tmp_path, cli):
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=15, seed=10)
    out1 = str(tmp_path / "a.ipk")
    out2 = str(tmp_path / "b.ipk")
    for out, omega in [(out1, "1.5"), (out2, "1.5")]:
        code, output = cli(["build", "-r", fasta_file, "-t", tree_file,
                            "-w", str(tmp_path / ("w" + out[-5])),
                            "-k", "3", "--omega", omega, "--ar-dir",
                            ar_dir, "-o", out, "-v", "0", "-m", "GTR"])
        assert code == 0, output
    code, output = cli(["diff-text", out1, out2])
    assert code == 0 and "OK" in output
    # different omega -> different k-mer sets -> exit 1
    out3 = str(tmp_path / "c.ipk")
    code, output = cli(["build", "-r", fasta_file, "-t", tree_file,
                        "-w", str(tmp_path / "wc"), "-k", "3",
                        "--omega", "0.7", "--ar-dir", ar_dir, "-o", out3,
                        "-v", "0", "-m", "GTR"])
    assert code == 0, output
    code, output = cli(["diff-text", out1, out3])
    assert code == 1


def test_convert_uo(tmp_path):
    from ipk_tpu.alignment import Alignment, convert_uo
    a = convert_uo(Alignment(["x"], ["RUOur"]))
    assert a.sequences == ["RCLcr"]
