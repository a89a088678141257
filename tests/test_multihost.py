"""Multi-host build: two real processes through the actual CLI flags.

Exercises ``initialize_distributed`` (``parallel/mesh.py``) end-to-end —
``jax.distributed.initialize`` over the CPU backend, 2 processes x 2 virtual
devices = a 4-device global ("branch") mesh — and asserts the resulting
database is byte-equal to a single-process build of the same project. The
reference has no multi-process facility at all (SURVEY.md §2.3); this is the
scale-out path BASELINE.md row 4 ("N>=2 hosts") asks evidence for.
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

from fixtures import make_project

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WRAPPER = """\
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from ipk_tpu.cli import main
sys.exit(main(sys.argv[1:]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_build_matches_single(tmp_path):
    tree_file, fasta_file, ar_dir = make_project(
        pathlib.Path(tmp_path), num_leaves=12, width=80, seed=5)
    wrapper = tmp_path / "run_build.py"
    wrapper.write_text(_WRAPPER)
    port = _free_port()

    def argv(host_id, tag, extra=()):
        wd = tmp_path / f"wd_{tag}"
        out = tmp_path / f"DB_{tag}.ipk"
        return [sys.executable, str(wrapper), "build",
                "-r", str(fasta_file), "-t", str(tree_file), "-m", "GTR",
                "--ar-dir", str(ar_dir), "-k", "6", "-w", str(wd),
                "-o", str(out), "-v", "0", *extra], out

    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("XLA_FLAGS", None)

    # single-process reference build (2 virtual devices: the sharded path)
    args, out_single = argv(0, "single")
    subprocess.run(args, env=env, check=True, timeout=600,
                   capture_output=True)

    # two cooperating processes via the real CLI flags
    dist = ["--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2"]
    procs, outs = [], []
    for host_id in range(2):
        args, out = argv(host_id, f"h{host_id}",
                         dist + ["--host-id", str(host_id)])
        procs.append(subprocess.Popen(args, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
        outs.append(out)
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (
            f"multi-host build failed:\n{stderr.decode()[-3000:]}")

    single = out_single.read_bytes()
    assert single == outs[0].read_bytes(), (
        "process 0's multi-host DB differs from the single-process build")
    assert single == outs[1].read_bytes(), (
        "process 1's multi-host DB differs from the single-process build")
