"""The C++ clean-room DCLA oracle (``native/baseline_dcla.cpp``), driven
through its stdin protocol: emit mode 1 returns the merged per-group
survivor sets, emit mode 2 the complete DB content (stages 1-3). Shared by
the oracle gate tests and ``chip_smoke.py``."""

import json
import os
import struct
import subprocess

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINARY = os.path.join(REPO, "native", "baseline_dcla")
SOURCE = BINARY + ".cpp"


def _binary():
    if (not os.path.exists(BINARY)
            or os.path.getmtime(BINARY) < os.path.getmtime(SOURCE)):
        subprocess.run(["g++", "-O2", "-o", BINARY, SOURCE], check=True)
    return BINARY


def oracle_survivors(P, k, sigma, eps):
    """Run the C++ oracle in emit mode → [{code: score_f32}] per group."""
    G, S = P.shape[0], P.shape[1]
    header = struct.pack("<qqqqfq", G, S, sigma, k, eps, 1)
    out = subprocess.run([_binary()], input=header + P.tobytes(),
                         capture_output=True, check=True).stdout
    lines = out.decode().splitlines()
    stats = json.loads(lines[0])
    groups = []
    i = 1
    while i < len(lines):
        tag, gid, n = lines[i].split()
        assert tag == "G" and int(gid) == len(groups)
        rows = {}
        for j in range(int(n)):
            code, bits = lines[i + 1 + j].split()
            rows[int(code)] = np.uint32(int(bits)).view(np.float32)
        groups.append(rows)
        i += 1 + int(n)
    return groups, stats


def oracle_full(P, k, sigma, eps, n_total, threshold, branch_ids):
    """Run the C++ oracle in emit=2 (full pipeline) mode.
    Returns (rows, stats): rows = [(key, fv_f64, [(branch, score_bits)])]
    in the oracle's ascending (fv, key) order."""
    G, S = P.shape[0], P.shape[1]
    assert G == 2 * len(branch_ids)
    header = struct.pack("<qqqqfq", G, S, sigma, k, eps, 2)
    header += struct.pack("<qdq", n_total, threshold, len(branch_ids))
    header += np.asarray(branch_ids, dtype="<i8").tobytes()
    out = subprocess.run([_binary()], input=header + P.tobytes(),
                         capture_output=True, check=True).stdout
    lines = out.decode().splitlines()
    stats = json.loads(lines[0])
    rows = []
    i = 1
    while i < len(lines):
        tag, key, fv_bits, n = lines[i].split()
        assert tag == "R"
        fv = np.uint64(int(fv_bits)).view(np.float64)
        ents = []
        for j in range(int(n)):
            br, sb = lines[i + 1 + j].split()
            ents.append((int(br), np.uint32(int(sb))))
        rows.append((int(key), float(fv), ents))
        i += 1 + int(n)
    return rows, stats
