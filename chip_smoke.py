#!/usr/bin/env python3
"""End-to-end check of the phylo-k-mer build on an NVIDIA GPU.

Drives the main path through the entry point a user calls
(``python -m ipk_tpu build``, here ``ipk_tpu.cli.main`` in process) at the
size of a marker-gene reference — 512 leaves x 1500 sites, DNA, k=10,
omega=1.5, both ghost strategies, mif0 filter — with inputs generated from a
fixed seed (``tests/fixtures.make_project``), then checks what comes out
against the C++ DCLA oracle (``native/baseline_dcla.cpp``), a CPU build, the
host placement engine and the plain XLA versions of the kernels.

    python chip_smoke.py                  # every phase, on one card
    python chip_smoke.py --multi          # 4 cards: sharded vs one-card DBs
    JAX_PLATFORMS=cpu python chip_smoke.py --size tiny
                                          # rehearsal: every phase, tiny,
                                          # then exit 1 (no GPU)

Each phase prints one JSON object on its own line. The last line is
``{"ok": true, "device": {...}}`` only when every phase passed on a GPU;
any failed phase, or a platform that is not a GPU, exits non-zero. CPU
comparisons run in child processes with ``JAX_PLATFORMS=cpu``, so this
process is the only one that opens a card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
import traceback

from ipk_tpu.utils.device import (NotOnGPU, device_info, nvidia_smi,
                                  require_gpu)

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

#: phase sizes. "full" is the deployment the check is about; "tiny" shrinks
#: every phase so the whole script can be rehearsed on a CPU.
SIZES = {
    "full": {
        "marker": dict(leaves=512, width=1500, k=10, omega=1.5),
        # --multi builds three marker DBs and two viral ones, cut in depth
        # (leaves) for the four-card time budget; the viral one also in
        # sites, so that the whole enumeration fits the device key merge's
        # single-dispatch budget and the merge's all_to_all runs
        "multi_marker": dict(leaves=64, width=1500, k=10, omega=1.5),
        "multi_viral": dict(leaves=16, width=800, k=12, omega=2.0,
                            cap=8192),
        "oracle_groups": 8,
        "cpu_parity": dict(leaves=64, width=400, k=8, omega=1.5),
        "viral": dict(leaves=64, width=3000, k=12, omega=2.0, cap=8192),
        "protein": dict(leaves=64, width=400, k=6, omega=4.0),
        "placement": dict(reads=2048, length=150),
        # the parameter fit compiles one unrolled pruning pass over the
        # whole extended tree; it runs on a 16-leaf tree of the same width
        "native_ar": dict(leaves=64, width=1500, fit_leaves=16,
                          opt_steps=(45, 45)),
        "dense_shapes": [(512, 293, 256, 256), (256, 1491, 256, 1024)],
        "reps": 2,
    },
    "tiny": {
        "marker": dict(leaves=6, width=40, k=10, omega=1.5),
        "multi_marker": dict(leaves=6, width=40, k=10, omega=1.5),
        "multi_viral": dict(leaves=8, width=120, k=12, omega=2.0, cap=8192),
        "oracle_groups": 4,
        "cpu_parity": dict(leaves=8, width=60, k=8, omega=1.5),
        "viral": dict(leaves=8, width=120, k=12, omega=2.0, cap=8192),
        "protein": dict(leaves=8, width=60, k=6, omega=4.0),
        "placement": dict(reads=96, length=40),
        "native_ar": dict(leaves=8, width=60, fit_leaves=4,
                          opt_steps=(3, 3)),
        "dense_shapes": [(4, 9, 16, 16), (2, 12, 16, 64)],
        "reps": 1,
    },
}


class PhaseError(RuntimeError):
    """A check inside a phase failed."""


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def restrict_to_one_card() -> None:
    """Before JAX starts: the default run uses the first visible card."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    first = visible.split(",")[0] if visible else "0"
    os.environ["CUDA_VISIBLE_DEVICES"] = first


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def cpu_env() -> dict:
    """Environment of a child that must not open the card."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return env


def run_child(args, timeout) -> subprocess.CompletedProcess:
    out = subprocess.run([sys.executable, *args], env=cpu_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise PhaseError(f"CPU child {args[:3]} exited {out.returncode}: "
                         f"{out.stderr[-1500:]}")
    return out


def quiet(fn, *args):
    """Call ``fn`` with its standard output sent to standard error: this
    script's standard output holds only its result lines."""
    with contextlib.redirect_stdout(sys.stderr):
        return fn(*args)


class CompileClock:
    """Sums JAX's compile-event durations while active (tracing, lowering,
    backend compile), so a build's first-compile time is reported apart from
    its wall time."""

    def __init__(self):
        import jax
        self.total = 0.0
        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if self.active and event.startswith("/jax/core/compile/"):
            self.total += duration

    def __enter__(self):
        self.total, self.active = 0.0, True
        return self

    def __exit__(self, *exc):
        self.active = False


def project(work, name, leaves, width, traits_name="nucl"):
    from fixtures import make_project
    from ipk_tpu.seq import get_traits
    d = os.path.join(work, name)
    os.makedirs(d, exist_ok=True)
    return make_project(d, num_leaves=leaves, width=width, seed=SEED,
                        traits=get_traits(traits_name))


def build_argv(proj, wd, out, *, k, omega, states="nucl", extra=()):
    tree_file, fasta_file, ar_dir = proj
    model = "GTR" if states == "nucl" else "LG"
    argv = ["build", "-r", fasta_file, "-t", tree_file, "-w", wd,
            "-s", states, "-k", str(k), "--omega", str(omega),
            "--ghosts", "both", "--filter", "mif0", "-m", model,
            "-o", out, "-v", "0", *extra]
    if ar_dir is not None:
        argv += ["--ar-dir", ar_dir]
    return argv


def cli_build(argv, clock):
    """``ipk_tpu build`` through the CLI's own main, in this process.
    Returns (BuildResult, wall seconds, compile seconds)."""
    import ipk_tpu.pipeline as pipeline
    from ipk_tpu import cli
    captured = []
    real = pipeline.build_database

    def capture(params):
        captured.append(real(params))
        return captured[-1]

    pipeline.build_database = capture
    try:
        with clock:
            t0 = time.monotonic()
            rc = quiet(cli.main, argv)
            wall = time.monotonic() - t0
    finally:
        pipeline.build_database = real
    check(rc == 0, f"build exited {rc}")
    return captured[0], wall, clock.total


def ghost_tensor(proj, traits):
    """The build's ghost tensor, gathered as the builder gathers it:
    (P_all [G, S, sigma] f32, group_ids)."""
    import numpy as np
    from ipk_tpu import tree as tr
    from ipk_tpu.ar.mapping import gather_ghost_tensor, ghost_groups, map_nodes
    from ipk_tpu.ar.reader import read_ancestral_probs
    tree_file, _, ar_dir = proj
    original, extended, ghost_mapping = tr.preprocess_tree(tree_file, False)
    ar_tree = tr.load_newick(os.path.join(ar_dir, "align.raxml.ancestralTree"))
    if original.is_rooted() and not ar_tree.is_rooted():
        tr.reroot_tree(ar_tree)
    ar_mapping = map_nodes(extended, ar_tree)
    label_rows, P = read_ancestral_probs(
        os.path.join(ar_dir, "align.raxml.ancestralProbs"), traits)
    groups, group_ids = ghost_groups(extended, original, ghost_mapping, "both")
    P_all = np.ascontiguousarray(
        gather_ghost_tensor(groups, ar_mapping, label_rows, P),
        dtype=np.float32)
    return P_all, group_ids, original


def sample_groups(proj, traits, n_groups):
    """The build's ghost tensor, its group ids, and ``n_groups`` branch
    groups spread over the tree."""
    import numpy as np
    P_all, group_ids, _ = ghost_tensor(proj, traits)
    B = len(group_ids)
    picks = np.unique(np.linspace(0, B - 1, min(n_groups, B)).astype(int))
    return P_all, group_ids, picks


def group_entries(db, group_ids, picks) -> list:
    """Each picked group's (keys, f32 score bits) in ``db``, by key."""
    import numpy as np
    out = []
    for b in picks:
        idx = np.flatnonzero(db.branches == np.uint32(group_ids[b]))
        keys = db.keys[np.searchsorted(db.offsets, idx, side="right") - 1]
        order = np.argsort(keys)
        out.append((keys[order], db.scores[idx][order].view(np.uint32)))
    return out


def oracle_groups_match(entries, P_all, picks, traits, k, omega) -> dict:
    """The picked groups' DB entries against the C++ oracle (emit mode 1):
    key sets and f32 score bits identical."""
    import numpy as np
    from cpp_oracle import oracle_survivors
    from ipk_tpu.builder import log_threshold_f32
    rows = np.stack([2 * picks, 2 * picks + 1], axis=1).ravel()
    eps = log_threshold_f32(omega, traits.alphabet_size, k)
    t0 = time.monotonic()
    expected, stats = oracle_survivors(np.ascontiguousarray(P_all[rows]), k,
                                       traits.alphabet_size, eps)
    oracle_s = time.monotonic() - t0
    n = 0
    for gi, (b, (keys, bits)) in enumerate(zip(picks, entries)):
        o_keys = np.fromiter(expected[gi].keys(), np.uint64,
                             len(expected[gi]))
        o_bits = np.array([np.float32(v).view(np.uint32)
                           for v in expected[gi].values()], np.uint32)
        o_order = np.argsort(o_keys)
        check(np.array_equal(keys, o_keys[o_order]),
              f"group {b}: key set differs from the oracle "
              f"({len(keys)} vs {len(o_keys)} keys)")
        check(np.array_equal(bits, o_bits[o_order]),
              f"group {b}: score bits differ from the oracle")
        n += len(keys)
    return {"groups": [int(b) for b in picks], "entries_compared": n,
            "oracle_tuples": stats["tuples"], "oracle_seconds": oracle_s}


def memory_stats() -> dict:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    peak, limit = stats.get("peak_bytes_in_use"), stats.get("bytes_limit")
    return {"peak_bytes_in_use": peak, "bytes_limit": limit,
            "peak_share": (peak / limit) if peak and limit else None}


def read_reads(length, n, fasta_file, seed):
    """``n`` reads of ``length`` bp cut from the reference sequences, with
    1% substitutions, from a seed."""
    import numpy as np
    from ipk_tpu.alignment import read_fasta
    rng = np.random.default_rng(seed)
    seqs = [s.replace("-", "") for _, s in read_fasta(fasta_file)]
    seqs = [s for s in seqs if len(s) >= length]
    reads = []
    for i in range(n):
        s = seqs[rng.integers(len(seqs))]
        start = rng.integers(len(s) - length + 1)
        r = np.frombuffer(s[start:start + length].encode(), np.uint8).copy()
        flip = rng.random(length) < 0.01
        r[flip] = rng.choice(np.frombuffer(b"ACGT", np.uint8), flip.sum())
        reads.append((f"read{i}", r.tobytes().decode()))
    return reads


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(state):
    import jax
    info = device_info(jax.devices())
    state["device"] = info
    out = {"devices": [str(d) for d in jax.devices()], **info,
           "nvidia_smi": nvidia_smi(), "jax": jax.__version__,
           "compile_cache": state["cache_dir"]}
    state["device_error"] = None
    try:
        require_gpu(info)
    except NotOnGPU as e:
        state["device_error"] = str(e)
        raise
    return out


def phase_marker(state):
    from ipk_tpu import cli, tools
    from ipk_tpu.builder import choose_backend
    from ipk_tpu.seq import DNA
    cfg = state["size"]["marker"]
    work = state["work"]
    t0 = time.monotonic()
    proj = project(work, "marker", cfg["leaves"], cfg["width"])
    inputs_s = time.monotonic() - t0
    db_path = os.path.join(work, "marker", "DB.ipk")
    result, wall, compile_s = cli_build(
        build_argv(proj, os.path.join(work, "marker", "wd"), db_path,
                   k=cfg["k"], omega=cfg["omega"]), state["clock"])
    check(os.path.exists(db_path), "no .ipk written")
    # keep the groups oracle_sample checks, then let the in-memory DB go:
    # what follows reads the file, as a user's diff and dump would
    P_all, group_ids, picks = sample_groups(proj, DNA,
                                            state["size"]["oracle_groups"])
    entries = group_entries(result.db, group_ids, picks)
    out = {"size": cfg, "backend": choose_backend(),
           "heap": ("freed buffers returned to the system "
                    "(IPK_TPU_NO_MALLOC_TUNE=1), unlike the CLI's default"
                    if os.environ.get("IPK_TPU_NO_MALLOC_TUNE") == "1"
                    else "the CLI's default (retain_heap)"),
           "inputs_seconds": inputs_s, "wall_seconds": wall,
           "compile_seconds": compile_s,
           "wall_minus_compile_seconds": wall - compile_s,
           "timings": result.timings, "explored_tuples": result.num_explored,
           "db_kmers": result.db.size(),
           "db_entries": result.db.num_entries(),
           "db_bytes": os.path.getsize(db_path), **memory_stats()}
    del result
    t0 = time.monotonic()
    check(quiet(cli.main, ["diff", db_path, db_path]) == 0,
          "diff rejects the DB")
    out["diff_seconds"] = time.monotonic() - t0

    class Head:
        """Stops the dump after a few lines: proves it reads the file."""
        def __init__(self):
            self.lines = []

        def write(self, text):
            self.lines += text.splitlines()
            if len(self.lines) >= 8:
                raise StopIteration

    head = Head()
    t0 = time.monotonic()
    try:
        tools.dump_database(db_path, head)
    except StopIteration:
        pass
    out["dump_seconds"] = time.monotonic() - t0
    check(len(head.lines) >= 2 and head.lines[1].startswith("\t"),
          f"dump output malformed: {head.lines[:3]}")
    state["marker"] = dict(proj=proj, db_path=db_path, P_all=P_all,
                           picks=picks, entries=entries, **cfg)
    return out


def phase_oracle_sample(state):
    from ipk_tpu.seq import DNA
    m = state.get("marker")
    check(m is not None, "marker_k10 did not complete")
    return oracle_groups_match(m.pop("entries"), m.pop("P_all"), m["picks"],
                               DNA, m["k"], m["omega"])


def phase_cpu_parity(state):
    import numpy as np
    from cpp_oracle import oracle_full
    from ipk_tpu import cli, serialize
    from ipk_tpu.builder import log_threshold_f32
    from ipk_tpu.core.filter import score_threshold
    from ipk_tpu.seq import DNA
    cfg = state["size"]["cpu_parity"]
    work = state["work"]
    proj = project(work, "parity", cfg["leaves"], cfg["width"])
    dev_db = os.path.join(work, "parity", "DB_gpu.ipk")
    cpu_db = os.path.join(work, "parity", "DB_cpu.ipk")
    _, wall, _ = cli_build(build_argv(
        proj, os.path.join(work, "parity", "wd_gpu"), dev_db, k=cfg["k"],
        omega=cfg["omega"]), state["clock"])
    t0 = time.monotonic()
    run_child(["-m", "ipk_tpu", *build_argv(
        proj, os.path.join(work, "parity", "wd_cpu"), cpu_db, k=cfg["k"],
        omega=cfg["omega"])], timeout=1200)
    cpu_wall = time.monotonic() - t0
    check(quiet(cli.main, ["diff", dev_db, cpu_db]) == 0,
          "ipk_tpu diff: device and CPU DBs differ")
    with open(dev_db, "rb") as a, open(cpu_db, "rb") as b:
        check(a.read() == b.read(), "device and CPU DBs not byte-identical")

    # full DB content against the oracle's stages 1-3 (emit mode 2)
    db = serialize.load(dev_db)
    P_all, group_ids, original = ghost_tensor(proj, DNA)
    sigma = DNA.alphabet_size
    rows, stats = oracle_full(
        P_all, cfg["k"], sigma, log_threshold_f32(cfg["omega"], sigma,
                                                  cfg["k"]),
        original.get_node_count(),
        score_threshold(cfg["omega"], sigma, cfg["k"]), group_ids)
    check(db.size() == len(rows), f"{db.size()} keys vs oracle {len(rows)}")
    check(np.array_equal(db.keys, np.array([r[0] for r in rows], np.uint64)),
          "keys (in (fv, key) order) differ from the oracle")
    o_fv = np.array([r[1] for r in rows]).astype(np.float32)
    ulp = np.abs(db.filter_values.view(np.uint32).astype(np.int64)
                 - o_fv.view(np.uint32).astype(np.int64))
    check(ulp.max() <= 2, f"filter values off by {ulp.max()} f32 ulp")
    o_br = np.concatenate([[e[0] for e in r[2]] for r in rows])
    o_sc = np.concatenate([[e[1] for e in r[2]] for r in rows])
    check(np.array_equal(db.branches, o_br.astype(np.uint32)),
          "entry branches differ from the oracle")
    check(np.array_equal(db.scores.view(np.uint32), o_sc.astype(np.uint32)),
          "entry score bits differ from the oracle")
    return {"size": cfg, "device_wall_seconds": wall,
            "cpu_child_wall_seconds": cpu_wall, "byte_identical": True,
            "db_bytes": os.path.getsize(dev_db), "db_kmers": db.size(),
            "oracle_tuples": stats["tuples"],
            "fv_ulp_max": int(ulp.max()),
            "fv_ulp_nonzero": int((ulp > 0).sum())}


def _sparse_phase(state, name, traits_name):
    from ipk_tpu.seq import get_traits
    cfg = state["size"][name]
    traits = get_traits(traits_name)
    work = state["work"]
    proj = project(work, name, cfg["leaves"], cfg["width"], traits_name)
    db_path = os.path.join(work, name, "DB.ipk")
    extra = ("--max-candidates", str(cfg["cap"])) if "cap" in cfg else ()
    result, wall, compile_s = cli_build(build_argv(
        proj, os.path.join(work, name, "wd"), db_path, k=cfg["k"],
        omega=cfg["omega"], states=traits_name, extra=extra), state["clock"])
    check(result.db.num_entries() > 0, "empty database")
    P_all, group_ids, picks = sample_groups(proj, traits,
                                            state["size"]["oracle_groups"])
    cmp = oracle_groups_match(group_entries(result.db, group_ids, picks),
                              P_all, picks, traits, cfg["k"], cfg["omega"])
    state[name] = dict(proj=proj, db_path=db_path, **cfg)
    return {"size": cfg, "wall_seconds": wall, "compile_seconds": compile_s,
            "timings": result.timings,
            "explored_tuples": result.num_explored,
            "db_entries": result.db.num_entries(), **cmp}


def phase_viral(state):
    return _sparse_phase(state, "viral", "nucl")


def phase_protein(state):
    return _sparse_phase(state, "protein", "amino")


def phase_placement(state):
    import numpy as np
    from ipk_tpu import cli, placement
    from ipk_tpu.alignment import write_fasta
    m = state.get("marker")
    check(m is not None, "marker_k10 did not complete")
    cfg = state["size"]["placement"]
    work = state["work"]
    reads = read_reads(cfg["length"], cfg["reads"], m["proj"][1], SEED)
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(iter(reads), fasta)
    jplace = os.path.join(work, "reads.jplace")
    # keep the device index `place` builds: the engines are compared on it
    # (building a second one from the 1e9-entry DB would take minutes)
    real, indexes = placement.DevicePlacementIndex, []

    def capture(db):
        indexes.append(real(db))
        return indexes[-1]

    placement.DevicePlacementIndex = capture
    t0 = time.monotonic()
    try:
        rc = quiet(cli.main, ["place", m["db_path"], fasta, "-o", jplace])
    finally:
        placement.DevicePlacementIndex = real
    place_s = time.monotonic() - t0
    check(rc == 0, "place exited non-zero")
    check(len(indexes) == 1, f"place built {len(indexes)} device indexes")
    with open(jplace) as f:
        placed = len(json.load(f)["placements"])
    check(placed == len(reads), f"placed {placed} of {len(reads)} reads")

    # totals of the device engine against the host engine, every branch of
    # every read (tolerance of tests/test_placement.py: f32 vs f64 sums)
    index = indexes.pop()
    seqs = [s for _, s in reads]
    t0 = time.monotonic()
    _, dev_totals, dev_counts = index.place_batch(seqs)
    dev_s = time.monotonic() - t0
    t0 = time.monotonic()
    host = [index.host.score_query(s) for s in seqs]
    host_s = time.monotonic() - t0
    host_totals = np.stack([t for _, t, _ in host])
    check(np.array_equal(dev_counts, [n for _, _, n in host]),
          "query k-mer counts differ")
    excess = np.abs(dev_totals - host_totals) - (1e-5 + 1e-6 * np.abs(
        host_totals))
    check(excess.max() <= 0, f"device totals off the host's by "
                             f"{float(excess.max()):.3g} beyond tolerance")
    top1 = float(np.mean(dev_totals.argmax(axis=1)
                         == host_totals.argmax(axis=1)))
    return {"size": cfg, "placed": placed, "cli_place_seconds": place_s,
            "device_engine_seconds": dev_s, "host_engine_seconds": host_s,
            "max_abs_total_diff": float(np.abs(dev_totals
                                               - host_totals).max()),
            "top1_agreement": top1}


def native_ar_outputs(proj_dir, fit_dir, out_dir, opt_steps) -> dict:
    """Run ``build --ar native`` on the project in ``proj_dir`` and the
    parameter fit on the one in ``fit_dir``, on JAX's default device (the
    build's own fit, ``ar/optimize.py``, stays on the host CPU; this
    re-measures why), once per entry of ``opt_steps``, the step count: the
    first run compiles, a repeat finds its programs in the compile cache.
    Save the log10 posteriors and the DB under ``out_dir``. Runs in this
    process (the card) and in the CPU child alike."""
    import jax
    import numpy as np
    from ipk_tpu import alignment as aln, cli, tree as tr
    from ipk_tpu.ar.native import ancestral_posteriors
    from ipk_tpu.ar.optimize import optimize_parameters
    from ipk_tpu.seq import DNA
    os.makedirs(out_dir, exist_ok=True)
    proj = (os.path.join(proj_dir, "tree.newick"),
            os.path.join(proj_dir, "reference.fasta"), None)
    wd = os.path.join(out_dir, "wd")
    t0 = time.monotonic()
    rc = quiet(cli.main, build_argv(proj, wd, os.path.join(out_dir, "DB.ipk"),
                                    k=8, omega=1.5, extra=("--ar", "native")))
    build_s = time.monotonic() - t0
    if rc != 0:
        raise PhaseError(f"--ar native build exited {rc}")
    ext_tree = tr.load_newick(os.path.join(wd, "extended_trees",
                                           "extended_tree.newick"))
    ext_align = aln.load_alignment(os.path.join(wd, "extended_trees",
                                                "extended_align.fasta"))
    _, posts = ancestral_posteriors(ext_tree, ext_align, DNA)
    np.save(os.path.join(out_dir, "log10_post.npy"),
            np.log10(np.maximum(posts, 1e-38)).astype(np.float32))
    _, ext_tree, _ = tr.preprocess_tree(os.path.join(fit_dir, "tree.newick"),
                                        False)
    ext_align = aln.extend_alignment(
        aln.load_alignment(os.path.join(fit_dir, "reference.fasta")),
        ext_tree, DNA)
    out = {"build_seconds": build_s}
    for run, steps in enumerate(opt_steps):
        t0 = time.monotonic()
        fit = optimize_parameters(ext_tree, ext_align, DNA, steps=steps,
                                  verbosity=0, device=jax.devices()[0])
        out[f"fit_run{run}_{steps}_steps_seconds"] = time.monotonic() - t0
    out["loglik_initial"] = fit.loglik_initial
    out["loglik_final"] = fit.loglik_final
    with open(os.path.join(out_dir, "fit.json"), "w") as f:
        json.dump(out, f)
    return out


def phase_native_ar(state):
    import numpy as np
    from ipk_tpu import serialize
    cfg = state["size"]["native_ar"]
    work = state["work"]
    project(work, "native_ar", cfg["leaves"], cfg["width"])
    project(work, "native_ar_fit", cfg["fit_leaves"], cfg["width"])
    proj_dir = os.path.join(work, "native_ar")
    fit_dir = os.path.join(work, "native_ar_fit")
    gpu_dir = os.path.join(proj_dir, "gpu")
    cpu_dir = os.path.join(proj_dir, "cpu")
    gpu = native_ar_outputs(proj_dir, fit_dir, gpu_dir, cfg["opt_steps"])
    run_child([os.path.abspath(__file__), "--native-ar-child", proj_dir,
               fit_dir, cpu_dir, *map(str, cfg["opt_steps"])], timeout=1800)
    with open(os.path.join(cpu_dir, "fit.json")) as f:
        cpu = json.load(f)
    a = np.load(os.path.join(gpu_dir, "log10_post.npy"))
    b = np.load(os.path.join(cpu_dir, "log10_post.npy"))
    check(a.shape == b.shape, f"posterior shapes {a.shape} vs {b.shape}")
    # only posteriors above 1e-6 can matter: every site of a surviving
    # k-mer has p > (omega/sigma)^k, which is > 5e-5 for these configs
    live = np.maximum(a, b) > -6.0
    d_live = float(np.max(np.abs(a - b)[live]))
    d_all = float(np.max(np.abs(a - b)))
    bound = 1e-5
    check(d_live <= bound, f"max |d log10 posterior| = {d_live:.3g} > "
                           f"{bound} where p > 1e-6")
    rel_ll = abs(gpu["loglik_final"] - cpu["loglik_final"]) / abs(
        cpu["loglik_final"])
    check(rel_ll <= 1e-6, f"fitted log-likelihood differs by {rel_ll:.3g} "
                          f"(relative)")
    # what the drift does to the DB: entries present on one side only
    # (a score that crossed the threshold) and entries whose score bits moved
    tables = []
    for d in (gpu_dir, cpu_dir):
        db = serialize.load(os.path.join(d, "DB.ipk"))
        keys = np.repeat(db.keys, np.diff(db.offsets))   # k=8: 16-bit keys
        ids = (keys << np.uint64(32)) | db.branches.astype(np.uint64)
        order = np.argsort(ids)
        tables.append((ids[order], db.scores.view(np.uint32)[order]))
    (ia, sa), (ib, sb) = tables
    _, ca, cb = np.intersect1d(ia, ib, assume_unique=True,
                               return_indices=True)
    return {"size": cfg, "max_abs_dlog10_post_p_gt_1e-6": d_live,
            "max_abs_dlog10_post_all": d_all, "bound": bound,
            "db_entries": [len(ia), len(ib)],
            "db_entries_one_side_only": len(ia) + len(ib) - 2 * len(ca),
            "db_entries_score_bits_differ": int((sa[ca] != sb[cb]).sum()),
            "fit_rel_loglik_diff": rel_ll, "device": gpu, "cpu_child": cpu}


def _timed(fn, reps):
    """Best wall time of ``reps`` calls, each ended by block_until_ready."""
    import jax
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.monotonic()
        out = jax.block_until_ready(fn())
        best = min(best, time.monotonic() - t0)
    return best, out


def ab_turns(fa, fb, reps):
    """A, B, B, A: returns (t_a, t_b, out_a, out_b), each the best of its
    two turns (the first call of each also compiles and is discarded)."""
    import jax
    out_a = jax.block_until_ready(fa())
    out_b = jax.block_until_ready(fb())
    ta1, _ = _timed(fa, reps)
    tb1, _ = _timed(fb, reps)
    tb2, _ = _timed(fb, reps)
    ta2, _ = _timed(fa, reps)
    return min(ta1, ta2), min(tb1, tb2), out_a, out_b


def marker_stage1(state, reps) -> dict:
    """Stage 1 of the marker build at its own shape with each combine: the
    half tensors of every ghost, then per key batch the combine and the
    group max, each batch ended by block_until_ready. The rest of the build
    runs the same code on the same arrays whichever combine ran, so this is
    where the two backends differ end to end. The plain XLA combine may not
    fit the card at this size; that is recorded, not failed."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ipk_tpu.builder import _halves_fn, log_threshold_f32, pick_key_batches
    from ipk_tpu.core import dense
    from ipk_tpu.core.pallas_kernels import combine_max
    from ipk_tpu.seq import DNA
    m = state.get("marker")
    check(m is not None, "marker_k10 did not complete")
    on_gpu = state["device"]["platform"] == "gpu"
    P_all, group_ids, _ = ghost_tensor(m["proj"], DNA)
    k = m["k"]
    nl, nr = 4 ** (k // 2), 4 ** (k - k // 2)
    eps = log_threshold_f32(m["omega"], 4, k)
    t0 = time.monotonic()
    L, R = jax.block_until_ready(_halves_fn(k, 4)(
        jnp.asarray(P_all), jnp.asarray(dense.best_score_prefix(P_all)), eps))
    halves_s = time.monotonic() - t0
    batches = pick_key_batches(len(group_ids), nl, nr)
    step = nl // batches

    def run(b, combine):
        Lb = jax.lax.slice_in_dim(L, b * step, (b + 1) * step, axis=2)
        A_g, cnt = combine(Lb, R, eps, with_count=True)
        return dense.group_max(A_g.reshape(A_g.shape[0], -1), 2), cnt

    tri = lambda b: run(b, functools.partial(combine_max,  # noqa: E731
                                             interpret=not on_gpu))
    xla = lambda b: run(b, dense.combine_max_jnp)         # noqa: E731
    out = {"ghosts": int(P_all.shape[0]), "windows": int(L.shape[1]),
           "key_batches": batches, "halves_seconds": halves_s,
           "triton_seconds": 0.0, "xla_seconds": 0.0, "bit_equal": True}
    for b in range(batches):
        try:
            t_x, t_t, o_x, o_t = ab_turns(lambda: xla(b), lambda: tri(b),
                                          reps)
        except Exception as e:  # noqa: BLE001 -- only running out of memory
            # the card's allocator reports it as a ValueError or a
            # JaxRuntimeError, depending on where it runs out
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
            out["xla_error"] = str(e)[:300]
            break
        out["triton_seconds"] += t_t
        out["xla_seconds"] += t_x
        out["bit_equal"] &= bool(jnp.array_equal(o_x[0], o_t[0])
                                 and jnp.array_equal(o_x[1], o_t[1]))
        del o_x, o_t
    if "xla_error" in out:
        # the kernel alone, every batch
        out["triton_seconds"] = sum(_timed(lambda: tri(b), reps)[0]
                                    for b in range(batches))
        out.pop("xla_seconds")
    check(out["bit_equal"], "marker stage 1: Triton and XLA combines differ")
    return out


def phase_kernels(state):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ipk_tpu.core import dense
    from ipk_tpu.core.pallas_kernels import combine_max
    on_gpu = state["device"]["platform"] == "gpu"
    reps = state["size"]["reps"]
    rng = np.random.default_rng(SEED)
    out = {"dense": [], "triton_interpret": not on_gpu}

    # dense combine: Triton kernel vs the plain XLA combine
    for G, W, nl, nr in state["size"]["dense_shapes"]:
        # half-window scores in [-2, 0) with a quarter pruned (-inf)
        def halves(n):
            x = rng.random((G, W, n), dtype=np.float32) * -2.0
            x[x < -1.5] = -np.inf
            return jnp.asarray(x)
        L, R = halves(nl), halves(nr)
        eps = np.float32(-1.5)
        t_jnp, t_tri, (A0, c0), (A1, c1) = ab_turns(
            lambda: dense.combine_max_jnp(L, R, eps, block_w=32,
                                          with_count=True),
            lambda: combine_max(L, R, eps, with_count=True,
                                interpret=not on_gpu), reps)
        equal = bool(np.array_equal(np.asarray(A0), np.asarray(A1))
                     and np.array_equal(np.asarray(c0), np.asarray(c1)))
        cands = G * W * nl * nr
        out["dense"].append({
            "shape_G_W_nl_nr": [G, W, nl, nr], "xla_seconds": t_jnp,
            "triton_seconds": t_tri, "xla_cand_per_s": cands / t_jnp,
            "triton_cand_per_s": cands / t_tri, "bit_equal": equal,
            "survivors": int(np.asarray(c0).astype(np.int64).sum())})
        check(equal, f"Triton combine differs from XLA at {[G, W, nl, nr]}")
        del L, R, A0, A1

    out["marker_stage1"] = marker_stage1(state, reps)
    out["staircase"] = staircase_rows(state, rng, reps)
    return out


def staircase_rows(state, rng, reps) -> list:
    """The sparse staircase's slot lookup: rank query vs membership, at the
    span shapes (CL, CR, cap) that probe_caps picks for the two sparse
    phases, on synthetic scores of those shapes."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ipk_tpu.builder import log_threshold_f32
    from ipk_tpu.core import dense, sparse as sparse_mod
    from ipk_tpu.seq import get_traits
    from staircase_ref import _CHUNK_ELEMS, staircase_membership
    rows = []
    for name, traits_name in (("viral", "nucl"), ("protein", "amino")):
        cfg = state.get(name)
        check(cfg is not None, f"{name} phase did not complete")
        traits = get_traits(traits_name)
        P_all, _, _ = ghost_tensor(cfg["proj"], traits)
        sigma = traits.alphabet_size
        eps = log_threshold_f32(cfg["omega"], sigma, cfg["k"])
        prefix = dense.best_score_prefix(P_all)
        caps = sparse_mod.probe_caps(P_all, prefix, eps, k=cfg["k"],
                                     sigma=sigma,
                                     cap=cfg.get("cap", 4096))
        # one ghost chunk of the build (32 ghosts x all windows), but at
        # most as many windows as keep the membership version to 16 slot
        # chunks: it unrolls one chunk per _CHUNK_ELEMS of masks, and at a
        # full chunk it would compile hundreds (times are per window alike)
        windows = min(P_all.shape[0], 32) * (P_all.shape[1] - cfg["k"] + 1)
        for (j, h), cap in sorted(caps.items()):
            hl = h // 2
            CL = caps.get((j, hl), sigma)
            CR = caps.get((j + hl, h - hl), sigma)
            if CL * CR <= cap:
                continue                   # complete product, no staircase
            swap, _ = sparse_mod._policy(CL, CR, cap)
            if swap:                       # the operand order the build uses
                CL, CR = CR, CL
            G, W = 1, max(16, min(windows, _CHUNK_ELEMS * 16
                                  // (cap * max(CL, CR))))
            sL = rng.uniform(-6, 0, (G, W, CL)).astype(np.float32)
            sR = rng.uniform(-6, 0, (G, W, CR)).astype(np.float32)
            cL = rng.integers(0, 1 << 30, (G, W, CL)).astype(np.uint32)
            cR = rng.integers(0, 1 << 30, (G, W, CR)).astype(np.uint32)
            # a threshold that keeps about cap/2 survivors per window
            first = (sL[0, 0][:, None] + sR[0, 0][None, :]).ravel()
            e = np.float32(np.sort(first)[::-1][min(len(first), cap) // 2])
            epsw = jnp.full((G, W), e, jnp.float32)
            cRs, sRs = sparse_mod._sort_desc(jnp.asarray(cR), jnp.asarray(sR))
            args = (jnp.asarray(cL), jnp.asarray(sL), cRs, sRs, epsw)
            rank = jax.jit(lambda *a: sparse_mod._staircase_xla(
                *a, cap=cap, shift=None))
            memb = jax.jit(lambda *a: staircase_membership(
                *a, cap=cap, shift=None))
            t_m, t_r, o_m, o_r = ab_turns(lambda: memb(*args),
                                          lambda: rank(*args), reps)
            equal = all(np.array_equal(np.asarray(x), np.asarray(y))
                        for x, y in zip(jax.tree.leaves(o_m),
                                        jax.tree.leaves(o_r)))
            rows.append({
                "config": name, "span": [j, h], "CL": CL, "CR": CR,
                "cap": cap, "windows": G * W, "membership_seconds": t_m,
                "rank_seconds": t_r, "bit_equal": equal})
            check(equal, f"rank query differs from membership at {name} "
                         f"span {(j, h)}")
    return rows


def _multi_builds(state, name, tags):
    """The ``name`` build pinned to one card ("one"), sharded over every
    visible card ("all") and, for "mi", sharded with --device-mi.
    Returns ({tag: DB path}, {tag: result record})."""
    import jax
    n = jax.device_count()
    check(n > 1, f"--multi needs several cards, JAX sees {n}")
    cfg = state["size"][f"multi_{name}"]
    work = state["work"]
    proj = project(work, name, cfg["leaves"], cfg["width"])
    extra = ("--max-candidates", str(cfg["cap"])) if "cap" in cfg else ()
    paths, out = {}, {"cards": n, "size": cfg}
    for tag in tags:
        paths[tag] = os.path.join(work, name, f"DB_{tag}.ipk")
        argv = build_argv(proj, os.path.join(work, name, f"wd_{tag}"),
                          paths[tag], k=cfg["k"], omega=cfg["omega"],
                          extra=extra + (("--device-mi",)
                                         if tag == "mi" else ()))
        if tag == "one":
            os.environ["IPK_TPU_NO_SHARD"] = "1"
        try:
            result, wall, compile_s = cli_build(argv, state["clock"])
        finally:
            os.environ.pop("IPK_TPU_NO_SHARD", None)
        out[tag] = {"wall_seconds": wall, "compile_seconds": compile_s,
                    "timings": result.timings,
                    "db_entries": result.db.num_entries()}
        del result
    with open(paths["one"], "rb") as a, open(paths["all"], "rb") as b:
        same = a.read() == b.read()
    out["byte_identical"] = same
    check(same, f"{name}: {n}-card DB differs from the one-card DB")
    return paths, out


def phase_multi_marker(state):
    """marker_k10 sharded over every card, byte-identical to one card; a
    --device-mi build against the one-card host-f64 DB."""
    import numpy as np
    from ipk_tpu import serialize
    paths, out = _multi_builds(state, "marker", ("one", "all", "mi"))
    host, dev = serialize.load(paths["one"]), serialize.load(paths["mi"])
    ho, do = np.argsort(host.keys), np.argsort(dev.keys)
    check(np.array_equal(host.keys[ho], dev.keys[do]),
          "--device-mi key set differs")

    def entries(db, order):
        counts = np.diff(db.offsets)[order]
        starts = db.offsets[:-1][order]
        idx = np.concatenate([np.arange(s, s + c) for s, c in
                              zip(starts, counts)])
        return counts, db.branches[idx], db.scores[idx].view(np.uint32)

    for x, y, what in zip(entries(host, ho), entries(dev, do),
                          ("counts", "branches", "score bits")):
        check(np.array_equal(x, y), f"--device-mi entry {what} differ")
    # f32 device reduction vs the host's f64: the tolerance of
    # tests/test_builder_modes.py::test_device_mi_build
    fv_h = host.filter_values[ho].astype(np.float64)
    fv_d = dev.filter_values[do].astype(np.float64)
    diff = np.abs(fv_h - fv_d)
    out["device_mi_fv_max_abs_diff"] = float(diff.max())
    excess = float((diff - (1e-7 + 2e-5 * np.abs(fv_h))).max())
    check(excess <= 0, f"--device-mi filter values off by {excess:.3g} "
                       "beyond tolerance")
    out["memory"] = memory_stats()
    return out


def phase_multi_viral(state):
    """viral_k12 sharded over every card (sparse enumeration and the device
    key merge's all_to_all), byte-identical to one card."""
    import ipk_tpu.parallel.key_merge as key_merge
    from ipk_tpu.parallel.key_merge import KeyMergeOverflow
    real = key_merge.device_key_merge
    merges = []

    def counted(*args, **kwargs):
        try:
            res = real(*args, **kwargs)
        except KeyMergeOverflow:
            merges.append("overflow")
            raise
        merges.append("stream")
        return res

    key_merge.device_key_merge = counted
    try:
        _, out = _multi_builds(state, "viral", ("one", "all"))
    finally:
        key_merge.device_key_merge = real
    out["device_key_merge"] = merges
    check(merges == ["stream"], f"the sharded build's device key merge did "
                                f"not run to its end: {merges}")
    out["memory"] = memory_stats()
    return out


# ---------------------------------------------------------------------------
# phases in order, and the entry point
# ---------------------------------------------------------------------------

DEFAULT_PHASES = [("marker_k10", phase_marker),
                  ("oracle_sample", phase_oracle_sample),
                  ("cpu_parity", phase_cpu_parity),
                  ("viral_k12", phase_viral),
                  ("protein_k6", phase_protein),
                  ("placement", phase_placement),
                  ("native_ar", phase_native_ar),
                  ("kernels", phase_kernels)]


def run_phase(name, fn, state) -> bool:
    t0 = time.monotonic()
    try:
        info = fn(state) or {}
        ok = True
    except Exception as e:       # recorded; any failed phase fails the run
        info = {"error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-3000:]}
        ok = False
    rec = {"phase": name, "ok": ok, "seconds": time.monotonic() - t0,
           "host_peak_rss_bytes": 1024 * resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss, **info}
    print(json.dumps(rec, default=str), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="full",
                    help="'tiny' shrinks every phase for a CPU rehearsal")
    ap.add_argument("--multi", action="store_true",
                    help="run only the branch-sharded builds on every "
                         "visible card against one-card builds")
    ap.add_argument("--workdir", default="",
                    help="keep inputs and outputs here (default: a "
                         "temporary directory, removed at exit)")
    ap.add_argument("--native-ar-child", nargs="+",
                    metavar="PROJ FIT OUT STEPS...", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

    if args.native_ar_child:
        proj_dir, fit_dir, out_dir, *steps = args.native_ar_child
        print(json.dumps(native_ar_outputs(proj_dir, fit_dir, out_dir,
                                           [int(s) for s in steps])))
        return 0

    if not args.multi:
        restrict_to_one_card()
    # one process runs every phase: let freed buffers go back to the system
    # between phases. The CLI's default keeps the heap at its high-water mark
    # (ipk_tpu/utils/malloc_tune.py), which this run's phases would stack up:
    # a marker build alone peaks near 80 GB of host memory. Builds here are
    # therefore timed off the CLI's default heap setting; phase_marker says so.
    os.environ.setdefault("IPK_TPU_NO_MALLOC_TUNE", "1")
    from ipk_tpu.utils.cache import enable_compilation_cache
    state = {"size": SIZES[args.size], "cache_dir": enable_compilation_cache()}
    state["clock"] = CompileClock()
    if args.size != "full":
        print(json.dumps({"reduced": f"--size {args.size}: every phase "
                          "shrunk for a rehearsal", "sizes": state["size"]},
                         default=str), flush=True)
    elif args.multi:
        mm, mv = state["size"]["multi_marker"], state["size"]["multi_viral"]
        print(json.dumps({"reduced": (
            f"--multi: marker_k10 cut from 512 to {mm['leaves']} leaves, "
            f"viral_k12 from 64 x 3000 to {mv['leaves']} x {mv['width']} "
            "(four-card time budget; the viral size lets the whole "
            "enumeration fit the device key merge's budget)")}), flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        state["work"] = args.workdir or tmp
        os.makedirs(state["work"], exist_ok=True)
        ok = run_phase("device", phase_device, state)
        if not ok and args.size == "full":
            # no GPU: the full-size phases would run on the host for hours
            print(json.dumps({"stopped": state.get("device_error")}),
                  flush=True)
            return 1
        phases = ([("multi_marker", phase_multi_marker),
                   ("multi_viral", phase_multi_viral)] if args.multi
                  else DEFAULT_PHASES)
        for name, fn in phases:
            ok = run_phase(name, fn, state) and ok
    print(nvidia_smi(), flush=True)
    if not ok or state["device"]["platform"] != "gpu":
        return 1
    print(json.dumps({"ok": True, "device": state["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
