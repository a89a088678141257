"""Command-line interface.

Mirrors the reference wrapper's surface (``ipk.py:70-202``: same option names,
defaults, and validation) and folds the verification tools in as subcommands:

* ``build`` — compute a phylo-k-mer database (the one true entry point,
  SURVEY.md §3.1).
* ``diff``  — compare two databases; unlike the reference ``ipkdiff`` which
  always exits 0 (``tools/src/diff.cpp:115-116``), exits non-zero on mismatch.
* ``dump``  — plain-text dump in the reference's format: k-mer line, then
  per-entry "\\t<10^score>\\t<preorder id>" (``tools/src/dump.cpp:18-33``).

Unlike the reference there is no triple-binary dispatch: the alphabet is a
runtime parameter (``--states``), positions a flag.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .ar.bridge import NUCL_MODELS, AMINO_MODELS

ALL_MODELS = NUCL_MODELS + AMINO_MODELS
KMER_FILTERS = ["mif0", "random"]
GHOST_STRATEGIES = ["inner-only", "outer-only", "both"]


def parse_config(ar_config: str) -> str:
    """--ar-config JSON → raw --ar-parameters string (``ipk.py:241-250``)."""
    with open(ar_config) as f:
        content = json.load(f)
    if "arguments" not in content:
        raise RuntimeError(f"Error parsing {ar_config}: 'arguments' not found")
    return " ".join(f"--{k} {v}" for k, v in content["arguments"].items())


def _existing_path(value: str) -> str:
    if not os.path.exists(value):
        raise argparse.ArgumentTypeError(f"Path '{value}' does not exist.")
    return value


def _existing_dir(value: str) -> str:
    if not os.path.isdir(value):
        raise argparse.ArgumentTypeError(
            f"Directory '{value}' does not exist.")
    return value


def _build_options(p: argparse.ArgumentParser) -> None:
    p.add_argument("-b", "--ar", help=(
        "Path to the ancestral reconstruction binary (RAxML-ng), or the "
        "literal 'native' to use the built-in JAX ancestral reconstruction "
        "(GTR+G, empirical frequencies; add --ar-optimize to ML-fit branch "
        "lengths and model parameters on device)."))
    p.add_argument("-r", "--refalign", type=_existing_path, required=True,
                   help="Reference multiple sequence alignment in FASTA "
                        "format.")
    p.add_argument("-t", "--reftree", type=_existing_path, required=True,
                   help="Reference phylogenetic tree in Newick format.")
    p.add_argument("-s", "--states", choices=["nucl", "amino"],
                   default="nucl")
    p.add_argument("-v", "--verbosity", type=int, default=1)
    p.add_argument("-w", "--workdir", required=True)
    p.add_argument("-a", "--alpha", type=float, default=1.0)
    p.add_argument("-c", "--categories", type=int, default=4)
    p.add_argument("-k", "--k", type=int, default=8)
    p.add_argument("-m", "--model")
    p.add_argument("--convert-uo", action="store_true",
                   help="Convert U, O amino acids to C, L.")
    p.add_argument("--write-reduction",
                   help="Write reduced alignment to file.")
    p.add_argument("--bb", dest="algorithm", action="store_const", const="BB",
                   help="Use the branch-and-bound enumeration algorithm.")
    p.add_argument("--dc", dest="algorithm", action="store_const", const="DC",
                   help="Use the divide-and-conquer enumeration algorithm.")
    p.add_argument("--dcla", dest="algorithm", action="store_const",
                   const="DCLA",
                   help="Use divide-and-conquer with lookahead (default).")
    p.add_argument("--dccw", dest="algorithm", action="store_const",
                   const="DCCW",
                   help="Use divide-and-conquer with chained windows.")
    p.set_defaults(algorithm="DCLA")
    p.add_argument("--no-reduction", action="store_true")
    p.add_argument("--reduction-ratio", type=float, default=0.99)
    p.add_argument("--omega", type=float, default=1.5)
    p.add_argument("--filter", type=str.lower, choices=KMER_FILTERS,
                   default="mif0")
    p.add_argument("-u", "--mu", type=float, default=1.0)
    p.add_argument("--ghosts", type=str.lower, choices=GHOST_STRATEGIES,
                   default="both")
    p.add_argument("--use-unrooted", action="store_true")
    p.add_argument("--merge-branches", action="store_true")
    p.add_argument("--ar-dir", type=_existing_dir)
    p.add_argument("--ar-only", action="store_true")
    p.add_argument("--ar-config", type=_existing_path)
    p.add_argument("--ar-optimize", action="store_true", help=(
        "With --ar native: ML-optimize branch lengths, GTR rates and the "
        "Gamma shape before computing posteriors (the native analog of "
        "raxml-ng's --opt-model/--opt-branches)."))
    p.add_argument("--ar-opt-steps", type=int, default=200,
                   help="Gradient steps for --ar-optimize.")
    p.add_argument("--keep-positions", action="store_true")
    p.add_argument("--uncompressed", action="store_true")
    p.add_argument("--threads", type=int, default=0, help=(
        "Host threads for the native filter, deflate and gather pools AND "
        "the AR subprocess. 0 = auto (all cores). The reference forwards "
        "--threads to AR only; here N pins every host pool (env "
        "IPK_TPU_THREADS overrides)."))
    p.add_argument("-o", "--output", help="Output file name")
    p.add_argument("--on-disk", action="store_true")
    p.add_argument("--max-candidates", type=int, default=4096, help=(
        "Per-window survivor-list capacity on the large-k path; the build "
        "fails loudly if exceeded."))
    p.add_argument("--profile", dest="profile_dir", default="", help=(
        "Write a jax.profiler device trace of the build to DIR (view with "
        "TensorBoard / xprof)."))
    p.add_argument("--device-mi", action="store_true", help=(
        "Compute the mif0 filter on device via collective reductions (f32) "
        "instead of the host f64 pass - for multi-device builds where the "
        "entry set should not be gathered to one host."))
    p.add_argument("--coordinator", default="", help=(
        "Multi-host: coordinator address host:port for jax.distributed "
        "(same on every host)."))
    p.add_argument("--num-hosts", type=int, default=0,
                   help="Multi-host: total number of processes in the job.")
    p.add_argument("--host-id", type=int, default=-1,
                   help="Multi-host: this process's id in [0, num-hosts).")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ipk-tpu",
        description="Phylo-k-mer database construction on an accelerator.")
    parser.add_argument("--version", action="version",
                        version="ipk-tpu, version 0.1.0")
    sub = parser.add_subparsers(dest="command", required=True)
    fmt = argparse.ArgumentDefaultsHelpFormatter

    p = sub.add_parser("build", formatter_class=fmt,
                       help="Compute a database of phylo-k-mers.",
                       description="Compute a database of phylo-k-mers.")
    _build_options(p)

    p = sub.add_parser("diff", formatter_class=fmt, help=(
        "Compare two databases field by field; exit 1 on any difference."))
    p.add_argument("db1", type=_existing_path)
    p.add_argument("db2", type=_existing_path)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--eps", type=float, default=0.0, help=(
        "Score tolerance; 0 = exact (reference ipkdiff uses 1e-2)."))

    p = sub.add_parser("dump", formatter_class=fmt, help=(
        "Plain-text dump (format of the reference ipkdump, dump.cpp:18-33)."))
    p.add_argument("database", type=_existing_path)

    p = sub.add_parser("place", formatter_class=fmt, help=(
        "Place query sequences (FASTA) against a database; writes jplace "
        "v3."))
    p.add_argument("database", type=_existing_path)
    p.add_argument("queries", type=_existing_path)
    p.add_argument("-o", "--output", required=True,
                   help="Output .jplace file")
    p.add_argument("--top", type=int, default=7,
                   help="Number of best branches reported per query.")

    p = sub.add_parser("diff-text", formatter_class=fmt, help=(
        "Tolerant comparison ignoring threshold-boundary k-mers (the "
        "diff-plain-text.py analog); exit 1 on differences."))
    p.add_argument("db1", type=_existing_path)
    p.add_argument("db2", type=_existing_path)
    p.add_argument("--eps", type=float, default=1e-3,
                   help="Linear-space score tolerance.")
    return parser


def _build(args, parser) -> int:
    if not args.ar_config and args.model not in ALL_MODELS:
        parser.error(
            f"Please define a valid evolutionary model either via --model "
            f"or in a config file via --ar-config. Valid values: "
            f"{ALL_MODELS}")
    if args.states == "nucl" and args.keep_positions:
        parser.error("--keep-positions is not supported for DNA.")
    if args.num_hosts and args.num_hosts > 1:
        # must run before the first device query (jax.distributed contract)
        from .parallel.mesh import initialize_distributed
        initialize_distributed(
            coordinator=args.coordinator or None,
            num_processes=args.num_hosts,
            process_id=args.host_id if args.host_id >= 0 else None)
    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from .pipeline import BuildParams, build_database
    params = BuildParams(
        refalign=args.refalign, reftree=args.reftree, states=args.states,
        working_dir=args.workdir,
        output_filename=args.output or os.path.join(args.workdir, "DB.ipk"),
        ar_binary=args.ar or "", ar_dir=args.ar_dir or "",
        ar_parameters=(parse_config(args.ar_config) if args.ar_config
                       else ""),
        ar_only=args.ar_only, ar_optimize=args.ar_optimize,
        ar_opt_steps=args.ar_opt_steps, model=args.model or "GTR",
        alpha=args.alpha, categories=args.categories, kmer_size=args.k,
        omega=args.omega, mu=args.mu, reduction_ratio=args.reduction_ratio,
        no_reduction=args.no_reduction, filter=args.filter,
        ghosts=args.ghosts, use_unrooted=args.use_unrooted,
        merge_branches=args.merge_branches,
        keep_positions=args.keep_positions, uncompressed=args.uncompressed,
        on_disk=args.on_disk, num_threads=args.threads,
        algorithm=args.algorithm, convert_uo=args.convert_uo,
        write_reduction=args.write_reduction or "",
        max_candidates=args.max_candidates, profile_dir=args.profile_dir,
        device_mi=args.device_mi, verbosity=args.verbosity)
    build_database(params)
    return 0


def _place(args) -> int:
    from . import serialize
    from .alignment import read_fasta
    from .placement import place_queries, write_jplace
    db = serialize.load(args.database)
    placements = place_queries(db, read_fasta(args.queries), top=args.top)
    write_jplace(db, placements, args.output)
    print(f"Placed {len(placements)} queries -> {args.output}")
    return 0


def main(argv=None) -> int:
    """Run one subcommand; returns its exit code. Usage errors (unknown
    options, bad choices, missing paths) exit with status 2."""
    parser = make_parser()
    args = parser.parse_args(argv)
    from .utils.malloc_tune import retain_heap
    retain_heap()
    if args.command == "build":
        return _build(args, parser)
    if args.command == "diff":
        from .tools import diff_databases
        ok = diff_databases(args.db1, args.db2, verbose=args.verbose,
                            eps=args.eps)
        return 0 if ok else 1
    if args.command == "dump":
        from .tools import dump_database
        dump_database(args.database, sys.stdout)
        return 0
    if args.command == "place":
        return _place(args)
    from .tools import diff_plain_text
    return 0 if diff_plain_text(args.db1, args.db2, eps=args.eps) else 1


def ipk() -> None:
    """Console-script entry point (``ipk-tpu``)."""
    sys.exit(main())


if __name__ == "__main__":
    ipk()
