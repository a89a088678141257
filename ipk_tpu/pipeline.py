"""End-to-end database build: alignment → tree extension → AR → device build.

Counterpart of the reference driver ``ipk/src/main.cpp:129-199``
(``build_database``) — the single entry the CLI calls. Stage order and
artifacts replicate the reference exactly:

* ``<workdir>/align.reduced.fasta`` (``alignment.cpp:266-269``)
* ``<workdir>/extended_trees/extended_tree.newick`` (``main.cpp:39-46``)
* ``<workdir>/extended_trees/extended_align.{fasta,phylip}`` (``main.cpp:48-63``)
* ``<workdir>/AR/ar_tree_rerooted.newick`` when AR unroots a rooted input
  (``main.cpp:65-74,170-178``)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from .seq import get_traits
from . import alignment as aln
from . import tree as tr
from .ar import bridge
from .ar.mapping import map_nodes
from .ar.reader import read_ancestral_probs
from .builder import build, BuildResult

__all__ = ["BuildParams", "build_database"]


@dataclasses.dataclass
class BuildParams:
    """Mirror of the CLI parameter surface (``ipk.py:70-202``,
    ``command_line.h:18-86``)."""
    refalign: str = ""
    reftree: str = ""
    states: str = "nucl"
    working_dir: str = ""
    output_filename: str = ""
    ar_binary: str = ""
    ar_dir: str = ""
    ar_parameters: str = ""
    ar_only: bool = False
    ar_optimize: bool = False    # native AR: ML-fit branch lengths/rates/alpha
    ar_opt_steps: int = 200
    model: str = "GTR"
    alpha: float = 1.0
    categories: int = 4
    kmer_size: int = 8
    omega: float = 1.5
    mu: float = 1.0              # accepted but dead, like the reference
    reduction_ratio: float = 0.99
    no_reduction: bool = False
    filter: str = "mif0"
    ghosts: str = "both"
    algorithm: str = "DCLA"      # --BB/--DC/--DCLA/--DCCW accepted; like the
                                 # reference, DCLA is what runs (db_builder.cpp:648)
    convert_uo: bool = False
    write_reduction: str = ""
    max_candidates: int = 4096   # survivor-list cap on the sparse large-k path
    profile_dir: str = ""        # write a jax.profiler trace of the build
    use_unrooted: bool = False
    merge_branches: bool = False
    keep_positions: bool = False
    uncompressed: bool = False
    on_disk: bool = False
    device_mi: bool = False      # pod-scale: keep the MI filter on device
    num_threads: int = 0         # 0 = auto; N pins every host pool AND the
                                 # AR subprocess (the reference forwards
                                 # --threads to AR only, command_line.cpp:123)
    verbosity: int = 1


def build_database(p: BuildParams) -> Optional[BuildResult]:
    from .utils.threads import set_host_threads
    set_host_threads(p.num_threads)
    ar_threads = p.num_threads if p.num_threads > 0 else (os.cpu_count() or 1)
    traits = get_traits(p.states)
    if p.kmer_size > traits.max_kmer_length:
        raise RuntimeError(f"Maximum k-mer size allowed: {traits.max_kmer_length}")
    if p.merge_branches and not p.keep_positions and p.verbosity > 0:
        # deviation from the reference, which hard-rejects this combination
        # (``main.cpp:31-37``) because branch merging only exists in its
        # aa-pos build variant; here it works in every mode
        print("Note: --merge-branches without --keep-positions is an "
              "ipk_tpu extension (the reference rejects it).")

    # L5: alignment preprocessing
    align = aln.preprocess_alignment(p.working_dir, p.refalign,
                                     p.reduction_ratio, p.no_reduction,
                                     traits, p.verbosity,
                                     convert_uo_flag=p.convert_uo,
                                     write_reduction=p.write_reduction)

    # L5: tree extension
    original_tree, extended_tree, ghost_mapping = tr.preprocess_tree(
        p.reftree, p.use_unrooted)
    ext_dir = os.path.join(p.working_dir, "extended_trees")
    os.makedirs(ext_dir, exist_ok=True)
    ext_tree_file = os.path.join(ext_dir, "extended_tree.newick")
    tr.save_tree(extended_tree, ext_tree_file)

    extended = aln.extend_alignment(align, extended_tree, traits)
    fasta_path = os.path.join(ext_dir, "extended_align.fasta")
    phylip_path = os.path.join(ext_dir, "extended_align.phylip")
    aln.save_alignment(extended, fasta_path, "fasta")
    aln.save_alignment(extended, phylip_path, "phylip")

    # L4: ancestral reconstruction (native JAX, subprocess, or --ar-dir replay)
    if p.ar_binary == "native" and not p.ar_dir:
        from .ar.native import run_native_ar
        probs_file, ar_tree_file = run_native_ar(
            extended_tree, extended, p.working_dir, traits,
            alpha=p.alpha, categories=p.categories,
            optimize=p.ar_optimize, opt_steps=p.ar_opt_steps,
            verbosity=p.verbosity)
    else:
        ar_params = bridge.ArParameters(
            binary_file=p.ar_binary, ar_dir=p.ar_dir,
            ar_parameters=p.ar_parameters, model=p.model, alpha=p.alpha,
            categories=p.categories, num_threads=ar_threads,
            tree_file=ext_tree_file, alignment_file=phylip_path)
        if p.ar_dir:
            # replay: detect which tool produced the directory by suffix
            # (raxml-ng first, then phyml — ``ar.cpp:599-640,497-537``)
            software = "raxml-ng"
            if (bridge._find_file_by_suffix(
                    p.ar_dir, bridge.RaxmlWrapper.PROBS_SUFFIX) is None
                    and os.path.isdir(p.ar_dir)
                    and bridge._find_file_by_suffix(
                        p.ar_dir, bridge.PhymlWrapper.MATRIX_SUFFIX)):
                software = "phyml"
        else:
            binary = p.ar_binary or bridge.find_raxmlng()
            ar_params.binary_file = binary
            software = bridge.guess_software(binary, p.working_dir)
        probs_file, ar_tree_file = bridge.run_ancestral_reconstruction(
            software, ar_params)
        if software == "phyml":
            # the invocation/replay succeeds (parity with ar.cpp:481-582),
            # but READING phyml posteriors is unsupported — the reference's
            # reader throws the same way (``ar.cpp:77-81``)
            raise RuntimeError("PhyML is not supported in this version.")

    if p.ar_only:
        if p.verbosity > 0:
            print("--ar-only requested. Finishing after ancestral "
                  "reconstruction.")
        return None

    # AR unroots a rooted input; re-root it back (``main.cpp:170-178``)
    ar_tree = tr.load_newick(ar_tree_file)
    if original_tree.is_rooted() and not ar_tree.is_rooted():
        tr.reroot_tree(ar_tree)
        ar_dir_out = os.path.join(p.working_dir, "AR")
        os.makedirs(ar_dir_out, exist_ok=True)
        tr.save_tree(ar_tree, os.path.join(ar_dir_out,
                                           "ar_tree_rerooted.newick"))

    ar_mapping = map_nodes(extended_tree, ar_tree)
    label_rows, P = read_ancestral_probs(probs_file, traits)

    output = p.output_filename or os.path.join(p.working_dir, "DB.ipk")

    def run_build():
        return build(original_tree, extended_tree, ghost_mapping, ar_mapping,
                     label_rows, P,
                     traits=traits, kmer_size=p.kmer_size, omega=p.omega,
                     filter_type=p.filter, ghost_strategy=p.ghosts,
                     merge_branches=p.merge_branches,
                     keep_positions=p.keep_positions,
                     output_filename=output, uncompressed=p.uncompressed,
                     on_disk=p.on_disk, working_dir=p.working_dir,
                     sparse_cap=p.max_candidates, device_mi=p.device_mi,
                     verbose=p.verbosity)

    if p.profile_dir:
        # structured device profiling — the reference has only wall-clock
        # stage timers (SURVEY.md §5 tracing row)
        import jax
        with jax.profiler.trace(p.profile_dir):
            return run_build()
    return run_build()
