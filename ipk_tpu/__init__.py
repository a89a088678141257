"""ipk_tpu: an accelerator-native phylo-k-mer database construction framework.

A from-scratch rebuild of the capabilities of phylo42/IPK (reference surveyed
in SURVEY.md) designed for accelerators (an NVIDIA H100): the divide-and-conquer k-mer
enumeration becomes a dense, masked, level-wise combine over the candidate
space executed by XLA/Pallas; per-branch hash maps become dense max
accumulators; branches shard data-parallel over a device mesh.

Layers (cf. SURVEY.md §7.2):
  seq / tree / alignment       host.io: alphabets, newick, ghost extension
  ar                           AR bridge: raxml-ng subprocess + replay, TSV reader
  core.dense                   the enumeration DP (jnp + Pallas kernels)
  core.filter                  mif0 / random informativeness filters
  builder / pipeline           stage 1-3 orchestration
  db / serialize / tools       the .ipk container, diff/dump
  parallel                     mesh sharding for multi-chip/multi-host builds
  cli                          the ``build``/``diff``/``dump`` commands
"""

__version__ = "0.1.0"
