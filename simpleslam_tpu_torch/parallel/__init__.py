"""Multi-device execution over ``torch.distributed``: rank meshes, sharded
registration, the edge-sharded pose-graph solve, and a launcher of ranks.

Port of ``simpleslam_tpu/parallel/`` (which drives a device mesh from one
process through ``shard_map``) in the torch idiom: one process per rank,
every rank running the same program (SPMD). A rank holds its own block of
the sharded axis (a scan's points, a pose graph's edges) and the replicated
state in full; every cross-rank sum is an ``all_gather`` of the per-rank
partials followed by a sum in rank order, so all ranks hold bit-identical
results (``mesh.Axis.gather_sum``).
"""
