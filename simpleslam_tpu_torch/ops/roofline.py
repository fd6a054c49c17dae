"""Analytic roofline model for the LOAM registration batch on the GPU.

Port of ``simpleslam_tpu/ops/roofline.py``: the FLOP and byte counts of one
streamed registration batch, so a measured device time (``run_streamed``
with ``device_probe=True``) can be placed against what the card could do at
best. Cost structure: per candidate gather (about once per scan) each of the
N queries reads one merged map row from device memory and the 5-NN /
plane-fit chain does about 45 flops per candidate once; each GN iteration
then costs about 250 per-query flops against the frozen planes. There is no
matrix work in it: the model exists to locate the batch against the memory
bound, not to flatter it.

Peaks are the published ones of one NVIDIA H100 SXM at its full 700 W power
limit (NVIDIA's data sheet): 3.35 TB/s of HBM3 bandwidth, and 67 TFLOP/s of
f32 outside the tensor cores, which is the rate that applies since the
kernels do no matrix products. A card set below 700 W runs below them.
"""

from __future__ import annotations

from typing import Dict

H100_SXM_HBM_BYTES_PER_S = 3.35e12      # HBM3 bandwidth, bytes/s
H100_SXM_F32_NON_TENSOR_FLOPS = 67e12   # f32 FLOP/s outside the tensor cores

# flops per (query, candidate) of the normal-equation chain: d2 (8) + 5
# argmin rounds (~5 x 4) + centroid/scatter/eigen accumulation (~15) +
# masked residual contributions (~2). Order-of-magnitude deliberate: the
# conclusion (memory-bound) is insensitive to +-2x here.
_FLOPS_PER_CAND = 45
# per-query flops independent of candidates: point transform, 3x3 symeig,
# J row, 6x6 outer products (~250)
_FLOPS_PER_QUERY = 250


def loam_batch_cost(n_queries: int, slab_rows: int, lane_width: int,
                    slab_pts: int, n_scans: int, mean_iters: float,
                    mean_gathers: float,
                    lane_bytes: float = 2.0) -> Dict[str, float]:
    """FLOPs and device-memory bytes of one streamed registration batch.

    n_queries: padded query points per scan (the scan-row capacity)
    slab_rows: rows gathered per query (1 for the merged gather)
    lane_width: values per gathered row (8 * slab_pts * 3 merged)
    slab_pts: points stored per VOXEL (tpu.loam_slab_size)
    mean_iters / mean_gathers: measured per-scan GN iterations and gather
    refreshes. The candidate-axis flops are paid per GATHER; iterations pay
    only the per-query frozen-plane work.
    lane_bytes: bytes per row value: 2 for the int16 rows of the merged map,
    the only rows this package's batch reads (4 gives the count of the
    reference, whose rows are f32).
    """
    cand_pts = 8 * slab_pts
    gather_bytes = (n_scans * mean_gathers * n_queries
                    * slab_rows * lane_width * lane_bytes)
    flops = n_scans * n_queries * (
        mean_gathers * cand_pts * _FLOPS_PER_CAND
        + mean_iters * _FLOPS_PER_QUERY)
    return {"flops": flops, "hbm_bytes": gather_bytes,
            "cand_pts_per_query": float(cand_pts)}


def utilization(cost: Dict[str, float], device_s: float) -> Dict[str, float]:
    """Share of the f32 peak (``mfu``), of the memory bandwidth
    (``hbm_util``) and of the speed of light (``sol_frac``: the larger of
    the two least times over the measured one) for a measured device time."""
    if device_s <= 0:
        return {"mfu": 0.0, "hbm_util": 0.0, "sol_frac": 0.0}
    mfu = cost["flops"] / device_s / H100_SXM_F32_NON_TENSOR_FLOPS
    hbm = cost["hbm_bytes"] / device_s / H100_SXM_HBM_BYTES_PER_S
    sol_time = max(cost["flops"] / H100_SXM_F32_NON_TENSOR_FLOPS,
                   cost["hbm_bytes"] / H100_SXM_HBM_BYTES_PER_S)
    return {
        "mfu": round(mfu, 6),
        "hbm_util": round(hbm, 6),
        "sol_frac": round(sol_time / device_s, 6),
    }
