"""Hand-written Hopper kernels of the dense auction (its row passes,
the deflate step's selection, the seat-layout sorts and the loops'
control kernel K14, which drives the auction's and the general lane's
CUDA graphs), the express and
stream lanes, the what-if batch, the sharded certificate and the
general-graph solvers (cost-scaling and successive shortest paths), each
beside its plain PyTorch twin and its launch counter.

A wrapper launches its CUDA kernel for CUDA tensors and runs the plain
twin for CPU tensors; there is no fallback from one to the other.
"""

from poseidon_tpu_torch.kernels import (
    bf_relax,
    bid_pass,
    cs_sweep,
    densify,
    express_patch,
    express_rows,
    gap_rows,
    loop_graph,
    perturb,
    row_options,
    seat_sort,
    ssp_augment,
    stream_commit,
    top_will,
)

KERNELS = (densify.KERNEL, row_options.KERNEL, bid_pass.KERNEL,
           express_rows.KERNEL, express_patch.KERNEL, perturb.KERNEL,
           stream_commit.KERNEL, gap_rows.KERNEL, cs_sweep.KERNEL,
           bf_relax.KERNEL, ssp_augment.KERNEL, top_will.KERNEL,
           seat_sort.KERNEL, loop_graph.KERNEL)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "reset_launch_counts", "bf_relax", "bid_pass",
           "cs_sweep", "densify", "express_patch", "express_rows",
           "gap_rows", "loop_graph", "perturb", "row_options", "seat_sort",
           "ssp_augment", "stream_commit", "top_will"]
