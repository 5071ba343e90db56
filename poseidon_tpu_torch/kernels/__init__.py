"""Hand-written Hopper kernels of the dense auction, the express and
stream lanes, the what-if batch and the sharded certificate, each
beside its plain PyTorch twin and its launch counter.

A wrapper launches its CUDA kernel for CUDA tensors and runs the plain
twin for CPU tensors; there is no fallback from one to the other.
"""

from poseidon_tpu_torch.kernels import (
    bid_pass,
    densify,
    express_patch,
    express_rows,
    gap_rows,
    perturb,
    row_options,
    stream_commit,
)

KERNELS = (densify.KERNEL, row_options.KERNEL, bid_pass.KERNEL,
           express_rows.KERNEL, express_patch.KERNEL, perturb.KERNEL,
           stream_commit.KERNEL, gap_rows.KERNEL)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "reset_launch_counts", "bid_pass", "densify",
           "express_patch", "express_rows", "gap_rows", "perturb",
           "row_options", "stream_commit"]
