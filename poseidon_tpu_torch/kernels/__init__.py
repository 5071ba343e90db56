"""Hand-written Hopper kernels of the dense auction, each beside its
plain PyTorch twin and its launch counter.

A wrapper launches its CUDA kernel for CUDA tensors and runs the plain
twin for CPU tensors; there is no fallback from one to the other.
"""

from poseidon_tpu_torch.kernels import bid_pass, densify, row_options

KERNELS = (densify.KERNEL, row_options.KERNEL, bid_pass.KERNEL)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "reset_launch_counts", "bid_pass", "densify", "row_options"]
