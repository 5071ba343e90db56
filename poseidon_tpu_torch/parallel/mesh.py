"""The task-axis device mesh of the scale lane.

The reference lays the dense auction out over a ``jax.sharding.Mesh``
(``poseidon_tpu/parallel/mesh.py``). Here a mesh is a list of CUDA
devices and a rule for cutting the padded task axis into one row block
per device: the [Tp, Mp] table lives as row blocks, one per device,
and everything O(T + M) stays on the first device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TaskMesh:
    """A 1-D mesh: ``devices[k]`` holds row block k of every task-major
    table. A device may repeat (several shards on one card, or the CPU
    standing in for a multi-device host)."""

    devices: tuple
    axis: str = "tasks"

    @property
    def width(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device of the control state: the seat layout, the [Tp]
        carry and the [Mp] prices."""
        return self.devices[0]

    def rows(self, Tp: int) -> tuple[tuple[int, int], ...]:
        """The [r0, r1) row range of each shard of a Tp-row table."""
        w = self.width
        if Tp % w:
            raise ValueError(
                f"mesh width {w} does not divide the padded task axis {Tp}"
            )
        h = Tp // w
        return tuple((k * h, (k + 1) * h) for k in range(w))


def make_mesh(n_devices: int | None = None, axis: str = "tasks", *,
              devices=None) -> TaskMesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices, or over
    ``devices`` (a list that may repeat a device).

    One axis is all the solver needs: the auction's state is task-major
    and the machine-side tables are small enough to keep whole (M ints),
    so the layout is task-sharded, machine-replicated. The width must be
    a power of two, to divide the padded task axis; asking for more CUDA
    devices than the host has raises, as the reference does.
    """
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(
                f"requested {n_devices} devices, listed {len(devs)}"
            )
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh needs CUDA devices, and none is available; "
                "pass devices=[torch.device(\"cpu\")] * width to lay the "
                "mesh out on the CPU"
            )
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len(devs) & (len(devs) - 1):
        raise ValueError(
            f"mesh size must be a power of two to divide the padded "
            f"task axis; got {len(devs)} devices"
        )
    return TaskMesh(devices=devs, axis=axis)
