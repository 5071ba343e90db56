"""K11 ``ssp_augment``: the walk and augment of successive shortest paths,
and its plain twin.

Replaces ``poseidon_tpu/ops/ssp.py:130-157``: walk T -> S along the
predecessor arcs (``NN`` steps at most; the sentinel arc ``2F`` has tail
T and residual 0), take the bottleneck, route ``delta = min(bneck,
wanted - routed)`` (0 unless the walk reached S from a reachable T) and
apply it once to every path arc. The CUDA source is
``csrc/ssp_augment.cu``; its header note gives the bound (latency) and
the design (one block, one walking thread). ``state`` int32[2] carries
``routed`` in and out and receives ``delta``: the host reads both in one
read a path.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.kernels._args import kernel_arg, on_card, stream_ptr
from poseidon_tpu_torch.kernels.loader import Kernel, check_launch, library

INF = 2**30

KERNEL = Kernel(
    name="ssp_augment",
    source="poseidon_tpu_torch/kernels/csrc/ssp_augment.cu",
    replaces="poseidon_tpu/ops/ssp.py:133",
)


def ssp_augment_plain(pred, dist, fsrc, fdst, fcap, flow, state,
                      wanted: int, S: int, T: int):
    """The reference lines restated: the full masked walk to the step cap,
    then one masked update of the flow."""
    NN = dist.shape[0]
    F = fcap.shape[0]
    dev = flow.device
    rsrc_ext = torch.cat([fsrc, fdst, torch.tensor([T], dtype=torch.int32,
                                                    device=dev)]).tolist()
    res_ext = torch.cat([fcap - flow, flow,
                         torch.zeros(1, dtype=torch.int32, device=dev)]).tolist()
    p = pred.tolist()
    reachable = int(dist[T]) < INF
    v, bneck, steps = T, INF, 0
    marked = set()
    while v != S and steps < NN:
        a = p[v]
        marked.add(a)
        bneck = min(bneck, res_ext[a])
        v = rsrc_ext[a]
        steps += 1
    routed = int(state[0])
    delta = min(bneck, wanted - routed) if reachable and v == S else 0
    mask = torch.zeros(2 * F + 1, dtype=torch.bool, device=dev)
    mask[torch.tensor(sorted(marked), dtype=torch.long, device=dev)] = True
    flow += delta * (mask[:F].to(torch.int32) - mask[F:2 * F].to(torch.int32))
    state.copy_(torch.tensor([routed + delta, delta], dtype=torch.int32,
                             device=dev))


def ssp_augment(pred, dist, fsrc, fdst, fcap, flow, state,
                wanted: int, S: int, T: int):
    """One path: ``pred``/``dist`` int32[NN], ``fsrc``/``fdst``/``fcap``
    int32[F], ``flow`` int32[F] (in place), ``state`` int32[2] = (routed,
    delta). CPU tensors take the plain twin; CUDA tensors launch K11."""
    if not on_card(pred, dist, fsrc, fdst, fcap, flow, state):
        ssp_augment_plain(pred, dist, fsrc, fdst, fcap, flow, state,
                          wanted, S, T)
        return
    NN = dist.shape[0]
    F = fcap.shape[0]
    i32 = torch.int32
    spec = (
        (pred, "pred", i32, (NN,)), (dist, "dist", i32, (NN,)),
        (fsrc, "fsrc", i32, (F,)), (fdst, "fdst", i32, (F,)),
        (fcap, "fcap", i32, (F,)), (flow, "flow", i32, (F,)),
        (state, "state", i32, (2,)),
    )
    ptrs = [kernel_arg(t, name, dt, shape) for t, name, dt, shape in spec]
    with torch.cuda.device(flow.device):
        err = library("ssp_augment").ssp_augment_launch(
            *ptrs, int(wanted), S, T, NN, F, stream_ptr(flow))
    check_launch(KERNEL, err)
    KERNEL.launches += 1
