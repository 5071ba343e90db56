"""L3' cost models: vectorized arc-pricing functions on tensors + registry.

Each model is a plain function ``(CostInputs) -> int32[E]`` over the
padded arc table, on whatever device the inputs live on. Costs are
bounded to [0, COST_CAP] so the solvers' scaled integer domains stay
inside int32. The arithmetic restates the reference package's models
term for term, in the same integer widths, so the priced arc table is
identical bit for bit.

Ported so far: ``trivial`` and ``quincy``. ``random``, ``octopus``,
``wharemap`` and ``coco`` keep their names in the registry and raise
``NotImplementedError`` until their slice of the port lands; a model
that is not ported never falls back to another one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from poseidon_tpu_torch.graph.builder import ArcKind, GraphMeta
from poseidon_tpu_torch.graph.network import FlowNetwork, pad_bucket

# Bound on any single arc cost.
COST_CAP = 10_000
_SCALE = 10

# Flagship-domain ceiling: the dense auction requires 2*cmax*(T+1) <
# MAX_SCALED_COST (ops/dense_auction.py), which at T = 10k admits
# per-arc costs up to ~6.7k. Structurally unbounded inputs are clamped
# under it (wait aging at WAIT_CAP, quincy's summed locality weights,
# the preemption overlay inside ``_finish``).
DOMAIN_SAFE_COST = 6_000
WAIT_CAP = 60

# Rebalancing overlay: what preempting a RUNNING task adds on top of
# the model's unscheduled price.
PREEMPTION_PENALTY = 100 * _SCALE


@dataclasses.dataclass(frozen=True)
class CostInputs:
    """Pricing inputs, padded to static buckets: numpy arrays from
    ``build_cost_inputs_host``, tensors after ``to_device``.

    Per-arc arrays are aligned to the arc slots; ``task`` / ``machine``
    are clipped to 0 where not applicable so they are always safe gather
    indices — ``valid``/kind masks decide whether the value is used.
    """

    kind: object             # int32[E] ArcKind (padding: -1)
    task: object             # int32[E] gather-safe task index
    machine: object          # int32[E] gather-safe machine index
    weight: object           # int32[E] data-locality weight
    discount: object         # int32[E] hysteresis discount
    valid: object            # bool[E]  real (non-padding) arcs
    task_wait: object        # int32[Tp] rounds waited per task
    task_running: object     # bool[Tp] RUNNING (rebalancing) tasks
    task_input: object       # int32[Tp] total input data units per task
    task_cpu: object         # int32[Tp] requested milli-cores
    task_mem_kb: object      # int32[Tp] requested memory
    task_usage: object       # f32[Tp] sampled cpu usage (cores)
    machine_load: object     # f32[Mp] 1 - mean idle, in [0, 1]
    machine_mem_free: object  # f32[Mp] mean free-mem fraction [0, 1]
    machine_used_slots: object  # int32[Mp] running tasks per machine

    def to_device(self, device) -> "CostInputs":
        """The same inputs as tensors on ``device`` (one copy per field;
        the resident round batches this into its one upload)."""
        return CostInputs(**{
            f.name: torch.as_tensor(getattr(self, f.name)).to(device)
            for f in dataclasses.fields(self)
        })


def build_cost_inputs(
    net: FlowNetwork,
    meta: GraphMeta,
    *,
    device,
    **kwargs,
) -> CostInputs:
    """Assemble padded pricing inputs as tensors on ``device``; see
    ``build_cost_inputs_host`` for the fields."""
    return build_cost_inputs_host(
        net.num_arc_slots, meta, **kwargs
    ).to_device(device)


def build_cost_inputs_host(
    arc_slots: int,
    meta: GraphMeta,
    *,
    task_cpu_milli: np.ndarray | None = None,
    task_mem_kb: np.ndarray | None = None,
    task_usage: np.ndarray | None = None,
    machine_load: np.ndarray | None = None,
    machine_mem_free: np.ndarray | None = None,
    machine_used_slots: np.ndarray | None = None,
    t_min: int = 1,
    m_min: int = 1,
) -> CostInputs:
    """Assemble padded pricing inputs from builder metadata + KB
    aggregates, as host numpy arrays.

    The sample-derived arrays (``machine_load`` etc.) come from
    ``KnowledgeBase`` aggregates; they default to an idle, unsampled
    cluster. ``t_min``/``m_min`` are grow-only padding-bucket floors
    from the owning solver, so a draining pending pool does not shrink
    the per-task shapes between rounds.
    """
    E = arc_slots
    T = len(meta.task_uids)
    M = len(meta.machine_names)
    Tp = pad_bucket(max(T, 1), minimum=t_min)
    Mp = pad_bucket(max(M, 1), minimum=m_min)

    def pad_arc(a: np.ndarray, fill: int) -> np.ndarray:
        out = np.full(E, fill, np.int32)
        out[: meta.n_arcs] = a
        return out

    def padv(a, n, dtype):
        out = np.zeros(n, dtype)
        if a is not None:
            a = np.asarray(a)
            out[: a.shape[0]] = a
        return out

    # Total input data per task = sum of its pref-arc weights (Quincy's
    # "how much data could be local" denominator).
    tin = np.zeros(Tp, np.int64)
    np.add.at(tin, np.maximum(meta.arc_task, 0),
              np.where(meta.arc_task >= 0, meta.arc_weight, 0))
    tin = np.minimum(tin, DOMAIN_SAFE_COST - _SCALE)
    return CostInputs(
        kind=pad_arc(meta.arc_kind.astype(np.int32), -1),
        task=pad_arc(np.maximum(meta.arc_task, 0), 0),
        machine=pad_arc(np.maximum(meta.arc_machine, 0), 0),
        weight=pad_arc(meta.arc_weight, 0),
        discount=pad_arc(meta.arc_discount, 0),
        valid=np.arange(E) < meta.n_arcs,
        task_wait=padv(meta.task_wait, Tp, np.int32),
        task_running=padv(meta.task_current >= 0, Tp, bool),
        task_input=tin.astype(np.int32),
        task_cpu=padv(task_cpu_milli, Tp, np.int32),
        task_mem_kb=padv(task_mem_kb, Tp, np.int32),
        task_usage=padv(task_usage, Tp, np.float32),
        machine_load=padv(machine_load, Mp, np.float32),
        machine_mem_free=(
            padv(machine_mem_free, Mp, np.float32)
            if machine_mem_free is not None else np.ones(Mp, np.float32)
        ),
        machine_used_slots=padv(machine_used_slots, Mp, np.int32),
    )


def _i32(x: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=like.device)


def _finish(inputs: CostInputs, cost: torch.Tensor) -> torch.Tensor:
    """Clamp to the documented domain and zero the padding slots.

    Also applies the rebalancing overlays shared by every model (the
    identity when the graph carries no running tasks / discounts): a
    RUNNING task's unscheduled arc is its preemption price, clamped at
    DOMAIN_SAFE_COST, and continuation arcs subtract their hysteresis
    discount.
    """
    cost = torch.clamp(cost, 0, COST_CAP).to(torch.int32)
    running = inputs.task_running[inputs.task.long()]
    preempt = running & (inputs.kind == int(ArcKind.TASK_TO_UNSCHED))
    cost = torch.where(
        preempt,
        torch.clamp(cost + PREEMPTION_PENALTY, max=DOMAIN_SAFE_COST),
        cost,
    )
    cost = torch.clamp(cost - inputs.discount, min=0)
    return torch.where(inputs.valid, cost, _i32(0, cost))


def _kind(inputs: CostInputs, k: ArcKind) -> torch.Tensor:
    return inputs.kind == int(k)


# ---- the models ----

def trivial_cost(inputs: CostInputs) -> torch.Tensor:
    """Fixed-fee policy: schedule anywhere, mildly prefer scheduling.

    Wildcard (cluster) routing costs a small constant, leaving a task
    unscheduled a larger one; every other arc is free.
    """
    c = torch.zeros_like(inputs.kind)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_UNSCHED),
                    _i32(5 * _SCALE, c), c)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_CLUSTER),
                    _i32(2 * _SCALE, c), c)
    return _finish(inputs, c)


def quincy_cost(inputs: CostInputs) -> torch.Tensor:
    """Data-locality policy (Quincy-style).

    A preference arc's cost is the data the task would have to fetch
    remotely if placed there (total input minus what is local at the
    target); the wildcard path assumes nothing is local; the unscheduled
    arc grows with how long the task has waited.
    """
    task = inputs.task.long()
    total = inputs.task_input[task]
    remote = torch.clamp(total - inputs.weight, min=0)
    c = torch.zeros_like(inputs.kind)
    pref = (_kind(inputs, ArcKind.TASK_TO_MACHINE)
            | _kind(inputs, ArcKind.TASK_TO_RACK))
    c = torch.where(pref, remote, c)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_CLUSTER),
                    total + _SCALE, c)
    wait = torch.clamp(inputs.task_wait[task], max=WAIT_CAP)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_UNSCHED),
                    5 * _SCALE * (wait + 1), c)
    # crossing a rack boundary to reach the machine costs a hop
    c = torch.where(_kind(inputs, ArcKind.RACK_TO_MACHINE),
                    _i32(_SCALE // 2, c), c)
    return _finish(inputs, c)


def _not_ported_error(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"cost model {name!r} is not ported to poseidon_tpu_torch yet; "
        f"it comes with the cost-model slice of the port (ROADMAP.md)"
    )


def _not_ported(name: str) -> Callable[[CostInputs], torch.Tensor]:
    def model(inputs: CostInputs) -> torch.Tensor:
        raise _not_ported_error(name)

    model.__name__ = f"{name}_cost"
    model.ported = False
    return model


random_cost = _not_ported("random")
wharemap_cost = _not_ported("wharemap")
coco_cost = _not_ported("coco")
octopus_cost = _not_ported("octopus")

CostModelFn = Callable[[CostInputs], torch.Tensor]

# Name registry + the reference's integer selector compatibility
# (deploy/poseidon.cfg:7 selects 6, the load-balancing policy).
COST_MODELS: dict[str, CostModelFn] = {
    "trivial": trivial_cost,
    "random": random_cost,
    "quincy": quincy_cost,
    "wharemap": wharemap_cost,
    "coco": coco_cost,
    "octopus": octopus_cost,
}

COST_MODEL_SELECTORS: dict[int, str] = {
    0: "trivial",
    1: "random",
    3: "quincy",
    4: "wharemap",
    5: "coco",
    6: "octopus",
}


def resolve_cost_model_name(name_or_selector: str | int) -> str:
    """Canonical registry name for a name or the reference's integer
    flag. Digit strings count as integer selectors."""
    if isinstance(name_or_selector, str) and name_or_selector.isdigit():
        name_or_selector = int(name_or_selector)
    if isinstance(name_or_selector, int):
        try:
            return COST_MODEL_SELECTORS[name_or_selector]
        except KeyError:
            raise KeyError(
                f"unknown cost model selector {name_or_selector}; "
                f"known: {sorted(COST_MODEL_SELECTORS)}"
            ) from None
    return name_or_selector


def get_cost_model(name_or_selector: str | int) -> CostModelFn:
    """Look up a cost model by name or by the reference's integer flag.
    Raises ``NotImplementedError`` for a registered model whose port has
    not landed yet."""
    name = resolve_cost_model_name(name_or_selector)
    try:
        fn = COST_MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown cost model {name!r}; known: {sorted(COST_MODELS)}"
        ) from None
    if not getattr(fn, "ported", True):
        raise _not_ported_error(name)
    return fn
