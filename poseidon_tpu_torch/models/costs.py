"""L3' cost models: vectorized arc-pricing functions on tensors + registry.

Each model is a plain function ``(CostInputs) -> int32[E]`` over the
padded arc table, on whatever device the inputs live on. Costs are
bounded to [0, COST_CAP] so the solvers' scaled integer domains stay
inside int32. The arithmetic restates the reference package's models
term for term, in the same integer widths, so the priced arc table is
identical bit for bit.

All six of the reference's models are here: trivial, random, quincy,
wharemap, coco and octopus (the shipped selector, 6). Pricing is plain
torch: an elementwise pass over the arc axis, with no fused or compiled
variant (a fused kernel could contract a multiply and an add and round
differently from the reference).
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
    """An int32 scalar made on ``like``'s device (a fill, not a blocking
    upload of host data)."""
    return torch.full((), x, dtype=torch.int32, device=like.device)


def _div_f32(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` in float32, correctly rounded on every device. The
    divisor is a tensor on ``x``'s device: PyTorch's CUDA division by a
    Python scalar multiplies by the scalar's float32 reciprocal
    instead, which rounds differently from the CPU's division."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


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


def random_cost(inputs: CostInputs, seed: int = 42) -> torch.Tensor:
    """Deterministic pseudo-random arc costs (debug / fuzz policy).

    The reference hashes in uint32. Torch has no uint32 arithmetic on
    every device, so the hash runs in int64 masked to the low 32 bits
    after every multiply and add: a signed int64 product of two 32-bit
    values may wrap, but its low 32 bits are the uint32 product's, and
    ``>> 15`` of a masked (non-negative) value is the logical shift."""
    return _finish(inputs, _random_hash(inputs, seed))


def _random_hash(inputs: CostInputs, seed: int = 42) -> torch.Tensor:
    """``random_cost`` before ``_finish``."""
    m32 = 0xFFFFFFFF

    def u32(x):
        return x.to(torch.int64) & m32

    x = (u32(inputs.kind) * 0x9E3779B9) & m32
    x = (x + ((u32(inputs.task) * 0x85EBCA6B) & m32)) & m32
    x = (x + ((u32(inputs.machine) * 0xC2B2AE35) & m32)) & m32
    x = (x + seed) & m32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & m32
    x = x ^ (x >> 12)
    c = (x % 100).to(torch.int32)
    # keep unsched clearly the worst option so random still schedules
    return torch.where(_kind(inputs, ArcKind.TASK_TO_UNSCHED),
                       _i32(COST_CAP // 2, c), c)


# The float models below keep every step in float32, one torch op per
# reference op in the reference's order, and cast with
# ``.to(torch.int32)`` (truncation toward zero, as ``astype``), so the
# priced arcs equal the reference model's after the cast bit for bit,
# on the CPU and on the card alike. (Inside a jitted program, XLA on the
# CPU turns ``/ 1000.0`` into a multiply by 0.001f, fused with the
# following add: the reference's compiled rounds can then differ from
# its own model called op by op in a rare arc of wharemap or coco.)


def octopus_cost(inputs: CostInputs) -> torch.Tensor:
    """Load-balancing policy — the reference's shipped selector
    (deploy/poseidon.cfg:6-7): busy machines price up, so flow spreads.
    """
    load = (inputs.machine_load * 100).to(torch.int32)
    slots = inputs.machine_used_slots * _SCALE
    per_machine = (load + slots)[inputs.machine.long()]
    c = torch.zeros_like(inputs.kind)
    to_machine = (_kind(inputs, ArcKind.CLUSTER_TO_MACHINE)
                  | _kind(inputs, ArcKind.RACK_TO_MACHINE)
                  | _kind(inputs, ArcKind.TASK_TO_MACHINE))
    c = torch.where(to_machine, per_machine, c)
    c = torch.where(_kind(inputs, ArcKind.MACHINE_TO_SINK), per_machine, c)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_CLUSTER),
                    _i32(_SCALE, c), c)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_UNSCHED),
                    _i32(COST_CAP // 4, c), c)
    return _finish(inputs, c)


def wharemap_cost(inputs: CostInputs) -> torch.Tensor:
    """Interference scoring from observed samples (Whare-Map-style).

    Prices a task onto a machine by the product of the machine's observed
    load and the task's observed hunger — co-locating a hot task on a hot
    machine is the expensive corner. Unsampled entities degrade to pure
    load balancing.
    """
    task = inputs.task.long()
    hunger = torch.clamp(inputs.task_usage[task]
                         + _div_f32(inputs.task_cpu[task].to(torch.float32),
                                    1000.0), 0.1, 8.0)
    load = inputs.machine_load[inputs.machine.long()]
    interf = (hunger * load * 100.0).to(torch.int32)
    c = torch.zeros_like(inputs.kind)
    direct = (_kind(inputs, ArcKind.TASK_TO_MACHINE)
              | _kind(inputs, ArcKind.CLUSTER_TO_MACHINE)
              | _kind(inputs, ArcKind.RACK_TO_MACHINE))
    c = torch.where(direct, interf, c)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_CLUSTER),
                    _i32(2 * _SCALE, c), c)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_UNSCHED),
                    _i32(COST_CAP // 4, c), c)
    return _finish(inputs, c)


def coco_cost(inputs: CostInputs) -> torch.Tensor:
    """Multi-dimensional co-location policy (CoCo-style).

    Cost is the tightest normalized resource fit across CPU and memory:
    placing a demanding task on a machine with little headroom is
    penalized superlinearly, so the solver packs across dimensions.
    """
    task = inputs.task.long()
    machine = inputs.machine.long()
    cpu_req = _div_f32(inputs.task_cpu[task].to(torch.float32), 1000.0)
    mem_req = inputs.task_mem_kb[task].to(torch.float32)
    cpu_head = torch.clamp(1.0 - inputs.machine_load[machine], min=0.05)
    mem_head = torch.clamp(inputs.machine_mem_free[machine], min=0.05)
    fit = torch.maximum(cpu_req / cpu_head,
                        mem_req / (mem_head * (1 << 20)))
    sq = torch.clamp(fit, 0.0, 4.0)
    score = (sq * sq * 100.0).to(torch.int32)
    c = torch.zeros_like(inputs.kind)
    placing = (_kind(inputs, ArcKind.TASK_TO_MACHINE)
               | _kind(inputs, ArcKind.CLUSTER_TO_MACHINE)
               | _kind(inputs, ArcKind.RACK_TO_MACHINE))
    c = torch.where(placing, score, c)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_CLUSTER),
                    _i32(3 * _SCALE, c), c)
    wait = torch.clamp(inputs.task_wait[task], max=WAIT_CAP)
    c = torch.where(_kind(inputs, ArcKind.TASK_TO_UNSCHED),
                    COST_CAP // 4 + 5 * _SCALE * wait, c)
    return _finish(inputs, c)


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
    """Look up a cost model by name or by the reference's integer flag."""
    name = resolve_cost_model_name(name_or_selector)
    try:
        fn = COST_MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown cost model {name!r}; known: {sorted(COST_MODELS)}"
        ) from None
    return fn


# ---------------------------------------------------------------------------
# per-term attribution: the explainer's API (obs/explain.py)
# ---------------------------------------------------------------------------
#
# Each model's cost is, by construction, a SUM of named terms per arc
# (locality, load, wait-aging, fixed channel fees...). The term
# functions below recompute each model with the identical expressions,
# split into those named components (the reference's term names), and
# ``_overlay_terms`` applies the ``_finish`` overlays (domain clamp,
# preemption penalty, hysteresis discount) as explicit adjustment terms
# — so for every arc the term values sum BIT-EXACTLY to the registry
# model's priced output (asserted by ``arc_cost_terms`` itself at call
# time). Float-derived quantities (octopus load, wharemap interference,
# coco fit) are kept as single terms: splitting them would reassociate
# float arithmetic and break the bit-exactness contract.


def _zmask(inputs: CostInputs, mask, value) -> torch.Tensor:
    z = torch.zeros_like(inputs.kind)
    if not isinstance(value, torch.Tensor):
        value = _i32(value, z)
    return torch.where(mask, value, z)


def _trivial_terms(inputs: CostInputs) -> dict[str, torch.Tensor]:
    return {
        "unsched_base": _zmask(
            inputs, _kind(inputs, ArcKind.TASK_TO_UNSCHED), 5 * _SCALE
        ),
        "wildcard_base": _zmask(
            inputs, _kind(inputs, ArcKind.TASK_TO_CLUSTER), 2 * _SCALE
        ),
    }


def _random_terms(inputs: CostInputs) -> dict[str, torch.Tensor]:
    # the hash is one indivisible term (there is nothing to attribute)
    return {"hash": _random_hash(inputs)}


def _quincy_terms(inputs: CostInputs) -> dict[str, torch.Tensor]:
    task = inputs.task.long()
    total = inputs.task_input[task]
    remote = torch.clamp(total - inputs.weight, min=0)
    pref = (_kind(inputs, ArcKind.TASK_TO_MACHINE)
            | _kind(inputs, ArcKind.TASK_TO_RACK))
    cluster = _kind(inputs, ArcKind.TASK_TO_CLUSTER)
    unsched = _kind(inputs, ArcKind.TASK_TO_UNSCHED)
    wait = torch.clamp(inputs.task_wait[task], max=WAIT_CAP)
    z = torch.zeros_like(inputs.kind)
    return {
        "remote_data": torch.where(
            pref, remote, torch.where(cluster, total, z)
        ),
        "wildcard_base": _zmask(inputs, cluster, _SCALE),
        "wait_aging": _zmask(inputs, unsched, 5 * _SCALE * wait),
        "unsched_base": _zmask(inputs, unsched, 5 * _SCALE),
        "rack_hop": _zmask(
            inputs, _kind(inputs, ArcKind.RACK_TO_MACHINE), _SCALE // 2
        ),
    }


def _octopus_terms(inputs: CostInputs) -> dict[str, torch.Tensor]:
    machine = inputs.machine.long()
    load = (inputs.machine_load * 100).to(torch.int32)
    slots = inputs.machine_used_slots * _SCALE
    routed = (_kind(inputs, ArcKind.CLUSTER_TO_MACHINE)
              | _kind(inputs, ArcKind.RACK_TO_MACHINE)
              | _kind(inputs, ArcKind.TASK_TO_MACHINE)
              | _kind(inputs, ArcKind.MACHINE_TO_SINK))
    return {
        "machine_load": _zmask(inputs, routed, load[machine]),
        "used_slots": _zmask(inputs, routed, slots[machine]),
        "wildcard_base": _zmask(
            inputs, _kind(inputs, ArcKind.TASK_TO_CLUSTER), _SCALE
        ),
        "unsched_base": _zmask(
            inputs, _kind(inputs, ArcKind.TASK_TO_UNSCHED),
            COST_CAP // 4,
        ),
    }


def _wharemap_terms(inputs: CostInputs) -> dict[str, torch.Tensor]:
    task = inputs.task.long()
    hunger = torch.clamp(inputs.task_usage[task]
                         + _div_f32(inputs.task_cpu[task].to(torch.float32),
                                    1000.0), 0.1, 8.0)
    load = inputs.machine_load[inputs.machine.long()]
    interf = (hunger * load * 100.0).to(torch.int32)
    direct = (_kind(inputs, ArcKind.TASK_TO_MACHINE)
              | _kind(inputs, ArcKind.CLUSTER_TO_MACHINE)
              | _kind(inputs, ArcKind.RACK_TO_MACHINE))
    return {
        "interference": _zmask(inputs, direct, interf),
        "wildcard_base": _zmask(
            inputs, _kind(inputs, ArcKind.TASK_TO_CLUSTER), 2 * _SCALE
        ),
        "unsched_base": _zmask(
            inputs, _kind(inputs, ArcKind.TASK_TO_UNSCHED),
            COST_CAP // 4,
        ),
    }


def _coco_terms(inputs: CostInputs) -> dict[str, torch.Tensor]:
    task = inputs.task.long()
    machine = inputs.machine.long()
    cpu_req = _div_f32(inputs.task_cpu[task].to(torch.float32), 1000.0)
    mem_req = inputs.task_mem_kb[task].to(torch.float32)
    cpu_head = torch.clamp(1.0 - inputs.machine_load[machine], min=0.05)
    mem_head = torch.clamp(inputs.machine_mem_free[machine], min=0.05)
    fit = torch.maximum(cpu_req / cpu_head,
                        mem_req / (mem_head * (1 << 20)))
    sq = torch.clamp(fit, 0.0, 4.0)
    score = (sq * sq * 100.0).to(torch.int32)
    placing = (_kind(inputs, ArcKind.TASK_TO_MACHINE)
               | _kind(inputs, ArcKind.CLUSTER_TO_MACHINE)
               | _kind(inputs, ArcKind.RACK_TO_MACHINE))
    unsched = _kind(inputs, ArcKind.TASK_TO_UNSCHED)
    wait = torch.clamp(inputs.task_wait[task], max=WAIT_CAP)
    return {
        "resource_fit": _zmask(inputs, placing, score),
        "wildcard_base": _zmask(
            inputs, _kind(inputs, ArcKind.TASK_TO_CLUSTER), 3 * _SCALE
        ),
        "wait_aging": _zmask(inputs, unsched, 5 * _SCALE * wait),
        "unsched_base": _zmask(inputs, unsched, COST_CAP // 4),
    }


COST_TERM_FNS: dict[
    str, Callable[[CostInputs], dict[str, torch.Tensor]]
] = {
    "trivial": _trivial_terms,
    "random": _random_terms,
    "quincy": _quincy_terms,
    "wharemap": _wharemap_terms,
    "coco": _coco_terms,
    "octopus": _octopus_terms,
}


def _overlay_terms(
    inputs: CostInputs, terms: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Apply the shared ``_finish`` overlays as explicit adjustment
    terms, so the returned dict sums to the model's final arc cost on
    every slot (padding slots included — everything masks to 0)."""
    raw = None
    for v in terms.values():
        raw = v if raw is None else raw + v
    clipped = torch.clamp(raw, 0, COST_CAP).to(torch.int32)
    running = inputs.task_running[inputs.task.long()]
    preempt = running & (inputs.kind == int(ArcKind.TASK_TO_UNSCHED))
    after_pre = torch.where(
        preempt,
        torch.clamp(clipped + PREEMPTION_PENALTY, max=DOMAIN_SAFE_COST),
        clipped,
    )
    after_disc = torch.clamp(after_pre - inputs.discount, min=0)
    out = dict(terms)
    out["domain_clamp"] = clipped - raw
    out["preemption_penalty"] = after_pre - clipped
    out["hysteresis_discount"] = after_disc - after_pre
    z = torch.zeros_like(inputs.kind)
    return {k: torch.where(inputs.valid, v, z) for k, v in out.items()}


def arc_cost_terms(
    name_or_selector: str | int, inputs: CostInputs, *, device=None,
) -> dict[str, np.ndarray]:
    """Named per-arc cost terms for a registry model, as HOST arrays.

    The returned ``{term_name: int32[E]}`` values sum bit-exactly to
    ``get_cost_model(name)(inputs)`` on the same inputs — verified at
    call time (a mismatch raises, so the explainer can never report a
    breakdown that does not add up to the solver's arc cost). Zero-
    everywhere terms are kept: consumers drop them per decision.
    ``inputs`` are host arrays (``build_cost_inputs_host``), priced on
    ``device`` (None = the card; the pricing is bit-identical on the
    CPU), or tensors, priced where they live."""
    name = resolve_cost_model_name(name_or_selector)
    try:
        raw_fn = COST_TERM_FNS[name]
    except KeyError:
        raise KeyError(
            f"no term attribution for cost model {name!r}; "
            f"known: {sorted(COST_TERM_FNS)}"
        ) from None
    if not isinstance(inputs.kind, torch.Tensor):
        from poseidon_tpu_torch.ops.resident import resolve_device

        inputs = inputs.to_device(resolve_device(device))
    terms_dev = _overlay_terms(inputs, raw_fn(inputs))
    total_dev = COST_MODELS[name](inputs)
    # by term name, the order the reference's returns them in (its
    # host transfer rebuilds the dict with sorted keys); the explainer's
    # transcript orders equal-sized terms by it
    terms = {
        k: v.cpu().numpy().astype(np.int32)
        for k, v in sorted(terms_dev.items())
    }
    total = total_dev.cpu().numpy().astype(np.int32)
    acc = np.zeros_like(total, np.int64)
    for v in terms.values():
        acc += v
    if not np.array_equal(acc, total.astype(np.int64)):
        bad = int(np.flatnonzero(acc != total)[0])
        raise AssertionError(
            f"term breakdown for model {name!r} does not sum to the "
            f"priced arc cost (first mismatch at arc {bad}: "
            f"{int(acc[bad])} != {int(total[bad])})"
        )
    return terms
