"""L3' cost-model layer: vectorized arc pricing + sample knowledge base."""

from poseidon_tpu_torch.models.costs import (  # noqa: F401
    COST_CAP,
    COST_MODELS,
    COST_MODEL_SELECTORS,
    CostInputs,
    build_cost_inputs,
    build_cost_inputs_host,
    get_cost_model,
    quincy_cost,
    trivial_cost,
)
from poseidon_tpu_torch.models.knowledge import (  # noqa: F401
    KnowledgeBase,
    MachineSample,
    TaskSample,
)
