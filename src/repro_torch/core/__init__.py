"""The paper's contribution, ported: the BSP accelerator model, pseudo-streams,
hypersteps and the BSPS cost function."""

from repro_torch.core.bsp import BSPAccelerator, BSPComputer, EPIPHANY_III
from repro_torch.core.cost import (
    HyperstepCost,
    SuperstepCost,
    bsp_cost,
    bsps_cost,
    cannon_bsp_cost,
    cannon_bsps_cost,
    cannon_hyperstep,
    cannon_k_equal,
    inner_product_cost,
)
from repro_torch.core.hyperstep import (
    CompiledHyperstepProgram,
    HyperstepRecord,
    HyperstepRunner,
    run_bsps,
)
from repro_torch.core.plan import (
    PlanChoice,
    ScratchSpec,
    StreamPlan,
    TokenSpec,
    autotune,
    enumerate_plans,
    host_plan,
)
from repro_torch.core.stream import Stream, StreamSet

__all__ = [
    "BSPAccelerator", "BSPComputer", "EPIPHANY_III",
    "HyperstepCost", "SuperstepCost", "bsp_cost", "bsps_cost",
    "cannon_bsp_cost", "cannon_bsps_cost", "cannon_hyperstep", "cannon_k_equal",
    "inner_product_cost",
    "CompiledHyperstepProgram", "HyperstepRecord", "HyperstepRunner", "run_bsps",
    "PlanChoice", "ScratchSpec", "StreamPlan", "TokenSpec",
    "autotune", "enumerate_plans", "host_plan",
    "Stream", "StreamSet",
]
