"""The paper's contribution, ported: the BSP accelerator model, pseudo-streams,
hypersteps and the BSPS cost function, with the runtime's fault injection and
health monitoring."""

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
from repro_torch.core.faults import (
    FAULT_KINDS,
    FaultInjected,
    FaultInjector,
    FaultPlan,
    FaultRecord,
    FaultSpec,
    corrupt_array,
    fault_signature,
)
from repro_torch.core.health import (
    HEALTH_CODES,
    HealthEvent,
    HealthMonitor,
)
from repro_torch.core.hyperstep import (
    CompiledHyperstepProgram,
    HyperstepRecord,
    HyperstepRunner,
    run_bsps,
)
from repro_torch.core.plan import (
    CompiledSchedule,
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
    "FAULT_KINDS", "FaultInjected", "FaultInjector", "FaultPlan",
    "FaultRecord", "FaultSpec", "corrupt_array", "fault_signature",
    "HEALTH_CODES", "HealthEvent", "HealthMonitor",
    "CompiledHyperstepProgram", "HyperstepRecord", "HyperstepRunner", "run_bsps",
    "CompiledSchedule", "PlanChoice", "ScratchSpec", "StreamPlan", "TokenSpec",
    "autotune", "enumerate_plans", "host_plan",
    "Stream", "StreamSet",
]
