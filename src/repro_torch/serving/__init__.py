from repro_torch.serving.async_engine import (AsyncCoachEngine, AsyncHopPipeline,
                                        HopQueue, VirtualClock, WallClock,
                                        run_pipeline_async)
from repro_torch.serving.base import EngineConfig, EngineStats
from repro_torch.serving.engine import CoachEngine
from repro_torch.serving.generate import generate
from repro_torch.serving.routing import (ROUTER_POLICIES, JoinShortestQueue,
                                   PowerOfTwoChoices, RandomRouter,
                                   RouterPolicy, TenantAffinity,
                                   make_router)
from repro_torch.serving.tenancy import (ADMISSION_POLICIES, FifoAdmission,
                                   MultiTenantCoachEngine,
                                   MultiTenantHopPipeline,
                                   RoundRobinAdmission, TenantSpec,
                                   WeightedDeficitRoundRobin, make_policy,
                                   run_multitenant_async)
