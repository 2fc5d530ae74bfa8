from repro_torch.serving.engine import (
    ExecutionEngine,
    HostedModel,
    RequestResult,
    ServingCluster,
)

__all__ = ["ExecutionEngine", "HostedModel", "RequestResult", "ServingCluster"]
