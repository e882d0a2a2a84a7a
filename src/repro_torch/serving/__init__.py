from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
from repro_torch.serving.metrics import summarize
from repro_torch.serving.workload import WorkloadConfig, generate_trace

__all__ = ["EdgeLoRAEngine", "EngineConfig", "WorkloadConfig",
           "generate_trace", "summarize"]
