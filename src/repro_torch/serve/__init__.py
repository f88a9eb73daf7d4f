"""Continuous-batching CollaFuse serving: the stable surface."""
from repro_torch.serve.admission import AdmissionDecision, AdmissionPolicy
from repro_torch.serve.engine import (Completion, EngineConfig, ServeEngine,
                                      ServeResult, serve_sequential)
from repro_torch.serve.metrics import (ServeMetrics, admission_summary,
                                       finish_summary)
from repro_torch.serve.scheduler import (CutRatioScheduler, FIFOScheduler,
                                         Request, make_scheduler)

__all__ = ["AdmissionDecision", "AdmissionPolicy", "Completion",
           "CutRatioScheduler", "EngineConfig", "FIFOScheduler", "Request",
           "ServeEngine", "ServeMetrics", "ServeResult", "admission_summary",
           "finish_summary", "make_scheduler", "serve_sequential"]
