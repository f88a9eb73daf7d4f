"""Continuous-batching CollaFuse serving: the stable surface.  Observability
(:mod:`repro_torch.obs`) is re-exported here, so serve callers need one
import: ``EngineConfig(obs=ObsConfig(...))``."""
from repro_torch.obs import NULL_OBS, Observability, ObsConfig
from repro_torch.serve.admission import AdmissionDecision, AdmissionPolicy
from repro_torch.serve.engine import (Completion, EngineConfig, ServeEngine,
                                      ServeResult, serve_sequential)
from repro_torch.serve.metrics import (ServeMetrics, admission_summary,
                                       finish_summary)
from repro_torch.serve.scheduler import (CutRatioScheduler, FIFOScheduler,
                                         Request, make_scheduler)

__all__ = ["AdmissionDecision", "AdmissionPolicy", "Completion",
           "CutRatioScheduler", "EngineConfig", "FIFOScheduler", "NULL_OBS",
           "Observability", "ObsConfig", "Request", "ServeEngine",
           "ServeMetrics", "ServeResult", "admission_summary",
           "finish_summary", "make_scheduler", "serve_sequential"]
