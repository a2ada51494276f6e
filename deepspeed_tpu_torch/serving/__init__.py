"""Continuous-batching GPT-2 serving on the port.

Port of deepspeed_tpu/serving: ``InferenceEngine`` (engine.py) admits
requests between decode steps over a paged KV pool (kv_cache.py), with
host-side scheduling (scheduler.py), reliability (reliability.py) and
latency accounting (metrics.py). The fleet router (fleet.py) comes with
ROADMAP A10c.
"""
from deepspeed_tpu_torch.serving.engine import InferenceEngine
from deepspeed_tpu_torch.serving.kv_cache import PagedKVPool
from deepspeed_tpu_torch.serving.metrics import (DispatchShapes,
                                                 ServingMetrics)
from deepspeed_tpu_torch.serving.reliability import (ReliabilityConfig,
                                                     RequestJournal)
from deepspeed_tpu_torch.serving.scheduler import Request, Scheduler

__all__ = ["InferenceEngine", "PagedKVPool", "ServingMetrics",
           "DispatchShapes", "ReliabilityConfig", "RequestJournal",
           "Request", "Scheduler"]
