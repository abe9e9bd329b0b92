from repro_torch.serve.engine import EngineStats, Request, ServeEngine
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.lru import ShardedLRU
from repro_torch.serve.scheduler import SlotScheduler

__all__ = ["ContinuousEngine", "EngineStats", "Request", "ServeEngine",
           "ShardedLRU", "SlotScheduler"]
