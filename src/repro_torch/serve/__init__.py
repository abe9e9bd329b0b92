from repro_torch.serve.engine import EngineStats, Request, ServeEngine
from repro_torch.serve.lru import ShardedLRU

__all__ = ["EngineStats", "Request", "ServeEngine", "ShardedLRU"]
