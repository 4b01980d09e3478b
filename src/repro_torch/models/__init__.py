from repro_torch.models.kvcache import cache_bytes, zero_cache
from repro_torch.models.model import Model
from repro_torch.models.params import block_cycle, build_params, count_params, init_params

__all__ = ["Model", "block_cycle", "build_params", "count_params", "init_params",
           "zero_cache", "cache_bytes"]
