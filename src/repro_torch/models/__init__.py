from repro_torch.models.kvcache import abstract_cache, cache_bytes, cache_logical_axes, zero_cache
from repro_torch.models.model import Model
from repro_torch.models.params import (
    abstract_params, block_cycle, build_params, count_params, init_params, param_logical_axes,
)

__all__ = ["Model", "abstract_cache", "abstract_params", "block_cycle", "build_params",
           "cache_bytes", "cache_logical_axes", "count_params", "init_params",
           "param_logical_axes", "zero_cache"]
