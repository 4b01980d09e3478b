from repro_torch.models.kvcache import cache_bytes, zero_cache
from repro_torch.models.model import Model
from repro_torch.models.params import (
    abstract_params, block_cycle, build_params, count_params, init_params, param_logical_axes,
)

__all__ = ["Model", "abstract_params", "block_cycle", "build_params", "count_params",
           "init_params", "param_logical_axes", "zero_cache", "cache_bytes"]
