"""Training (counterpart of ``repro.training``): the optimizers, the loss
and the train step, the train step's sharding specs (``param_pspecs``,
``opt_pspecs``, ``batch_pspecs``, ``state_pspecs``, ``to_named``, over the
rule table of ``distributed.sharding``), the synthetic data pipeline,
checkpoints (the reference's on-disk format, restorable by either package)
and fault tolerance.
"""
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import SyntheticTokenPipeline
from repro_torch.training.fault_tolerance import ElasticPlan, StepMonitor, run_with_restarts
from repro_torch.training.optimizer import (
    adafactor, adamw, cosine_schedule, int8_compress_decompress, make_optimizer, maybe_compress,
)
from repro_torch.training.train_step import (
    batch_pspecs, cross_entropy, init_state, make_loss_fn, make_train_step, opt_pspecs,
    param_pspecs, state_pspecs, to_named,
)

__all__ = [
    "CheckpointManager", "ElasticPlan", "StepMonitor", "SyntheticTokenPipeline",
    "adafactor", "adamw", "batch_pspecs", "cosine_schedule", "cross_entropy", "init_state",
    "int8_compress_decompress", "make_loss_fn", "make_optimizer", "make_train_step",
    "maybe_compress", "opt_pspecs", "param_pspecs", "run_with_restarts", "state_pspecs",
    "to_named",
]
