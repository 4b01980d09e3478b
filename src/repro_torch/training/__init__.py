"""Training on the dense decoders (counterpart of ``repro.training``).

Ported: the optimizers, the loss and the train step, the synthetic data
pipeline, checkpoints (the reference's on-disk format, restorable by either
package) and fault tolerance.  Not ported yet: the train step's sharding
specs (``param_pspecs``, ``opt_pspecs``, ``batch_pspecs``,
``state_pspecs``, ``to_named``), which come with the sharding rule table
(ROADMAP queue A item 6).
"""
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import SyntheticTokenPipeline
from repro_torch.training.fault_tolerance import ElasticPlan, StepMonitor, run_with_restarts
from repro_torch.training.optimizer import (
    adafactor, adamw, cosine_schedule, int8_compress_decompress, make_optimizer, maybe_compress,
)
from repro_torch.training.train_step import (
    cross_entropy, init_state, make_loss_fn, make_train_step,
)

__all__ = [
    "CheckpointManager", "ElasticPlan", "StepMonitor", "SyntheticTokenPipeline",
    "adafactor", "adamw", "cosine_schedule", "cross_entropy", "init_state",
    "int8_compress_decompress", "make_loss_fn", "make_optimizer", "make_train_step",
    "maybe_compress", "run_with_restarts",
]
