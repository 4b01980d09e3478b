from repro_torch.core.backend.analytical import AnalyticalEngine
from repro_torch.core.backend.engine import FusedEngine
from repro_torch.core.backend.hardware import HARDWARE, HardwareSpec, get_hardware
from repro_torch.core.backend.prediction import PredictionEngine, RandomForest
from repro_torch.core.backend.profiling import ProfileDB, ProfilingEngine

__all__ = [
    "AnalyticalEngine", "FusedEngine", "HARDWARE", "HardwareSpec",
    "get_hardware", "PredictionEngine", "RandomForest", "ProfileDB",
    "ProfilingEngine",
]
