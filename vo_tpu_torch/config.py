"""The engine's typed configuration: one copy of the defaults, shared with vo_tpu.

``vo_tpu.config`` imports nothing but the standard library, so the port
re-exports it instead of copying it.
"""
from vo_tpu.config import (  # noqa: F401
    BAConfig,
    LandmarkConfig,
    LoopConfig,
    MatcherConfig,
    MeshConfig,
    PipelineConfig,
    RansacConfig,
    SIFTConfig,
)
