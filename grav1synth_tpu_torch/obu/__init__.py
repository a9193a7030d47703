"""AV1 OBU syntax codec: parse + surgical rewrite of grain metadata."""

from .obu import Av1Parser, GrainRewriter, ParsedObu
from .types import (
    DEFAULT_GRAIN_SEED,
    ColorConfig,
    FilmGrainParams,
    FrameHeader,
    FrameType,
    GrainAction,
    GrainHeader,
    GrainTableSegment,
    ObuHeader,
    ObuType,
    SequenceHeader,
    TileInfo,
)

__all__ = [
    "Av1Parser",
    "GrainRewriter",
    "ParsedObu",
    "DEFAULT_GRAIN_SEED",
    "ColorConfig",
    "FilmGrainParams",
    "FrameHeader",
    "FrameType",
    "GrainAction",
    "GrainHeader",
    "GrainTableSegment",
    "ObuHeader",
    "ObuType",
    "SequenceHeader",
    "TileInfo",
]
