"""DuDe-ASGD core of the port: the flat layout (``flatten``), the server
engine (``engine``), the round-rule registry (``algos``), the config
(``dude``) and the host-side speed models and schedules (``schedules``)."""

from .algos import ROUND_ALGOS, RoundAlgo, make_round_algo
from .dude import DuDeConfig
from .engine import BACKENDS, DuDeEngine, EngineState
from .flatten import PAD_MULTIPLE, FlatSpec, make_flat_spec
from .schedules import (RoundSchedule, SpeedModel, delay_stats, make_round_schedule,
                        truncated_normal_speeds)

__all__ = [
    "BACKENDS", "DuDeConfig", "DuDeEngine", "EngineState", "FlatSpec",
    "PAD_MULTIPLE", "ROUND_ALGOS", "RoundAlgo", "RoundSchedule", "SpeedModel",
    "delay_stats", "make_flat_spec", "make_round_algo", "make_round_schedule",
    "truncated_normal_speeds",
]
