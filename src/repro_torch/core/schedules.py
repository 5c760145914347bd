"""Worker speed models and asynchronous arrival schedules (host-side); a
copy of ``repro.core.schedules``, which is plain numpy.

The paper (§5) models hardware heterogeneity with the fixed-computation-speed
model of Mishchenko et al. 2022: worker ``i`` always takes ``s_i`` time units
per stochastic gradient, with ``s_i ~ TruncatedNormal(mu=1, std)`` clipped to
positive values.  A higher ``std`` means more heterogeneity and hence larger
model delays ``tau``.

Everything in this module is plain numpy executed on the host.  The SPMD
production path (mode B in DESIGN.md) consumes the *round schedule* produced
here as small boolean mask arrays that are fed into the jitted train step; the
event-driven simulator (mode A) consumes the continuous-time event stream.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterator, Sequence

import numpy as np

__all__ = [
    "SpeedModel",
    "truncated_normal_speeds",
    "Event",
    "event_stream",
    "RoundSchedule",
    "make_round_schedule",
    "delay_stats",
]


@dataclasses.dataclass(frozen=True)
class SpeedModel:
    """Fixed per-gradient computation times for each worker."""

    times: np.ndarray  # [n] positive floats

    @property
    def n(self) -> int:
        return int(self.times.shape[0])

    def __post_init__(self):
        if np.any(self.times <= 0):
            raise ValueError("worker times must be positive")


def truncated_normal_speeds(
    n: int, mu: float = 1.0, std: float = 1.0, seed: int = 0, floor: float = 1e-2
) -> SpeedModel:
    """Draw s_i ~ TN(mu, std), redrawing until positive (paper §5)."""
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=np.float64)
    for i in range(n):
        t = rng.normal(mu, std)
        while t <= floor:
            t = rng.normal(mu, std)
        out[i] = t
    return SpeedModel(times=out)


@dataclasses.dataclass(frozen=True)
class Event:
    """A worker finishing one stochastic-gradient computation.

    ``start_time``/``finish_time`` are continuous simulated wall-clock;
    ``server_iter`` is assigned by the consumer (one commit == one server
    iteration in the fully asynchronous Algorithm 1).
    """

    worker: int
    start_time: float
    finish_time: float


def event_stream(speeds: SpeedModel, max_events: int) -> Iterator[Event]:
    """Fully-asynchronous completion stream.

    Every worker starts computing at t=0; on completion it immediately receives
    the new model and starts the next job (the paper assumes zero
    communication/server time).  Yields events ordered by finish time.
    """
    heap: list[tuple[float, int, float]] = []  # (finish, worker, start)
    for i in range(speeds.n):
        heapq.heappush(heap, (speeds.times[i], i, 0.0))
    for _ in range(max_events):
        finish, worker, start = heapq.heappop(heap)
        yield Event(worker=worker, start_time=start, finish_time=finish)
        heapq.heappush(heap, (finish + speeds.times[worker], worker, finish))


@dataclasses.dataclass(frozen=True)
class RoundSchedule:
    """Round-based (semi-asynchronous, mode B) commit schedule.

    One *round* == one server iteration of the semi-async variant.  Per round
    ``r`` and worker ``i``:

    * ``start[r, i]``  — worker i begins a new gradient job this round; the
      job's gradient is computed against the round-``r`` model (latched into
      the in-flight buffer by the SPMD step).
    * ``commit[r, i]`` — worker i's in-flight gradient is committed this round
      (DuDe delta applied); by construction the committed gradient was started
      ``tau_i`` rounds earlier, so the model delay is physical, and its data
      was drawn at start, giving ``tau_i >= d_i + 1`` (paper Eq. 4).
    """

    start: np.ndarray  # [rounds, n] bool
    commit: np.ndarray  # [rounds, n] bool
    duration: np.ndarray  # [n] int, job length in rounds

    @property
    def rounds(self) -> int:
        return int(self.start.shape[0])

    @property
    def n(self) -> int:
        return int(self.start.shape[1])


def make_round_schedule(
    speeds: SpeedModel, rounds: int, round_time: float | None = None
) -> RoundSchedule:
    """Quantize the continuous speed model onto server rounds.

    ``round_time`` defaults to the fastest worker's time, so the fastest worker
    commits every round and a worker with ``s_i = k * round_time`` commits
    every ``ceil(k)`` rounds.
    """
    if round_time is None:
        round_time = float(np.min(speeds.times))
    dur = np.maximum(1, np.ceil(speeds.times / round_time).astype(np.int64))
    start = np.zeros((rounds, speeds.n), dtype=bool)
    commit = np.zeros((rounds, speeds.n), dtype=bool)
    for i in range(speeds.n):
        r = 0
        while r < rounds:
            start[r, i] = True
            fin = r + int(dur[i])
            if fin < rounds:
                commit[fin, i] = True
            r = fin
    return RoundSchedule(start=start, commit=commit, duration=dur)


def delay_stats(schedule: RoundSchedule) -> dict:
    """tau_max / tau_avg over the schedule (for EXPERIMENTS reporting)."""
    last_commit = np.zeros(schedule.n, dtype=np.int64)
    taus = []
    for r in range(schedule.rounds):
        for i in np.nonzero(schedule.commit[r])[0]:
            taus.append(r - last_commit[i])
            last_commit[i] = r
    taus = np.asarray(taus) if taus else np.zeros(1, dtype=np.int64)
    return {
        "tau_max": int(taus.max()),
        "tau_avg": float(taus.mean()),
        "commit_rate": float(schedule.commit.mean()),
    }
