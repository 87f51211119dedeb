"""Record/replay traces for measured per-rank timing (DESIGN_TELEMETRY.md §3).

Format: JSONL, one object per line. Line 1 is the header; every later
line is a :class:`StepSample`:

    {"kind": "header", "schema": "repro.telemetry.trace", "version": 1,
     "num_ranks": 8, "matmul_time": 0.01, "other_time": 0.0015, ...meta}
    {"kind": "sample", "step": 0, "rank_times": [...], "work_frac": [...],
     "plan_signature": "", "wall_s": 0.0}

The header pins the iteration-model constants the trace was recorded
under, so replay can reconstruct each rank's full-workload-equivalent χ
EXACTLY — ``χ = (T − C) / (M · f)`` with the RECORDED M and C — no matter
what model the replaying run uses. That turns every recorded contention
episode into a deterministic regression scenario
(``HeteroSchedule(kind="trace")`` via :func:`schedule_from_trace`).

Writers flush per sample, so a crashed run still leaves a readable trace
prefix. Readers hard-fail on schema/version mismatch: traces are
regression fixtures, and silently reinterpreting an old layout would turn
a format drift into a wrong-answer bug.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.hetero import HeteroSchedule
from repro_torch.telemetry.timing import StepSample

TRACE_SCHEMA = "repro.telemetry.trace"
TRACE_VERSION = 1


class TraceFormatError(ValueError):
    """Raised on schema/version mismatch or a malformed trace file."""


class TraceWriter:
    """Append-only JSONL trace writer (context manager)."""

    def __init__(self, path: str, num_ranks: int, *,
                 matmul_time: float = 0.0, other_time: float = 0.0,
                 meta: Optional[Dict[str, Any]] = None):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self.num_ranks = num_ranks
        self.num_samples = 0
        self._f = open(path, "w")
        header = {"kind": "header", "schema": TRACE_SCHEMA,
                  "version": TRACE_VERSION, "num_ranks": int(num_ranks),
                  "matmul_time": float(matmul_time),
                  "other_time": float(other_time)}
        header.update(meta or {})
        self._f.write(json.dumps(header) + "\n")
        self._f.flush()

    def append(self, sample: StepSample) -> None:
        if self._f is None:
            raise ValueError(f"trace {self.path} already closed")
        self._f.write(json.dumps(sample.to_json()) + "\n")
        self._f.flush()
        self.num_samples += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TraceReader:
    """Validating JSONL trace reader.

    Header fields surface as attributes (``num_ranks``, ``matmul_time``,
    ``other_time``, ``meta``); iterate for :class:`StepSample`s.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path) as f:
            first = f.readline()
        if not first.strip():
            raise TraceFormatError(f"{path}: empty trace file")
        try:
            header = json.loads(first)
        except json.JSONDecodeError as e:
            raise TraceFormatError(f"{path}: unparseable header: {e}") from e
        if header.get("schema") != TRACE_SCHEMA:
            raise TraceFormatError(
                f"{path}: not a telemetry trace "
                f"(schema {header.get('schema')!r} != {TRACE_SCHEMA!r})")
        if header.get("version") != TRACE_VERSION:
            raise TraceFormatError(
                f"{path}: trace version {header.get('version')!r} != "
                f"supported {TRACE_VERSION} — regenerate the trace (see "
                "examples/traces/make_fixtures.py)")
        self.header = header
        self.num_ranks = int(header["num_ranks"])
        self.matmul_time = float(header.get("matmul_time", 0.0))
        self.other_time = float(header.get("other_time", 0.0))
        self.meta = {k: v for k, v in header.items()
                     if k not in ("kind", "schema", "version", "num_ranks",
                                  "matmul_time", "other_time")}

    def __iter__(self) -> Iterator[StepSample]:
        with open(self.path) as f:
            f.readline()                       # header, validated in __init__
            for ln, line in enumerate(f, start=2):
                if not line.strip():
                    continue
                d = json.loads(line)
                if d.get("kind") != "sample":
                    raise TraceFormatError(
                        f"{self.path}:{ln}: unexpected record kind "
                        f"{d.get('kind')!r}")
                s = StepSample.from_json(d)
                if len(s.rank_times) != self.num_ranks:
                    raise TraceFormatError(
                        f"{self.path}:{ln}: sample has "
                        f"{len(s.rank_times)} rank times, header declares "
                        f"{self.num_ranks} ranks")
                yield s

    def samples(self) -> List[StepSample]:
        return list(self)


def trace_chis(reader: TraceReader) -> np.ndarray:
    """Full-workload-equivalent χ per (step, rank) from a recorded trace,
    inverted with the RECORDED model constants."""
    if reader.matmul_time <= 0:
        raise TraceFormatError(
            f"{reader.path}: header matmul_time must be > 0 to reconstruct "
            "χ for replay (was the trace recorded without an iteration "
            "model?)")
    rows = []
    for s in reader.samples():
        f = (np.ones(reader.num_ranks) if s.work_frac is None
             else np.maximum(np.asarray(s.work_frac, np.float64), 1e-3))
        chi = (np.asarray(s.rank_times, np.float64) - reader.other_time) \
            / (reader.matmul_time * f)
        rows.append(np.maximum(chi, 1e-3))
    if not rows:
        raise TraceFormatError(f"{reader.path}: trace has no samples")
    return np.stack(rows)


def schedule_from_trace(path: str, num_ranks: Optional[int] = None,
                        rank_offset: int = 0) -> HeteroSchedule:
    """Build a replaying ``HeteroSchedule(kind="trace")`` from a trace.

    ``num_ranks`` overrides the recorded rank count (χ rows are truncated
    or padded with 1.0 by ``HeteroSchedule.chi``); steps past the end of
    the trace wrap around, so short traces replay as periodic schedules.

    ``rank_offset`` replays a SLICE of a wider trace: χ lanes
    ``[rank_offset, rank_offset + num_ranks)``. This is how one recorded
    cluster trace feeds R replicas — each replica replays its own lane
    block of the shared JSONL (see :func:`replica_schedules`).
    """
    reader = TraceReader(path)
    chis = trace_chis(reader)
    if rank_offset:
        if num_ranks is None:
            raise ValueError("rank_offset needs an explicit num_ranks "
                             "(the width of the slice to replay)")
        if rank_offset + num_ranks > reader.num_ranks:
            raise TraceFormatError(
                f"{path}: slice [{rank_offset}, {rank_offset + num_ranks})"
                f" exceeds the recorded {reader.num_ranks} ranks")
        chis = chis[:, rank_offset:rank_offset + num_ranks]
    return HeteroSchedule(
        num_ranks=num_ranks or reader.num_ranks, kind="trace",
        trace_chis=tuple(tuple(float(c) for c in row) for row in chis))


def replica_schedules(path: str) -> List[HeteroSchedule]:
    """Split ONE recorded cluster trace into per-replica replay schedules.

    The header must carry the cluster tagging written by
    :class:`repro.cluster.ReplicaManager` (or a fixture): ``replicas``
    (R) and ``ranks_per_replica`` (W), with ``num_ranks == R * W`` —
    replica i replays χ lanes ``[i*W, (i+1)*W)``. One JSONL set thus
    replays a whole cluster run deterministically.
    """
    reader = TraceReader(path)
    meta = reader.meta
    if "replicas" not in meta or "ranks_per_replica" not in meta:
        raise TraceFormatError(
            f"{path}: not a cluster trace — header lacks 'replicas'/"
            "'ranks_per_replica' tagging (record one via "
            "repro.cluster.ReplicaManager(record_trace=...))")
    R, W = int(meta["replicas"]), int(meta["ranks_per_replica"])
    if R * W != reader.num_ranks:
        raise TraceFormatError(
            f"{path}: header declares {R} replicas x {W} ranks but the "
            f"trace is {reader.num_ranks} lanes wide")
    return [schedule_from_trace(path, num_ranks=W, rank_offset=i * W)
            for i in range(R)]
