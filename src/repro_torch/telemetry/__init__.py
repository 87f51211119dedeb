"""Closed-loop telemetry: measured step timing, online straggler
estimation, and record/replay traces (port of ``repro.telemetry``)."""
from repro_torch.telemetry.estimator import EstimatorConfig, StragglerEstimator
from repro_torch.telemetry.timing import (RankTimer, StepSample,
                                          capture_sample, measurement_rng)
from repro_torch.telemetry.trace import (TRACE_SCHEMA, TRACE_VERSION,
                                         TraceFormatError, TraceReader,
                                         TraceWriter, replica_schedules,
                                         schedule_from_trace)

__all__ = [
    "EstimatorConfig", "StragglerEstimator", "RankTimer", "StepSample",
    "capture_sample", "measurement_rng",
    "TRACE_SCHEMA", "TRACE_VERSION", "TraceFormatError", "TraceReader",
    "TraceWriter", "replica_schedules", "schedule_from_trace",
]
