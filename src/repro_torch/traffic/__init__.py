"""repro_torch.traffic — continuous-batching serving simulator with
perfmodel-predicted SLO percentiles (the port of ``repro/traffic``).

The serving-SLO loop on top of the characterization stack: seeded arrival
traces (``traces``), one continuous-batching scheduler driving either the
real engine or a LatencyDB-priced simulator (``scheduler`` / ``simulate``),
and exact-rank percentile SLO metrics (``metrics``). The simulator prices
an op record of each eager step, not HLO (``simulate``'s docstring).
"""
from repro_torch.traffic.metrics import (RequestMetrics, SloSummary, request_metrics,
                                         slo_table, summarize)
from repro_torch.traffic.scheduler import (ContinuousBatchingScheduler, EngineExecutor,
                                           Executor, RequestResult, ScheduleResult)
from repro_torch.traffic.simulate import (PredictedCostModel, SimulatedExecutor, run_slo_point,
                                          simulate)
from repro_torch.traffic.traces import (Request, TraceConfig, generate_trace, load_trace,
                                        save_trace)

__all__ = [
    "Request", "TraceConfig", "generate_trace", "save_trace", "load_trace",
    "ContinuousBatchingScheduler", "EngineExecutor", "Executor",
    "RequestResult", "ScheduleResult",
    "PredictedCostModel", "SimulatedExecutor", "run_slo_point", "simulate",
    "RequestMetrics", "SloSummary", "request_metrics", "summarize",
    "slo_table",
]
