"""Saturn's core system: Parallelism Library -> Trial Runner -> joint
Solver -> event-driven cluster runtime.

The scheduling modules are numpy and scipy, copies of the JAX package's
with their imports pointed at this package; the Trial Runner's empirical
trials, ``LocalTorchBackend`` and ``LocalRunner`` train with PyTorch.

Layering (each layer only imports downward):

    schedule.py      Schedule IR: Placement / ScheduleEntry / Schedule, the
                     Policy interface all planners implement
    events.py        event types + queue (arrival, completion, restart,
                     cluster events, tick)
    chaos.py         fault injection: ChaosTrace + typed cluster events
                     (failures, spot churn, resizes) + seeded generators
    placement.py     pluggable device assignment: FlatPool | NodeAware
                     (elastic pools grow/shrink under cluster events)
    runtime.py       ClusterState + the backend-agnostic discrete-event
                     engine; the ExecutionBackend protocol + SimBackend
    local_backend.py LocalTorchBackend: the same Schedule IR really
                     trains on this machine's devices (checkpointed
                     preemption, measured-throughput feedback)
    profiler.py      the Trial Runner: empirical trials and the napkin
                     roofline, the JSON profile cache, HardwareSpec
    perfmodel.py     throughput curves over GPU count: anchor trials +
                     interpolation (PerfModel, the profiles contract);
                     ObservedProfiles measured-feedback overlay
    solver.py        the joint MILPs (flat + node-locality), greedy fallback
    lns.py           interval-time Large-Neighborhood-Search scheduler
                     (no slot grid: real-valued starts, event-sweep
                     capacity) — the portfolio's second engine
    portfolio.py     SolverBackend protocol + registry; races MILP vs
                     LNS under a shared wall budget, first-to-gap wins
                     (optional CP-SAT slot behind a guarded import)
    baselines.py     paper baselines + the Saturn policy (emit Schedule IR;
                     SaturnPolicy(solver="portfolio") races the engines)
    executor.py      simulate() compatibility wrapper + legacy comparator,
                     LocalRunner serial building block
    api.py           SaturnSession facade
                     (run(backend="sim"|"local"))

Not ported yet: the process backend (ROADMAP A6) and the analytic and
roofline profiling that read compiled HLO (A12).
"""
from .api import SaturnSession                              # noqa: F401
from .chaos import (CapacityChange, ChaosTrace,             # noqa: F401
                    NodeFailure, NodeRecovery, RetryPolicy, SpotGrant,
                    SpotRevoke, WorkerFailure, WorkerFault, merge_events,
                    poisson_node_failures, poisson_worker_faults,
                    spot_capacity_trace)
from .job import (ClusterSpec, DeviceClass, Job,            # noqa: F401
                  ServeJob, hpo_grid)
from .local_backend import LocalTorchBackend                # noqa: F401
from .perfmodel import (MergedProfiles, ObservedProfiles,   # noqa: F401
                        PerfModel, ThroughputCurve, select_anchor_counts)
from .placement import ClassPool, FlatPool, NodeAware, make_backend  # noqa: F401
from .portfolio import (SolverBackend, available_backends,  # noqa: F401
                        register_backend, solve_portfolio)
from .profiler import (HARDWARE, HardwareSpec,              # noqa: F401
                       TrialRunner, hardware_from_device)
from .runtime import (ExecutionBackend, SimBackend,         # noqa: F401
                      SimResult, execute_runtime, simulate_runtime)
from .schedule import Placement, Policy, Schedule, ScheduleEntry  # noqa: F401
