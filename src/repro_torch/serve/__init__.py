"""Continuous-batching serve scheduler of the port (``repro.serve``
counterpart): the admission queue (`queue`), same-key op combining
(`combine`), the maintenance worker (`worker`), replayable traces
(`trace`), the model-side decode (`decode`) and the scheduler itself
(`scheduler`).  ``repro_torch.serving.ServeEngine`` is a shim over
`ServeScheduler`; ``LockstepServeEngine`` is the parity oracle.
"""

from repro_torch.serve.combine import combine_ops, dedupe_lookups
from repro_torch.serve.queue import RequestQueue, ServeRequest
from repro_torch.serve.scheduler import SchedulerConfig, ServeScheduler
from repro_torch.serve.trace import StepPlan, synth_trace
from repro_torch.serve.worker import MaintenanceWorker

__all__ = [
    "MaintenanceWorker",
    "RequestQueue",
    "SchedulerConfig",
    "ServeRequest",
    "ServeScheduler",
    "StepPlan",
    "combine_ops",
    "dedupe_lookups",
    "synth_trace",
]
