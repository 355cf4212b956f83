"""Loop schedulers of the port: the interface and registry (``base``) and
the unscheduled baselines (``worst``)."""
from repro_torch.core.schedulers.base import (SCHEDULERS, Scheduler,  # noqa: F401
                                              get_scheduler, register)
from repro_torch.core.schedulers.worst import (RandomScheduler,  # noqa: F401
                                               WorstCaseScheduler)
