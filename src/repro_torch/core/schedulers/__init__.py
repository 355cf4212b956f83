"""Schedulers of the port: the interface and registry (``base``), the
NumPy loop baselines (``worst``, ``ata``, ``minmin``, ``ga``, ``sa``:
copies of the JAX package's), their tensor twins (``scan``: worst, ATA,
Min-Min) and the tensor GA/SA searches (``metaheuristic``)."""
from repro_torch.core.schedulers.base import (SCHEDULERS, Scheduler,  # noqa: F401
                                              get_scheduler, register)
from repro_torch.core.schedulers.minmin import MinMinScheduler  # noqa: F401
from repro_torch.core.schedulers.ata import ATAScheduler  # noqa: F401
from repro_torch.core.schedulers.ga import GAScheduler  # noqa: F401
from repro_torch.core.schedulers.sa import SAScheduler  # noqa: F401
from repro_torch.core.schedulers.worst import (RandomScheduler,  # noqa: F401
                                               WorstCaseScheduler)
from repro_torch.core.schedulers.scan import (SCAN_SCHEDULERS,  # noqa: F401
                                              get_scan_scheduler,
                                              scan_schedule)
from repro_torch.core.schedulers.metaheuristic import (  # noqa: F401
    DeviceGAScheduler, DeviceSAScheduler, GAConfig, SAConfig,
    make_metaheuristic_fn, make_sharded_metaheuristic_fn,
    metaheuristic_schedule, window_fitness)
