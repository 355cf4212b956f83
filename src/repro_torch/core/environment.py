"""Dynamic driving environment (paper §2.2, §8.1).

Generates task queues: a route through an area (UB / UHW / HW) is a timeline
of scenario segments (go-straight, with randomized turn / reverse segments
bounded by the Table-13 parameters); each camera group fires at its
(area, scenario)-dependent rate; every frame becomes a DET task (YOLO and
SSD alternating per camera, §2.1) and — except rear cameras outside
reversing — a TRA task (GOTURN).

Camera rate calibration: the paper publishes only the urban aggregate
requirements (Table 5: GS 870/840, TL 950/920, RE 740/740 FPS for DET/TRA).
The per-group rates below are chosen to reproduce those aggregates exactly
with the Table-4 camera counts; UHW/HW scale them by the Fig-1 trend
(higher speed -> higher required frame rate), since Fig 1's numeric labels
are not recoverable from the text.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.criteria import camera_safety_time
from repro_torch.core.tasks import Task, TaskKind


class Area(str, enum.Enum):
    UB = "UB"
    UHW = "UHW"
    HW = "HW"


class Scenario(str, enum.Enum):
    GS = "GS"  # go straight
    TL = "TL"  # turn (left/right symmetric, §8.1)
    RE = "RE"  # reverse


@dataclasses.dataclass(frozen=True)
class CameraGroup:
    name: str
    count: int


# Table 4
CAMERA_GROUPS = (
    CameraGroup("FC", 11),
    CameraGroup("FLSC", 4),
    CameraGroup("RLSC", 4),
    CameraGroup("FRSC", 4),
    CameraGroup("RRSC", 4),
    CameraGroup("RC", 3),
)

# per-camera Hz by (scenario, group) in URBAN; reproduces Table 5 aggregates:
#   GS:  DET = 11*40 + 16*25 + 3*10  = 870 ; TRA (no RC) = 840
#   TL:  DET = 11*40 + 16*30 + 3*10  = 950 ; TRA (no RC) = 920
#   RE:  DET = 11*20 + 16*25 + 3*40  = 740 ; TRA (RC tracked while
#        reversing) = 740
_URBAN_HZ = {
    Scenario.GS: {"FC": 40.0, "FLSC": 25.0, "RLSC": 25.0, "FRSC": 25.0,
                  "RRSC": 25.0, "RC": 10.0},
    Scenario.TL: {"FC": 40.0, "FLSC": 30.0, "RLSC": 30.0, "FRSC": 30.0,
                  "RRSC": 30.0, "RC": 10.0},
    Scenario.RE: {"FC": 20.0, "FLSC": 25.0, "RLSC": 25.0, "FRSC": 25.0,
                  "RRSC": 25.0, "RC": 40.0},
}

# Fig-1 trend: faster areas need higher frame rates
_AREA_SCALE = {Area.UB: 1.0, Area.UHW: 1.15, Area.HW: 1.3}


def camera_hz(area: Area, scenario: Scenario, group: str) -> float:
    if area == Area.HW and scenario == Scenario.RE:
        raise ValueError("reversing is not allowed on the highway")
    return _URBAN_HZ[scenario][group] * _AREA_SCALE[area]


@dataclasses.dataclass(frozen=True)
class EnvironmentParams:
    """Table 12/13 parameters."""
    area: Area = Area.UB
    route_km: float = 1.0
    velocity_kmh: float = 60.0
    max_times_turn: int = 10
    max_times_reverse: int = 10
    max_duration_turn: float = 10.0
    max_duration_reverse: float = 20.0
    rate_scale: float = 1.0  # subsample factor for CPU-scale experiments
    seed: int = 0


@dataclasses.dataclass
class Segment:
    scenario: Scenario
    start: float
    duration: float


class DrivingEnvironment:
    """Builds the scenario timeline and emits the task queue."""

    def __init__(self, params: EnvironmentParams):
        self.params = params
        self.rng = np.random.default_rng(params.seed)
        self.route_s = params.route_km / params.velocity_kmh * 3600.0
        self.segments = self._build_segments()

    def _build_segments(self) -> list:
        p = self.params
        rng = self.rng
        n_turn = int(rng.integers(0, p.max_times_turn + 1))
        n_rev = (0 if p.area == Area.HW
                 else int(rng.integers(0, p.max_times_reverse + 1)))
        events = []
        for _ in range(n_turn):
            d = rng.uniform(1.0, p.max_duration_turn)
            events.append((Scenario.TL, d))
        for _ in range(n_rev):
            d = rng.uniform(1.0, p.max_duration_reverse)
            events.append((Scenario.RE, d))
        rng.shuffle(events)
        # place events at random non-overlapping starts; GS fills the rest
        total_event = sum(d for _, d in events)
        free = max(self.route_s - total_event, 0.0)
        gaps = rng.dirichlet(np.ones(len(events) + 1)) * free \
            if events else np.array([free])
        segs: list = []
        t = 0.0
        for i, (sc, d) in enumerate(events):
            if gaps[i] > 0:
                segs.append(Segment(Scenario.GS, t, gaps[i]))
                t += gaps[i]
            segs.append(Segment(sc, t, d))
            t += d
        if gaps[-1] > 0:
            segs.append(Segment(Scenario.GS, t, gaps[-1]))
        return segs

    def scenario_at(self, t: float) -> Scenario:
        for seg in self.segments:
            if seg.start <= t < seg.start + seg.duration:
                return seg.scenario
        return Scenario.GS

    def build_task_queue(self) -> list:
        """All tasks for the route, sorted by arrival time."""
        p = self.params
        tasks: list = []
        uid = 0
        det_toggle: dict = {}
        for seg in self.segments:
            for group in CAMERA_GROUPS:
                hz = camera_hz(p.area, seg.scenario, group.name) * p.rate_scale
                if hz <= 0:
                    continue
                period = 1.0 / hz
                for cam in range(group.count):
                    t = seg.start + self.rng.uniform(0, period)
                    while t < seg.start + seg.duration:
                        st = camera_safety_time(group.name, p.area.value,
                                                seg.scenario.value)
                        # DET task: YOLO/SSD alternate per camera (§2.1)
                        key = (group.name, cam)
                        use_yolo = det_toggle.get(key, True)
                        det_toggle[key] = not use_yolo
                        tasks.append(Task(
                            uid=uid,
                            kind=TaskKind.YOLO if use_yolo else TaskKind.SSD,
                            camera_group=group.name, camera_id=cam,
                            arrival_time=t, safety_time=st))
                        uid += 1
                        # TRA task: rear cameras only while reversing
                        if group.name != "RC" or seg.scenario == Scenario.RE:
                            tasks.append(Task(
                                uid=uid, kind=TaskKind.GOTURN,
                                camera_group=group.name, camera_id=cam,
                                arrival_time=t, safety_time=st))
                            uid += 1
                        t += period
        tasks.sort(key=lambda task: task.arrival_time)
        return tasks


def build_task_queue(params: EnvironmentParams) -> list:
    return DrivingEnvironment(params).build_task_queue()


def build_task_arrays(params: EnvironmentParams):
    """Precompiled struct-of-arrays queue for the device-resident scan
    engine (``tasks.TaskArrays``): one host-side pass, then the route is
    a handful of jnp arrays."""
    from repro_torch.core.tasks import tasks_to_arrays
    return tasks_to_arrays(DrivingEnvironment(params).build_task_queue())


def build_route_batch(params_list: list):
    """Stack several routes (different seeds/areas) into one [R, T_max]
    ``TaskArrays`` batch for the vmapped engine paths."""
    from repro_torch.core.tasks import stack_task_arrays, tasks_to_arrays
    return stack_task_arrays(
        [tasks_to_arrays(DrivingEnvironment(p).build_task_queue())
         for p in params_list])
