"""System design criteria (paper §6): RSS safety time, Matching Score,
Global State Value.

Equation (1) (RSS minimal safe distance for opposite-direction traffic,
Shalev-Shwartz et al.):

    d_min = (v1 + v1_rho)/2 * rho + v1_rho^2 / (2 b_correct)
          + (|v2| + v2_rho)/2 * rho + v2_rho^2 / (2 b)

with v1_rho = v1 + rho*a_accel, v2_rho = |v2| + rho*a_accel.  The paper sets
d_min to each camera's max distance and solves for rho — the camera's
*safety time* (the worst-case response budget).  Expanding gives a quadratic
in rho solved in closed form below.

Constants (paper §6.1): a_max_accel = 8.382 m/s^2 (Tesla max), braking
6.2 m/s^2 (skilled driver), area speed limits 60/80/120 km/h (UB/UHW/HW),
turning capped at 50 km/h.
"""
from __future__ import annotations

import math

A_MAX_ACCEL = 8.382   # m/s^2
A_BRAKE = 6.2         # m/s^2 (both a_min_brake and a_min_brake_correct)

KMH = 1.0 / 3.6

AREA_SPEED_LIMIT_KMH = {"UB": 60.0, "UHW": 80.0, "HW": 120.0}
TURN_SPEED_KMH = 50.0

# camera max distances (m) per function group (paper §6.1 / Fig 7)
CAMERA_MAX_DISTANCE = {
    "FC": 250.0,    # forward
    "RC": 100.0,    # rear
    "FLSC": 80.0,   # side groups
    "RLSC": 80.0,
    "FRSC": 80.0,
    "RRSC": 80.0,
}


def rss_safe_distance(v1: float, v2: float, rho: float,
                      a_accel: float = A_MAX_ACCEL,
                      b_correct: float = A_BRAKE,
                      b: float = A_BRAKE) -> float:
    """Equation (1) evaluated forward: d_min given processing time rho."""
    v1r = v1 + rho * a_accel
    v2r = abs(v2) + rho * a_accel
    return ((v1 + v1r) / 2 * rho + v1r ** 2 / (2 * b_correct)
            + (abs(v2) + v2r) / 2 * rho + v2r ** 2 / (2 * b))


def rss_safety_time(d_min: float, v1: float, v2: float,
                    a_accel: float = A_MAX_ACCEL,
                    b_correct: float = A_BRAKE,
                    b: float = A_BRAKE) -> float:
    """Invert Eq. (1) for rho (the safety time).

    d(rho) = A rho^2 + B rho + C0, quadratic coefficients:
        A  = a + a^2/(2 b1) + a^2/(2 b2)
        B  = v1 + |v2| + a v1/b1 + a |v2|/b2
        C0 = v1^2/(2 b1) + |v2|^2/(2 b2)
    Solve A rho^2 + B rho + (C0 - d_min) = 0, positive root.
    Returns 0.0 when even rho=0 is unsafe (d(0) >= d_min).
    """
    v2 = abs(v2)
    a = a_accel
    A = a + a * a / (2 * b_correct) + a * a / (2 * b)
    B = v1 + v2 + a * v1 / b_correct + a * v2 / b
    C0 = v1 * v1 / (2 * b_correct) + v2 * v2 / (2 * b)
    C = C0 - d_min
    if C >= 0:
        return 0.0
    disc = B * B - 4 * A * C
    return (-B + math.sqrt(disc)) / (2 * A)


def scenario_velocity(area: str, scenario: str) -> float:
    """Vehicle speed (m/s) for an (area, scenario) pair."""
    v_kmh = AREA_SPEED_LIMIT_KMH[area]
    if scenario in ("TL", "TR", "turn"):
        v_kmh = min(v_kmh, TURN_SPEED_KMH)
    if scenario in ("RE", "reverse"):
        v_kmh = min(v_kmh, 10.0)  # reversing is slow; RE not allowed on HW
    return v_kmh * KMH


def camera_safety_time(camera_group: str, area: str, scenario: str) -> float:
    """Safety time (s) for a camera group in a driving context."""
    d = CAMERA_MAX_DISTANCE[camera_group]
    v = scenario_velocity(area, scenario)
    # worst case: obstacle closing at the same speed in the opposite
    # direction (paper's forward-camera model, applied per §6.1 to all
    # camera groups with their own max distance)
    return rss_safety_time(d, v, v)


def matching_score_det(response_time: float, safety_time: float) -> float:
    """MS for object detection (Fig 7a).

    In the accepted region MS grows linearly with response time (slower
    execution within the deadline = lower energy), reaching 1 at the safety
    time; past it MS plummets to -1.
    """
    if response_time <= safety_time and safety_time > 0:
        return response_time / safety_time
    return -1.0


def matching_score_tra(response_time: float, safety_time: float) -> float:
    """MS for object tracking (Fig 7b): step function at ST_OT ( = ST_OD).

    (The paper's prose inverts the labels — "in ACTime, MS is always -1" —
    which contradicts Fig 7 and §8's 'higher MS = better safety'; we use the
    self-consistent reading: inside the accepted window +1, outside -1.)
    """
    return 1.0 if response_time <= safety_time else -1.0


def matching_score(kind: str, response_time: float, safety_time: float) -> float:
    if kind in ("TRA", "tra", "tracking"):
        return matching_score_tra(response_time, safety_time)
    return matching_score_det(response_time, safety_time)


def gvalue(energy: float, runtime: float, r_balance: float,
           e_scale: float = 1.0, t_scale: float = 1.0) -> float:
    """Global State Value = (-E - T + R_Balance)/3 (after normalization).

    ``e_scale``/``t_scale`` are the normalization constants (running maxima
    in the scheduler; explicit here for testability).
    """
    e = energy / max(e_scale, 1e-12)
    t = runtime / max(t_scale, 1e-12)
    return (-e - t + r_balance) / 3.0
