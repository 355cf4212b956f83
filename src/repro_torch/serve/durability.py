"""The serving-outcome digest of the port's QoS engine (from the JAX
package's ``repro.serve.durability``).

``serving_digest`` is the bit-exactness contract two engines that served
the same submissions must meet: the sharded waves against the unsharded
ones, the card against the CPU, the port against the JAX engine.  The
rest of the JAX module (snapshots, crash replay, fault injection, the
durable engine and the final-state entries it adds to the digest) is not
ported yet (ROADMAP item 10, second half).
"""
from __future__ import annotations

import numpy as np


def serving_digest(eng) -> dict:
    """Order-canonical arrays of a ``QoSPlacementEngine``'s outcome:
    completed uids with finish and slack, each completed request's
    placements, shed uids, the wave log (waves separated by -1) and the
    virtual clock."""
    comp = sorted(eng.completed, key=lambda r: r.uid)
    flat_log = []
    for w in eng.wave_log:
        flat_log.extend(w)
        flat_log.append(-1)
    out = {
        "completed_uids": np.asarray([r.uid for r in comp], np.int64),
        "finish": np.asarray([r.finish for r in comp], np.float64),
        "slack": np.asarray([r.slack for r in comp], np.float64),
        "shed_uids": np.sort(np.asarray(
            [d["uid"] for d in eng.dead_letter], np.int64)),
        "wave_log": np.asarray(flat_log, np.int64),
        "virtual_time": np.asarray(eng.now, np.float64),
    }
    for r in comp:
        out[f"placements_{r.uid}"] = np.asarray(
            r.summary["placements"], np.int32)
    return out


def digests_equal(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in a)
