"""Unschedulable-reason rendering for the plan decode.

The subset of the JAX package's ``solver/explain.py`` the solve path
needs: the human request label of a group and the coded reason for a pod
the packer could not place. Constraint-elimination ledgers (``explain=True``
builds) are not ported, so a group's ``ledger`` is always None here and
the packer's own fallback code stands.
"""

from __future__ import annotations

import numpy as np

from . import taxonomy


def request_label(vec: np.ndarray) -> str:
    """A human label for a group's request vector ("cpu=500m
    memory=1024Mi"), rendered from the non-zero axes. The implicit
    one-pod occupancy every real pod carries is dropped — it is not a
    user request."""
    from ..apis.resources import vec_to_quantities
    q = vec_to_quantities(vec)
    if q.get("pods") == "1":
        del q["pods"]
    parts = [f"{k}={v}" for k, v in q.items()]
    return " ".join(parts) or "(no requests)"


_UNPLACED_DETAILS = {
    taxonomy.ICE_HOLD: "all compatible offerings currently unavailable",
    taxonomy.NO_OFFERING: "no compatible nodepool/instance-type offering",
    taxonomy.NO_EXISTING_FIT:
        "only existing capacity could host this pod and none fits",
    taxonomy.NO_NEW_NODE_SHAPE:
        "no empty node of any feasible type can hold this pod",
    taxonomy.NO_FIT: "does not fit any existing node or new-node shape",
}


def unplaced_reason(group, fallback: str = taxonomy.NO_FIT) -> str:
    """The coded reason for a pod the packer could not place. The
    group's ledger refines it — a group whose offerings were zeroed by
    the ICE stage is weather-caused pending, not a shape problem — and
    ``fallback`` carries the packer's own distinction (the host-FFD rung
    knows no-existing-fit from no-new-node-shape; the device decode only
    knows no-fit)."""
    led = getattr(group, "ledger", None)
    code = (led.blame_code() if led is not None else "") or fallback
    return taxonomy.reason(code, _UNPLACED_DETAILS.get(code, ""))
