"""Motor mixing: policy action [-1, 1]^4 -> per-rotor thrusts in N.

Counterpart of `drone_tpu/mixing.py`; same clamp and multiply order as
`oracle/drone_oracle.c:drone_mix`.
"""

from __future__ import annotations

import torch


def mix(action, p, dr_thrust):
    """action (N, 4) -> thrusts (N, 4) in [0, thrust_max*dr_thrust].

    f = clamp((a + 1) * 0.5, 0, 1);  F = f * thrust_max * dr_thrust
    """
    f = (action + 1.0) * 0.5
    f = torch.clamp_max(torch.clamp_min(f, 0.0), 1.0)
    return f * p.thrust_max * dr_thrust[:, None]
