"""Registration handles: apply / backward / shoot on external point sets
(counterpart of ``difficp_tpu/models/registration.py``; reference
registrations.py:21-123).

A handle wraps frozen registration parameters of one frame; ``apply`` warps
external points forward, ``backward`` inverts by shooting from the arrival
state with negated momenta (registrations.py:66-69); the affine handle
inverts by a linear solve.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from difficp_torch.models import affine as affine_mod
from difficp_torch.models import lddmm as lddmm_mod


class LDDMMRegistration(NamedTuple):
    cfg: lddmm_mod.LDDMMConfig
    q0: torch.Tensor
    a0: torch.Tensor
    qmask: Optional[torch.Tensor] = None

    def shoot(self, x=None, backward: bool = False, save_traj: bool = True):
        """Geodesic shoot advecting external points x (registrations.py:56-69)."""
        x = None if x is None else torch.as_tensor(x, dtype=self.q0.dtype,
                                                   device=self.q0.device)
        with torch.no_grad():
            if not backward:
                return lddmm_mod.shoot(self.cfg, self.q0, self.a0, x, self.qmask,
                                       save_traj=save_traj)
            fwd, _ = lddmm_mod.shoot(self.cfg, self.q0, self.a0, None, self.qmask)
            return lddmm_mod.shoot(self.cfg, fwd.q, -fwd.p, x, self.qmask,
                                   save_traj=save_traj)

    def apply(self, x):
        final, _ = self.shoot(x, save_traj=False)
        return final.x

    def backward(self, y):
        final, _ = self.shoot(y, backward=True, save_traj=False)
        return final.x


class AffineRegistration(NamedTuple):
    cfg: affine_mod.AffineConfig
    m: torch.Tensor
    t: torch.Tensor

    def _points(self, x):
        return torch.as_tensor(x, dtype=self.m.dtype, device=self.m.device)

    def apply(self, x):
        return affine_mod.apply(self.m, self.t, self._points(x))

    def backward(self, y):
        return affine_mod.backward(self.m, self.t, self._points(y))

    def shoot(self, x):
        """Interpolated trajectory (host-side; visualization)."""
        return affine_mod.shoot(self.cfg, self.m, self.t, x)
