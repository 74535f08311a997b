"""Fixed-step ODE integrators over NamedTuple states (counterpart of
``difficp_tpu/utils/integrators.py``).

The time loop is a Python loop; gradients come from autograd through it.  A
state is a NamedTuple whose fields are tensors or ``None`` (a field that is
``None`` stays ``None``).  With ``save_traj`` the trajectory is returned as
stacked tensors with an nt+1 leading axis, t = 0 included.
"""

from __future__ import annotations

from typing import Callable

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over tensors in (nested) tuples / NamedTuples,
    keeping ``None`` leaves."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    return fn(*trees)


def integrate(
    ode_fn: Callable,
    state0,
    nt: int = 10,
    scheme: str = "Ralston",
    deltat: float = 1.0,
    save_traj: bool = False,
):
    """Integrate d(state)/dt = ode_fn(state) from t=0 to deltat in nt steps.

    :param scheme: "Euler" or "Ralston" (2nd order; reference default).
    :return: (final_state, traj_or_None)
    """
    dt = deltat / nt
    if scheme == "Euler":
        def step(x):
            xdot = ode_fn(x)
            return tree_map(lambda a, b: a + dt * b, x, xdot)
    elif scheme == "Ralston":
        def step(x):
            xdot = ode_fn(x)
            xi = tree_map(lambda a, b: a + (2.0 * dt / 3.0) * b, x, xdot)
            xdoti = ode_fn(xi)
            return tree_map(lambda a, b, c: a + (0.25 * dt) * (b + 3.0 * c),
                            x, xdot, xdoti)
    else:
        raise ValueError(f"Unknown integration scheme: {scheme}")

    x = state0
    traj = [state0] if save_traj else None
    for _ in range(nt):
        x = step(x)
        if save_traj:
            traj.append(x)
    if save_traj:
        return x, tree_map(lambda *ts: torch.stack(ts, 0), *traj)
    return x, None
