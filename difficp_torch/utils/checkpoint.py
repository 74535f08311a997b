"""Checkpoint / resume of registration state (counterpart of
``difficp_tpu/utils/checkpoint.py``, in its file format).

- ``save_psr`` / ``load_psr`` round-trip a ``DiffPSR`` / ``AffinePSR``
  through one pickle-free ``.npz``: host numpy arrays under the JAX
  package's keys (``x1``, ``y``, ``ptw``, ``regloss``, ``quadloss``,
  ``gmm{s}_{field}``, then ``a0`` / ``q0`` / ``qmask`` or ``M`` / ``t``) and
  a ``__header__`` JSON (``kind``, ``n_gmm``, ``gmm_fields``, ``Cfe``,
  ``FE``).  A checkpoint written by either package loads into the other.
- ``save_pytree`` / ``load_leaves`` are the generic helpers.  Leaves are
  numbered in the JAX package's order (``jax.tree.flatten``: dict keys
  sorted, an ``OrderedDict`` in insertion order, ``None`` no leaf), so
  ``leaf_i`` is the same leaf in both packages.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from difficp_torch.utils.spec import on_cpu, resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list):
    """Append the leaves of ``tree`` in jax.tree.flatten's order; return the
    structure as a nested (kind, node type, keys, children) tuple."""
    if tree is None:
        return ("none", None, None, ())
    if _is_namedtuple(tree):
        return ("namedtuple", type(tree), None, tuple(_flatten(c, leaves) for c in tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, type(tree), None,
                tuple(_flatten(c, leaves) for c in tree))
    if isinstance(tree, dict):
        keys = list(tree) if isinstance(tree, OrderedDict) else sorted(tree)
        return ("dict", type(tree), keys, tuple(_flatten(tree[k], leaves) for k in keys))
    leaves.append(tree)
    return ("leaf", None, None, ())


def _unflatten(node, leaves):
    kind, typ, keys, children = node
    if kind == "none":
        return None
    if kind == "leaf":
        return next(leaves)
    vals = [_unflatten(c, leaves) for c in children]
    if kind == "namedtuple":
        return typ(*vals)
    if kind == "dict":
        return typ(zip(keys, vals))
    return typ(vals)


class TreeDef:
    """The structure of a flattened tree (``jax.tree.flatten``'s treedef):
    ``unflatten(leaves)`` rebuilds it."""

    def __init__(self, node, num_leaves: int):
        self._node = node
        self.num_leaves = num_leaves

    def unflatten(self, leaves):
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"{self.num_leaves} leaves expected, got {len(leaves)}")
        return _unflatten(self._node, iter(leaves))


def tree_flatten(tree) -> tuple[list, TreeDef]:
    leaves: list = []
    node = _flatten(tree, leaves)
    return leaves, TreeDef(node, len(leaves))


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> TreeDef:
    leaves, treedef = tree_flatten(tree)
    arrays = {f"leaf_{i}": on_cpu(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps({"meta": meta or {}, "n_leaves": len(leaves)}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return treedef


def load_leaves(path: str, device=None):
    """(leaves as tensors on ``device``, meta); ``None`` means the card."""
    device = resolve_device(device)
    data = np.load(path, allow_pickle=False)
    hdr = json.loads(bytes(data["__treedef__"].tobytes()).decode())
    leaves = [torch.as_tensor(data[f"leaf_{i}"], device=device)
              for i in range(hdr["n_leaves"])]
    return leaves, hdr["meta"]


def save_psr(path: str, psr):
    """Checkpoint the dynamic state of a PSR (GMM parameters, momenta and
    support or affine maps, warped points, targets, bookkeeping) as host
    arrays in one ``.npz`` (``np.savez`` adds the suffix) plus a JSON
    header.  The standard algorithm's PSRs are not supported (TypeError),
    as in the JAX package."""
    from difficp_torch.models.psr import AffinePSR, DiffPSR

    if not isinstance(psr, (DiffPSR, AffinePSR)):
        raise TypeError(f"unsupported PSR type: {type(psr)!r}")
    arrays = {name: on_cpu(getattr(psr, name))
              for name in ("x1", "y", "ptw", "regloss", "quadloss")}
    for s, g in enumerate(psr.gmm):
        for name, v in zip(g._fields, g):
            arrays[f"gmm{s}_{name}"] = on_cpu(v)
    if isinstance(psr, DiffPSR):
        kind = "diff"
        arrays.update(a0=on_cpu(psr.a0), q0=on_cpu(psr.q0), qmask=on_cpu(psr.qmask))
    else:
        kind = "affine"
        arrays.update(M=on_cpu(psr.M), t=on_cpu(psr.t))
    header = {
        "kind": kind,
        "n_gmm": len(psr.gmm),
        "gmm_fields": list(psr.gmm[0]._fields),
        "Cfe": [float(c) for c in psr.Cfe],
        "FE": psr.FE,
    }
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_psr(path: str, psr):
    """Restore a checkpoint into a freshly constructed PSR of the same
    configuration (the data and configs are rebuilt by the caller; only the
    dynamic state is stored).  Every array lands on the PSR's own device in
    the PSR's own dtypes.  The support scheme is not stored: set the same
    scheme (dense, or ``set_support_scheme`` with the same grid, decimation
    or custom points) on the fresh PSR before loading; a stored support of
    another shape raises ValueError.  What the PSR threads between calls
    about the old momenta (the entry value and gradient, the stall flags, a
    pending start free energy) is dropped, so the loaded FE is the baseline
    of the next step."""
    from difficp_torch.models import gmm as gmm_mod

    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    hdr = json.loads(bytes(data["__header__"].tobytes()).decode())
    dev = psr.device

    def like(key, ref):
        return torch.as_tensor(data[key], dtype=ref.dtype, device=dev)

    ref_gmm = psr.gmm[0]
    psr.gmm = [
        gmm_mod.GMMState(*(like(f"gmm{s}_{name}", getattr(ref_gmm, name))
                           for name in hdr["gmm_fields"]))
        for s in range(hdr["n_gmm"])
    ]
    psr.x1 = like("x1", psr.x1)
    psr.y = like("y", psr.y)
    psr.ptw = like("ptw", psr.ptw)
    psr.Cfe = [torch.tensor(c, dtype=torch.float32, device=dev) for c in hdr["Cfe"]]
    psr.regloss = like("regloss", psr.regloss)
    psr.quadloss = like("quadloss", psr.quadloss)
    psr.FE = hdr["FE"]
    if hdr["kind"] == "diff":
        if tuple(data["q0"].shape) != tuple(psr.q0.shape):
            raise ValueError(f"the checkpoint's support {data['q0'].shape} is not the "
                             f"PSR's {tuple(psr.q0.shape)}: set the same support scheme "
                             "before load_psr")
        psr.a0 = like("a0", psr.a0)
        psr.q0 = like("q0", psr.q0)
        psr.qmask = like("qmask", psr.qmask)
        psr._reg_vg = None
        psr._reg_stall = None
        psr._start_pending = False
    else:
        psr.M = like("M", psr.M)
        psr.t = like("t", psr.t)
    return psr
