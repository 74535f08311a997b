"""One rank of the port's point-sharded ring over gloo, for
tests/test_torch_ring.py.

    python tests/torch_ring_worker.py DIR RANK WORLD

Reads DIR/inputs.npz (whole point sets and the configuration's scalars) and,
when it comes to it, DIR/jax_step1.npz (the JAX package's state after one
two-set step, written by the test meanwhile); meets the other ranks through
the file store DIR/store, and writes its results to DIR/out_RANK.npz: its rows
of the ring reductions and of the shoot, its shard of the sharded loss's
gradient, and the free energies of the two-set steps.  Imports torch and the
port only.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from difficp_torch.models import gmm as gmm_mod  # noqa: E402
from difficp_torch.models import lddmm  # noqa: E402
from difficp_torch.parallel import (  # noqa: E402
    init_distributed,
    make_ring_shoot,
    make_sharded_reg_loss,
    make_twoset_step,
    ring_hamiltonian,
    ring_rhs_ext,
    ring_rhs_self,
    shard_twoset,
    zero_twoset_memory,
)
from difficp_torch.utils.convert import twoset_out_from_numpy  # noqa: E402


def _scalar(inp, name):
    return float(inp[name])


def _wait_for(path, seconds=300.0):
    end = time.monotonic() + seconds
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)
    return dict(np.load(path))


def run(directory, inp, group, rank, world):
    out = {}

    def shard(*names):
        return shard_twoset(group, *(inp[n] for n in names), device="cpu")

    # ring reductions
    q, p, m = shard("self_q", "self_p", "self_m")
    vq, mgq, dc = ring_rhs_self(q, p, m, _scalar(inp, "self_sigma"), True, group,
                                _scalar(inp, "self_eta"))
    out.update(self_vq=vq, self_mgq=mgq, self_dc=dc)
    q, p, mq = shard("ext_q", "ext_p", "ext_mq")
    x, mx = shard("ext_x", "ext_mx")
    vq, mgq, dc, vx = ring_rhs_ext(q, p, x, mq, mx, _scalar(inp, "ext_sigma"), True, group)
    out.update(ext_vq=vq, ext_mgq=mgq, ext_dc=dc, ext_vx=vx)
    q, p, m = shard("ham_q", "ham_p", "ham_m")
    out["ham"] = ring_hamiltonian(q, p, m, _scalar(inp, "ham_sigma"), _scalar(inp, "ham_eta"),
                                  group)
    q, p, m = shard("shoot_q", "shoot_p", "shoot_m")
    for scheme in ("Euler", "Ralston"):
        shoot = make_ring_shoot(_scalar(inp, "shoot_sigma"), 100.0, True, 5, group, scheme)
        q1, p1, cost = shoot(q, p, m)
        out.update({f"shoot_{scheme}_q1": q1, f"shoot_{scheme}_cost": cost})

    # the sharded registration loss's gradient, at eta = 0 and eta != 0
    a0, q0, y, w, mask = shard("loss_a0", "loss_q0", "loss_y", "loss_w", "loss_mask")
    for version in ("hybrid", "logdet"):
        lcfg = lddmm.make_config(sigma=_scalar(inp, "loss_sigma"), lambd=500.0,
                                 version=version, nt=3, scheme="Euler")
        a = a0.clone().requires_grad_(True)
        loss = make_sharded_reg_loss(lcfg, group)(a, q0, y, w, mask, _scalar(inp, "loss_sig2"))
        (g,) = torch.autograd.grad(loss, a)
        out.update({f"loss_{version}": loss, f"grad_{version}": g})

    # two two-set steps from the start, then one from the JAX package's state
    # after its first step
    gcfg = gmm_mod.GMMConfig()
    lcfg = lddmm.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=3, scheme="Euler")
    step = make_twoset_step(gcfg, lcfg, group, em_iters=3, reg_nmax=1, reg_inner=8,
                            reg_ls=8, tol=1e-3, carry_memory=True)
    q0, mask = shard("ts_q0", "ts_mask")
    gstate = gmm_mod.GMMState(*(torch.as_tensor(inp[f"ts_gmm_{f}"])
                                for f in gmm_mod.GMMState._fields))
    a, x1, al, mem = torch.zeros_like(q0), q0, 0.0, zero_twoset_memory(q0)
    fes = []
    for _ in range(2):
        res = step(gstate, q0, a, x1, mask, al, mem)
        gstate, a, x1, al, mem = res.gmm, res.a0, res.x1, res.alpha, res.memory
        fes.append(float(res.fe))
    out.update(ts_fe=np.asarray(fes), ts_alpha=float(al), ts_x1=x1)
    t1 = _wait_for(directory / "jax_step1.npz")
    jax_state = {"gmm": {f: t1[f"gmm_{f}"] for f in gmm_mod.GMMState._fields},
                 "a0": t1["a0"], "x1": t1["x1"], "alpha": t1["alpha"],
                 "memory": {f: t1[f"mem_{f}"] for f in ("S", "Y", "rho", "pos", "count")}}
    s1 = twoset_out_from_numpy(jax_state, rank, world, "cpu")
    res = step(s1.gmm, q0, s1.a0, s1.x1, mask, s1.alpha, s1.memory)
    out["ts_fe_from_jax"] = float(res.fe)
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def main(argv):
    directory, rank, world = Path(argv[1]), int(argv[2]), int(argv[3])
    torch.set_num_threads(1)
    group, size, r = init_distributed("cpu", init_method=f"file://{directory / 'store'}",
                                      world_size=world, rank=rank)
    try:
        if (size, r) != (world, rank):
            raise RuntimeError(f"rank {r} of {size}, expected {rank} of {world}")
        out = run(directory, dict(np.load(directory / "inputs.npz")), group, rank, world)
        np.savez(directory / f"out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
