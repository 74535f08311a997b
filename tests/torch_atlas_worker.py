"""One rank of the port's frame-parallel atlas over gloo, for
tests/test_torch_parallel_atlas.py.

    python tests/torch_atlas_worker.py DIR RANK WORLD

Reads DIR/inputs.npz (the padded frames, the GMM start and the threading
problem), meets the other ranks through the file store DIR/store, and writes
DIR/out_RANK.npz: its frames' share of a sharded EM step, of an atlas step
and of a sharded DiffPSR's GMM_opt + Reg_opt, and the free energies of
three threaded atlas steps without and with carried memory.  Imports torch
and the port only.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from difficp_torch.models import gmm as gmm_mod  # noqa: E402
from difficp_torch.models import lddmm  # noqa: E402
from difficp_torch.models.psr import DiffPSR  # noqa: E402
from difficp_torch.parallel import (  # noqa: E402
    em_step_frames_sharded,
    frame_range,
    init_distributed,
    make_atlas_train_step,
    shard_psr,
    zero_atlas_memory,
)


def _gmm(inp, prefix):
    return gmm_mod.GMMState(*(torch.as_tensor(inp[f"{prefix}_{f}"])
                              for f in gmm_mod.GMMState._fields))


def threaded_fes(inp, group):
    """tests/test_parallel.py's threading problem: three atlas steps with
    the step sizes threaded, without and with carried curvature memory."""
    x_all, mask_all = torch.as_tensor(inp["thr_x"]), torch.as_tensor(inp["thr_mask"])
    frames = frame_range(x_all.shape[0], group)
    x, mask = x_all[frames].contiguous(), mask_all[frames].contiguous()
    lcfg = lddmm.make_config(sigma=0.5, lambd=100.0, version="hybrid", nt=3, scheme="Euler")
    fes = {}
    for cm in (False, True):
        step = make_atlas_train_step(gmm_mod.GMMConfig(), lcfg, group, em_iters=2, reg_nmax=1,
                                     use_ext=False, reg_inner=3, reg_ls=8, carry_memory=cm,
                                     memory_size=4)
        st, a0, x1 = _gmm(inp, "thr_gmm"), torch.zeros_like(x), x
        al = torch.zeros(x.shape[0])
        mem = zero_atlas_memory(a0, 4) if cm else None
        seq = []
        for _ in range(3):
            if cm:
                out = step(st, x, a0, x, x1, mask, mask, al, mem)
                mem = out.memory
            else:
                out = step(st, x, a0, x, x1, mask, mask, al)
            st, a0, x1, al = out.gmm, out.a0, out.x1, out.alpha
            seq.append(float(out.fe))
        fes[cm] = seq
    return fes


def run(inp, group):
    out = {}
    x_all, mask_all = torch.as_tensor(inp["x"]), torch.as_tensor(inp["mask"])
    frames = frame_range(x_all.shape[0], group)
    x, mask = x_all[frames].contiguous(), mask_all[frames].contiguous()
    gcfg = gmm_mod.GMMConfig()

    st, y, cfe, fe = em_step_frames_sharded(_gmm(inp, "gmm"), x, mask, gcfg, group)
    out.update({f"em_{f}": getattr(st, f) for f in gmm_mod.GMMState._fields})
    out.update(em_y=y, em_cfe=cfe, em_fe=fe)

    lcfg = lddmm.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=5, scheme="Euler")
    step = make_atlas_train_step(gcfg, lcfg, group, em_iters=3, reg_nmax=1, use_ext=False)
    res = step(_gmm(inp, "gmm"), x, torch.zeros_like(x), x, x, mask, mask)
    out.update(step_mu=res.gmm.mu, step_sigma=res.gmm.sigma, step_x1=res.x1, step_fe=res.fe,
               step_alpha=res.alpha)

    frames_list = [inp[f"frame{k}"] for k in range(int(inp["n_frames"]))]
    psr = DiffPSR(frames_list, _gmm(inp, "gmm"), gcfg, lcfg, device="cpu")
    psr.printstuff = False
    shard_psr(psr, group)
    psr.GMM_opt(max_iterations=5, tol=1e-4)
    psr.Reg_opt(tol=1e-3, nmax=1)
    out.update(psr_fe=psr.FE, psr_a0=psr.a0, psr_events=psr.fe_increase_events,
               psr_k=psr.K)

    fes = threaded_fes(inp, group)
    out.update(thr_fes=np.asarray(fes[False]), thr_fes_mem=np.asarray(fes[True]))
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
        out = run(dict(np.load(directory / "inputs.npz")), group)
        np.savez(directory / f"out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
