"""The port's spiral generators and the four examples (counterparts of
difficp_tpu/examples/spiral.py, run_basic.py, run_multi.py and run_full.py)
at tiny sizes on the CPU, and a three-structure atlas on run_full's frames
through the kernel route.  The generators draw from torch generators, so
their sets are not the JAX package's; they are held to their seeds, their
bounds and the spiral formula.
"""

import numpy as np
import torch

from difficp_tpu.examples.spiral import spiral_centroids as j_spiral_centroids
from difficp_torch.api.icp_atlas import icp_atlas as t_icp_atlas
from difficp_torch.examples import run_basic, run_full, run_multi, spiral
from difficp_torch.ops import backend as TB

torch.set_num_threads(1)


def test_generators_are_seeded():
    """The port's generators draw from the generator they are given: the same
    seed gives the same sets, counts within their bounds."""
    a = run_full.generate_multi_structure_frames(torch.Generator().manual_seed(3), k=2,
                                                 n_bounds=(10, 14))
    b = run_full.generate_multi_structure_frames(torch.Generator().manual_seed(3), k=2,
                                                 n_bounds=(10, 14))
    assert len(a) == 2 and all(len(fr) == 3 for fr in a)
    for fa, fb in zip(a, b):
        for sa, sb in zip(fa, fb):
            assert 10 <= sa.shape[0] < 14 and np.isfinite(sa).all()
            np.testing.assert_array_equal(sa, sb)
    sets, gmm, lcfg = spiral.generate_spiral_point_sets(torch.Generator().manual_seed(0), k=2,
                                                        nk_bounds=(20, 25))
    assert len(sets) == 2 and all(20 <= s.shape[0] < 25 for s in sets)
    assert lcfg.eta == 0.0 and gmm.mu.shape == (20, 2)
    np.testing.assert_allclose(spiral.spiral_centroids().numpy(),
                               np.asarray(j_spiral_centroids()), atol=1e-6)


def test_examples_run_on_the_cpu(tmp_path, monkeypatch):
    psr = run_basic.main(n_iter=1, device="cpu")
    assert psr.fe_increase_events == 0 and np.isfinite(psr.FE)
    # --plot draws run_basic.png in the working directory (viz/, Agg here)
    import matplotlib

    matplotlib.use("Agg")
    monkeypatch.chdir(tmp_path)
    run_basic.main(n_iter=1, plot=True, device="cpu")
    assert (tmp_path / "run_basic.png").stat().st_size > 0
    psr, evol = run_multi.main(k=2, n_iter=1, nk_bounds=(20, 26), device="cpu")
    assert psr.K == 2 and psr.fe_increase_events == 0 and len(evol["a0"]) == 1
    psr, _ = run_full.main(k=2, n_iter=1, n_bounds=(10, 14), device="cpu")
    assert psr.S == 3 and psr.fe_increase_events == 0 and np.isfinite(psr.FE)


def test_interior_padding_kernel_route_matches_dense():
    """Three structures whose padded rows lie inside the row axis
    (structure 0's padded rows before structure 1's points), on the port's
    run_full frames: the kernel route's wrappers (row and data orders, masks;
    their plain versions on the CPU) against the dense route, grid support,
    free energies within 5e-3 relative (tests/test_psr_basic.py:104)."""
    f3 = run_full.generate_multi_structure_frames(torch.Generator().manual_seed(1), k=2,
                                                  n_bounds=(13, 19))
    psrs = {}
    for mode in ("pallas", "dense"):
        psrs[mode], _ = t_icp_atlas(
            f3, {"init_components": ("set", 0)},
            {"type": "diffeomorphic", "lambda_LDDMM": 2e2, "sigma_LDDMM": 0.2},
            {"support_LDDMM": {"scheme": "grid", "rho": 1.0}, "computversion": mode,
             "integration_nt_LDDMM": 4},
            {"max_iterations": 1, "max_repeat_GMM": 5}, printstuff=False, device="cpu")
    TB.set_backend(None)
    kern, dense = psrs["pallas"], psrs["dense"]
    assert kern.S == 3 and (kern.xmask == 0).any()
    interior = kern.xmask[:, : kern.slices[-1][0]] == 0
    assert bool(interior.any())  # some padding sits before the last structure
    assert kern.fe_increase_events == 0 and dense.fe_increase_events == 0
    np.testing.assert_allclose(kern.FE, dense.FE, rtol=5e-3)
    # padded rows stay where the padding put them
    np.testing.assert_array_equal(kern.x1.numpy()[kern.xmask.numpy() == 0],
                                  kern.x0.numpy()[kern.xmask.numpy() == 0])
