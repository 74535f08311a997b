"""The start of a gradcomponent (eta != 0) registration with dense support,
run by the JAX package on the CPU: v2p's momenta for a zero field (the CG
ridge solve above the dense pair limit) and one shoot from them, on
``examples/run_large.py``'s geometry (spiral_cloud from seed 0, sigma = 0.1,
lambda = 200, version "logdet", nt = 10 Euler unless --nt says otherwise).

It prints one JSON line per size: the largest |a0|, |q1| and |p1|, the
shoot's cost and the seconds.  ``chip_smoke.py`` (phase dense_eta_start)
prints the same readings for the PyTorch port, in float32 on its kernels and
in float64 on their plain versions, from the same points.

    JAX_PLATFORMS=cpu python tests/eta_start_jax.py --n 8192 16384
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[8192, 16384])
    ap.add_argument("--nt", type=int, default=10)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from difficp_tpu.examples.run_large import spiral_cloud
    from difficp_tpu.models import lddmm

    jax.config.update("jax_platforms", "cpu")
    cfg = lddmm.make_config(sigma=0.1, lambd=200.0, version="logdet", nt=args.nt,
                            scheme="Euler")
    for n in args.n:
        t0 = time.perf_counter()
        q = jnp.asarray(spiral_cloud(n, np.random.default_rng(0)))
        m = jnp.ones((n,), q.dtype)
        a0 = lddmm.v2p(cfg, q, jnp.zeros_like(q), rcond=1e-3, qmask=m)
        final, _ = lddmm.shoot(cfg, q, a0, None, m)
        q1 = float(jnp.abs(final.q).max())
        print(json.dumps({
            "impl": "difficp_tpu (JAX, CPU, float32)", "N": n, "nt": args.nt,
            "max_abs_a0": float(jnp.abs(a0).max()), "max_abs_q1": q1,
            "max_abs_p1": float(jnp.abs(final.p).max()), "cost": float(final.cost),
            "bounded": bool(np.isfinite(q1) and q1 < 10.0),
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
