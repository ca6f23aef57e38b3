"""Standalone gar usage (counterpart of reference ``examples/gar-elqr.py``):
build a proximal LQ problem directly, solve it three ways (serial scan,
parallel-in-time, dense oracle), check KKT residuals, and compute
θ-sensitivities."""

import jax
import jax.numpy as jnp

from aligator_tpu import gar
from aligator_tpu._pytree import replace
from aligator_tpu.gar import parallel

if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)

    N, nx, nu, nc = 23, 4, 2, 1
    mudyn, mueq = 1e-4, 1e-5
    prob = gar.random_problem(jax.random.PRNGKey(0), N, nx, nu, nc, dtype=jnp.float64)

    xs, us, vs, lams = gar.solve(prob, mudyn, mueq, assume_explicit=True)
    print("serial   KKT:", [f"{float(e):.2e}" for e in gar.kkt_error(prob, xs, us, vs, lams, mudyn, mueq)])

    xs_p, us_p, vs_p, lams_p = parallel.solve(prob, mudyn, mueq, legs=4, assume_explicit=True)
    print("parallel vs serial:", float(jnp.abs(xs_p - xs).max()))

    xs_d, us_d, _, _ = gar.dense_solve(prob, mudyn, mueq)
    print("dense vs serial:", float(jnp.abs(xs_d - xs).max()))

    # parametric sensitivity: θ enters the cost gradients via (Gx, Gu)
    nth = 3
    kn = gar.add_parameterization(prob.knots, nth)
    kn = replace(kn, Gx=0.1 * jnp.ones_like(kn.Gx))
    prob_th = replace(prob, knots=kn)
    facs = gar.backward(prob_th, mudyn, mueq, assume_explicit=True)
    print("th_grad:", facs.th_grad)
    print("th_hess symmetric:", bool(jnp.allclose(facs.th_hess, facs.th_hess.T, atol=1e-8)))
