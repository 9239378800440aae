"""Helpers shared by the extended-corona parity tests (tests/test_torch_*.py):
a JAX profile's fields as numpy, a synthetic transfer grid and the two
packages' time-dependent lag transfer on it, and the JAX package's softmax
with its tangent masked where the weight is 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gradus_tpu.transfer.cunningham import TransferBranchGrid as JaxGrid
from gradus_tpu.transfer.integration import integrate_lagtransfer_timedep as jax_timedep

from gradus_tpu_torch.interop import transfer_grid_from_numpy
from gradus_tpu_torch.transfer.integration import integrate_lagtransfer_timedep


def np_fields(obj):
    """A JAX profile's fields as nested dicts of numpy arrays, as `interop`'s
    `*_from_numpy` functions take them."""
    if dataclasses.is_dataclass(obj):
        return {f.name: np_fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def synthetic_grid():
    """A transfer grid in the reference's layout: 8 radii in [2.5, 40],
    gmin/gmax bracketing 1 and widening inward, f of the √(g✶(1−g✶)) shape
    on both branches, arrival times growing with r and across g✶. (The
    integrator is what the tests compare; the JAX package's own transfer
    functions take ~100 s on the CPU.)"""
    radii = np.geomspace(2.5, 40.0, 8)
    gstar = np.linspace(0.0, 1.0, 16)
    w = 0.6 / np.sqrt(radii)
    gmin, gmax = 1.0 - 1.2 * w, 1.0 + 0.8 * w
    shape = np.sqrt(gstar * (1.0 - gstar))[None, :]
    lower_f = (1.0 + 0.3 * gstar[None, :]) * shape * (1.0 + 1.0 / radii[:, None])
    upper_f = (1.2 - 0.2 * gstar[None, :]) * shape * (1.0 + 0.5 / radii[:, None])
    lower_t = 1000.0 + radii[:, None] * (1.0 + 0.2 * gstar[None, :])
    upper_t = 1000.0 + radii[:, None] * (1.4 - 0.3 * gstar[None, :])
    return dict(radii=radii, gmin=gmin, gmax=gmax, gstar=gstar, lower_f=lower_f, upper_f=upper_f, lower_t=lower_t, upper_t=upper_t)


def timedep_both(jprof, prof):
    """The JAX package's and the port's `integrate_lagtransfer_timedep` of
    the same profile on `synthetic_grid`, 40 g and 100 t bins, t₀ = 1000,
    60 radii, 24 light-curve samples: (port's flux, JAX's flux, t bins)."""
    grid = synthetic_grid()
    bins, tbins = np.linspace(0.0, 1.5, 40), np.linspace(0.0, 150.0, 100)
    kw = dict(t0=1000.0, n_radii=60, n_time=24)
    want = np.asarray(
        jax_timedep(jprof, JaxGrid(**{k: jnp.asarray(v) for k, v in grid.items()}), jnp.asarray(bins), jnp.asarray(tbins), **kw)
    )
    got = integrate_lagtransfer_timedep(
        prof, transfer_grid_from_numpy(grid, device="cpu"), torch.as_tensor(bins), torch.as_tensor(tbins), **kw
    ).numpy()
    return got, want, tbins


def mean_lag(flux, tbins):
    psi = flux.sum(axis=0)
    return float((tbins * psi).sum() / psi.sum())


def masked_softmax():
    """`jax.nn.softmax` whose tangent is masked where the weight is 0: the
    port's arithmetic for `refine_for_target`'s softmin, where the JAX
    package's tangent is NaN past a ray's saved prefix (ROADMAP C)."""
    plain = jax.nn.softmax

    @jax.custom_jvp
    def softmax(x):
        return plain(x)

    @softmax.defjvp
    def _jvp(primals, tangents):
        (x,), (x_dot,) = primals, tangents
        w = plain(x)
        x_dot = jnp.where(w > 0, x_dot, 0.0)
        return w, w * (x_dot - jnp.sum(w * x_dot))

    return softmax
