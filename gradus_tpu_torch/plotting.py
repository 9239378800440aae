"""Plotting and path-extraction helpers (counterpart of
`gradus_tpu/plotting.py`).

The reference ships Plots.jl recipes (`src/plotting-recipes.jl`: 3D/polar
geodesic paths, event-horizon shading). Here the same artefacts are produced
as numpy arrays on the host (a tensor argument is copied there), with
optional matplotlib rendering when available.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a):
    """``a`` as a numpy array on the host."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _spherical_to_cartesian(x):
    """(..., 4) or (..., 3) spherical positions → (..., 3) cartesian
    (`utils/linalg.py::spherical_to_cartesian`, in numpy)."""
    if x.shape[-1] == 4:
        x = x[..., 1:]
    r, th, ph = x[..., 0], x[..., 1], x[..., 2]
    sth = np.sin(th)
    return np.stack([r * np.cos(ph) * sth, r * np.sin(ph) * sth, r * np.cos(th)], axis=-1)

__all__ = [
    "paths_to_cartesian",
    "event_horizon_outline",
    "extract_path",
    "plot_paths",
    "plot_paths_3d",
    "plot_image",
    "horizon_surface",
    "horizon_circle",
    "plot_horizon_3d",
    "plot_emissivity",
    "emissivity_index",
    "plot_transfer_branches",
]


def paths_to_cartesian(traj, traj_lam, n_steps):
    """(N, n_save, S) trajectories → list of (n_i, 3) cartesian paths."""
    traj = _np(traj)
    n_steps = np.atleast_1d(_np(n_steps))
    if traj.ndim == 2:
        traj = traj[None]
    out = []
    for i in range(traj.shape[0]):
        n = int(n_steps[i])
        out.append(_spherical_to_cartesian(traj[i, :n, 0:4]))
    return out


def event_horizon_outline(m, resolution: int = 180):
    """(x, z) outline of the event horizon for poloidal plots
    (reference plotting-recipes.jl horizon shading)."""
    from gradus_tpu_torch.orbits.special_radii import event_horizon

    rs, thetas = event_horizon(m, resolution=resolution)
    rs = _np(rs)
    thetas = _np(thetas)
    return rs * np.sin(thetas), rs * np.cos(thetas)


def plot_paths(m, traj, traj_lam, n_steps, ax=None, plane: str = "xy"):
    """Plot geodesic paths (projected) with the horizon disc; requires
    matplotlib. Returns the axis."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    paths = paths_to_cartesian(traj, traj_lam, n_steps)
    ij = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}[plane]
    for p in paths:
        ax.plot(p[:, ij[0]], p[:, ij[1]], lw=0.8)
    rh = float(_np(m.inner_radius()))
    circle = plt.Circle((0, 0), rh, color="k")
    ax.add_patch(circle)
    ax.set_aspect("equal")
    return ax


def plot_image(alphas, betas, img, ax=None, **kwargs):
    """Render an (α, β) image (redshift / shadow); requires matplotlib."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    im = ax.pcolormesh(_np(alphas), _np(betas), _np(img), **kwargs)
    ax.set_xlabel(r"$\alpha$")
    ax.set_ylabel(r"$\beta$")
    ax.set_aspect("equal")
    return ax, im


def extract_path(traj, lam, n_steps, status=None, n_points: int = 400,
                 t_span: float = 100.0, projection: str = "none"):
    """Resample one dense trajectory around its interesting window
    (reference `_extract_path`, plotting-recipes.jl:3-30): terminated rays
    are windowed at their endpoint, escaping rays at mid-flight; the window
    spans ±t_span in affine parameter, resampled to n_points.

    traj: (n_save, S), lam: (n_save,), n_steps: int. Returns (x, y, z)
    cartesian or (r, θ, φ) if projection == "polar"."""
    from gradus_tpu_torch.integrate.status import StatusCodes

    traj = _np(traj)
    lam = _np(lam)
    n = int(n_steps)
    lam_v = lam[:n]
    terminated = status is not None and int(status) in (
        int(StatusCodes.IntersectedWithGeometry),
        int(StatusCodes.WithinInnerBoundary),
    )
    mid = n - 1 if terminated else max(0, n // 2)
    t0 = max(lam_v[mid] - t_span, lam_v[0])
    t1 = min(lam_v[mid] + t_span, lam_v[n - 1])
    ts = np.linspace(t0, t1, n_points)
    r = np.interp(ts, lam_v, traj[:n, 1])
    th = np.interp(ts, lam_v, traj[:n, 2])
    ph = np.interp(ts, lam_v, traj[:n, 3])
    if projection == "polar":
        return r, th, ph
    x = r * np.cos(ph) * np.sin(th)
    y = r * np.sin(ph) * np.sin(th)
    z = r * np.cos(th)
    return x, y, z


def plot_paths_3d(m, traj, traj_lam, n_steps, status=None, ax=None,
                  extent: float = 20.0, n_points: int = 400,
                  t_span: float = 100.0):
    """3D geodesic paths + horizon sphere (reference Plot_Paths_3D recipe,
    plotting-recipes.jl:32-52). Requires matplotlib."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    traj = _np(traj)
    if traj.ndim == 2:
        traj = traj[None]
    n_steps = np.atleast_1d(_np(n_steps))
    status = None if status is None else np.atleast_1d(_np(status))
    for i in range(traj.shape[0]):
        st = None if status is None else status[i]
        x, y, z = extract_path(
            traj[i], _np(traj_lam)[i] if _np(traj_lam).ndim > 1 else traj_lam,
            n_steps[i], st, n_points=n_points, t_span=t_span,
        )
        ax.plot(x, y, z, lw=0.8)
    plot_horizon_3d(m, ax=ax)
    ax.set_xlim(-extent, extent)
    ax.set_ylim(-extent, extent)
    ax.set_zlim(-extent, extent)
    return ax


def horizon_surface(m, n_points: int = 32):
    """(x, y, z) meshgrid arrays of the inner-radius sphere (reference
    Plot_Horizon_3D, plotting-recipes.jl:103-117)."""
    R = float(_np(m.inner_radius()))
    u = np.linspace(0.0, 2 * np.pi, n_points)
    v = np.linspace(0.0, np.pi, n_points)
    x = R * np.outer(np.cos(u), np.sin(v))
    y = R * np.outer(np.sin(u), np.sin(v))
    z = R * np.outer(np.ones_like(u), np.cos(v))
    return x, y, z


def plot_horizon_3d(m, ax=None, n_points: int = 32, **kwargs):
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    x, y, z = horizon_surface(m, n_points)
    kwargs.setdefault("color", "k")
    ax.plot_surface(x, y, z, **kwargs)
    return ax


def horizon_circle(m, n_points: int = 100, projection: str = "none"):
    """Equatorial horizon outline (reference Plot_Horizon,
    plotting-recipes.jl:119-134): (φ, r) if polar, else (x, y)."""
    R = float(_np(m.inner_radius()))
    phi = np.linspace(0.0, 2 * np.pi, n_points)
    r = np.full_like(phi, R)
    if projection == "polar":
        return phi, r
    return r * np.cos(phi), r * np.sin(phi)


def plot_emissivity(profile, ax=None, normalize=None):
    """log-log ε(r) (reference RadialDiscProfile recipe,
    plotting-recipes.jl:145-157)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    r = _np(profile.radii)[1:-1]
    eps = _np(profile.emissivity)[1:-1]
    if normalize is not None:
        eps = normalize(eps)
    ax.loglog(r, eps)
    ax.set_xlabel(r"r ($r_g$)")
    ax.set_ylabel(r"$\varepsilon$ (arb.)")
    return ax


def emissivity_index(profile):
    """(r, α) with ε ∝ r^(−α) via the local log-slope (reference
    Plot_Emissivity_Index, plotting-recipes.jl:159-188)."""
    r = _np(profile.radii)
    eps = _np(profile.emissivity)
    dydx = np.diff(eps) / np.diff(r)
    rm, em = r[1:], eps[1:]
    idx = dydx * rm / em
    return rm[:-1], -idx[:-1]


def plot_transfer_branches(grid, index: int, ax=None, h: float = 1e-4):
    """f(g✶) for one radius of a TransferBranchGrid (reference
    CunninghamTransferData recipe, plotting-recipes.jl:152-157)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    gs = _np(grid.gstar)
    mask = (gs > h) & (gs < 1 - h)
    ax.plot(gs[mask], _np(grid.upper_f[index])[mask], label="upper")
    ax.plot(gs[mask], _np(grid.lower_f[index])[mask], label="lower")
    ax.set_xlabel(r"$g^\ast$")
    ax.set_ylabel("f")
    ax.legend()
    return ax
