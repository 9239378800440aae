"""Image planes: polar and cartesian pixelizations of the (α, β) plane
(counterpart of `gradus_tpu/camera/planes.py`). Arrays come out in the
plane's ``dtype`` on its ``device``."""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.camera.grids import LinearGrid, _const_linspace

__all__ = ["PolarPlane", "CartesianPlane"]


class PolarPlane:
    def __init__(
        self,
        grid=None,
        Nr: int = 400,
        Ntheta: int = 100,
        r_min: float = 1.0,
        r_max: float = 250.0,
        theta_min: float = 0.0,
        theta_max: float = 2 * math.pi,
        *,
        dtype=torch.float64,
        device=None,
    ):
        self.grid = grid or LinearGrid()
        self.Nr = Nr
        self.Ntheta = Ntheta
        self.r_min = r_min
        self.r_max = r_max
        self.theta_min = theta_min
        self.theta_max = theta_max
        self.dtype = dtype
        self.device = device

    def trajectory_count(self):
        return self.Nr * self.Ntheta

    def _radii(self):
        return self.grid(self.r_min, self.r_max, self.Nr, dtype=self.dtype, device=self.device)

    def impact_parameters(self):
        """(α, β) flattened, r-major (reference `image_plane`,
        planes.jl:100-110)."""
        rs = self._radii()
        dtheta = (self.theta_max - self.theta_min) / self.Ntheta
        thetas = _const_linspace(self.theta_min, self.theta_max - dtheta, self.Ntheta, rs)
        alpha = rs[:, None] * torch.cos(thetas)[None, :]
        beta = rs[:, None] * torch.sin(thetas)[None, :]
        return alpha.reshape(-1), beta.reshape(-1)

    def unnormalized_areas(self):
        A = self._radii() ** 2
        return A[:, None].expand(self.Nr, self.Ntheta).reshape(-1)


class CartesianPlane:
    def __init__(
        self,
        Nx: int = 150,
        Ny: int = 150,
        x_min: float = -10.0,
        x_max: float = 10.0,
        y_min: float = -10.0,
        y_max: float = 10.0,
        *,
        dtype=torch.float64,
        device=None,
    ):
        self.Nx = Nx
        self.Ny = Ny
        self.x_min, self.x_max = x_min, x_max
        self.y_min, self.y_max = y_min, y_max
        self.dtype = dtype
        self.device = device

    def trajectory_count(self):
        return self.Nx * self.Ny

    def impact_parameters(self):
        grid = LinearGrid()
        xs = grid(self.x_min, self.x_max, self.Nx, dtype=self.dtype, device=self.device)
        ys = grid(self.y_min, self.y_max, self.Ny, dtype=self.dtype, device=self.device)
        alpha = xs[:, None].expand(self.Nx, self.Ny)
        beta = ys[None, :].expand(self.Nx, self.Ny)
        return alpha.reshape(-1), beta.reshape(-1)

    def unnormalized_areas(self):
        return torch.ones(self.Nx * self.Ny, dtype=self.dtype, device=self.device)
