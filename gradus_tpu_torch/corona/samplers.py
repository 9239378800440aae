"""Local-sky direction samplers and the tetrad boost to global velocities
(counterpart of `gradus_tpu/corona/samplers.py`).

Reference: `src/corona/samplers.jl`. A sampler maps index i of N to local
sky angles (θ, φ); `sky_angles_to_velocity` converts a local direction to a
global null velocity via the source's tetrad frame. The contractions are
elementwise products and sums, so no TF32 matmul can reach them.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.geodesics.tetrads import tetradframe_matrix
from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = [
    "LowerHemisphere",
    "BothHemispheres",
    "EvenSampler",
    "WeierstrassSampler",
    "sky_angles_to_velocity",
    "cart_to_spher_jacobian",
]

_GOLDEN = math.pi * (1 + math.sqrt(5.0))


class LowerHemisphere:
    pass


class BothHemispheres:
    pass


def _uniform_index(i, N, key):
    """The reference's `geti(RandomGenerator) = rand()·N`
    (corona-models.jl:137): uniform draws in [0, N) of ``i``'s shape, dtype
    and device, from the `torch.Generator` ``key`` (a generator seeded 0 on
    ``i``'s device when None)."""
    if key is None:
        key = torch.Generator(device=i.device).manual_seed(0)
    return torch.rand(i.shape, generator=key, dtype=i.dtype, device=i.device) * float(N)


class EvenSampler:
    """Even sampling of the sky (reference samplers.jl:8-15, 43-47).

    Generators (reference `GoldenSpiralGenerator`/`EvenGenerator`/
    `RandomGenerator`, samplers.jl:4-6, 27-36):

    - ``"golden"`` (default): golden-spiral, radial = π(1+√5)·i
    - ``"even"``: radial = 2π·i/N
    - ``"random"``: the index is replaced by a uniform draw in [0, N), from
      the `torch.Generator` ``key`` (where the JAX package takes a PRNG key;
      a generator seeded 0 when None). The draws differ from the JAX
      package's.
    """

    def __init__(self, domain=None, generator: str = "golden", key=None):
        self.domain = domain or LowerHemisphere()
        self.generator = generator
        self.key = key

    def sample_angles(self, i, N):
        i = torch.as_tensor(i)
        if self.generator == "random":
            i = _uniform_index(i, N, self.key)
        if self.generator == "golden":
            radial = _GOLDEN * i
        else:  # "even" and "random": radial 2π·i/N resp. 2π·i, as in the JAX package
            radial = 2 * math.pi * (i if self.generator == "random" else i / N)
        frac = i / N
        if isinstance(self.domain, LowerHemisphere):
            elev = torch.arccos(1.0 - frac)
        else:
            elev = torch.arccos(1.0 - 2.0 * frac)
        return elev, torch.remainder(radial, 2 * math.pi)


class WeierstrassSampler:
    """Radius-biased sampling concentrating rays toward the poles
    (reference samplers.jl:16-25, 48-56). ``generator="random"`` replaces the
    index with a uniform draw in [0, N) from the `torch.Generator` ``key``
    (reference `RandomGenerator`)."""

    def __init__(self, res: float = 100.0, domain=None, generator: str = "golden", key=None):
        self.resolution = res
        self.domain = domain or LowerHemisphere()
        self.generator = generator
        self.key = key

    def sample_angles(self, i, N):
        i = torch.as_tensor(i)
        if self.generator == "random":
            i = _uniform_index(i, N, self.key)
        radial = _GOLDEN * i
        phi = 2.0 * torch.arctan(torch.sqrt(self.resolution / i))
        if isinstance(self.domain, BothHemispheres):
            phi = torch.where(torch.remainder(i, 2) == 0, phi, math.pi - phi)
        return phi, torch.remainder(radial, 2 * math.pi)


def cart_to_spher_jacobian(theta, phi):
    """(reference `_cart_to_spher_jacobian`, samplers.jl:59-65)."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    z = torch.zeros_like(theta)
    return torch.stack(
        [
            torch.stack([st * cp, st * sp, ct], dim=-1),
            torch.stack([ct * cp, ct * sp, -st], dim=-1),
            torch.stack([-sp, cp, z], dim=-1),
        ],
        dim=-2,
    )


def sky_angles_to_velocity(m: AbstractMetric, x, v_source, theta, phi, E0=1.0):
    """Local sky (θ, φ) → global velocity: cartesian direction → spherical
    direction at x → boost through the source tetrad
    (reference `sky_angles_to_velocity`, samplers.jl:78-97).

    ``theta``/``phi`` may be batched; ``x``, ``v_source`` are single
    4-vectors."""
    theta = torch.as_tensor(theta, dtype=x.dtype, device=x.device)
    phi = torch.as_tensor(phi, dtype=x.dtype, device=x.device).expand(theta.shape)
    # -1 for consistency with the LowerHemisphere convention
    hat = -torch.stack(
        [torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi), torch.cos(theta)],
        dim=-1,
    )
    J = cart_to_spher_jacobian(x[2], x[3])
    k = (J * hat[..., None, :]).sum(-1)
    p = torch.cat([torch.full(theta.shape + (1,), E0, dtype=k.dtype, device=k.device), E0 * k], dim=-1)
    B = tetradframe_matrix(m, x, v_source)
    return (B * p[..., None, :]).sum(-1)
