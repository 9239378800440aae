"""Coronal spectra (counterpart of `gradus_tpu/corona/spectra.py`;
reference `src/corona/spectra.jl`)."""

from __future__ import annotations

import dataclasses

__all__ = ["PowerLawSpectrum"]


@dataclasses.dataclass(frozen=True)
class PowerLawSpectrum:
    """I(g) = g^(-Γ) (Gonzalez et al. 2017 convention; reference
    spectra.jl:10-25)."""

    gamma: float = 2.0

    def __call__(self, g):
        return g ** (-self.gamma)
