from gradus_tpu_torch.corona.samplers import (
    LowerHemisphere,
    BothHemispheres,
    EvenSampler,
    WeierstrassSampler,
    sky_angles_to_velocity,
)
from gradus_tpu_torch.corona.spectra import PowerLawSpectrum
from gradus_tpu_torch.corona.models import (
    LampPostModel,
    BeamedPointSource,
    RingCorona,
    DiscCorona,
)
from gradus_tpu_torch.corona.profiles import RadialDiscProfile, AnalyticRadialDiscProfile
from gradus_tpu_torch.corona.emissivity import (
    proper_area,
    energy_ratio,
    lorentz_factor,
    local_velocity,
    emissivity_profile,
    tracecorona,
    point_source_emissivity_profile,
)
from gradus_tpu_torch.corona.extended import (
    TimeDependentRadialDiscProfile,
    RingCoronaProfile,
    DiscCoronaProfile,
    ring_corona_profile,
    ring_corona_profile_hybrid,
    NearFieldBlendedProfile,
    disc_corona_profile,
    co_rotating_velocity,
    stationary_velocity,
    default_beta_angles,
)
