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
