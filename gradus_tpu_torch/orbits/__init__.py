from gradus_tpu_torch.orbits.special_radii import isco
