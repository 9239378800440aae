from gradus_tpu_torch.geometry.discs import AbstractAccretionGeometry, DatumPlane, ThinDisc
