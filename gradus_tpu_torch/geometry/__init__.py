from gradus_tpu_torch.geometry.meshes import MeshAccretionGeometry, jsf_segment_triangle
from gradus_tpu_torch.geometry.discs import (
    AbstractAccretionGeometry,
    AbstractThickAccretionDisc,
    ThinDisc,
    WarpedThinDisc,
    DatumPlane,
    ThickDisc,
    ShakuraSunyaev,
    EllipticalDisc,
    PrecessingDisc,
    PolishDoughnut,
    PolishDoughnutFW,
    polish_doughnut_fw,
    CompositeGeometry,
    datumplane,
)
from gradus_tpu_torch.geometry.polygons import (
    in_polygon,
    orientation,
    polygon_area,
    polygon_barycenter,
)
