from repro_torch.roofline.analysis import (  # noqa: F401
    H100,
    H100_F32,
    H100_TF32,
    HW,
    collective_bytes,
    roofline_terms,
)
