from ribca_tpu_torch.io.tiff import read_image, read_mask, write_tiff  # noqa: F401
from ribca_tpu_torch.io.metadata import (  # noqa: F401
    extract_markers,
    extract_markers_ome,
    extract_markers_qptiff,
    write_marker_txt,
)
from ribca_tpu_torch.io.manifest import read_manifest, write_manifest  # noqa: F401
