from ribca_tpu_torch.outputs.colors import (
    color_legend,
    get_colors,
    rgb_to_hex,
)
from ribca_tpu_torch.outputs.colorize import colorize_image, save_png
from ribca_tpu_torch.outputs.export import export_annotations_csv

__all__ = [
    "get_colors",
    "rgb_to_hex",
    "color_legend",
    "colorize_image",
    "save_png",
    "export_annotations_csv",
]
