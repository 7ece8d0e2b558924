"""Distinct-color generation and legends.

Color assignments feed every map/legend/pie, so the sequence must equal the
reference's (utils.py:33-108): 19 fixed standard colors, then golden-ratio
HSV colors cycling saturation/value in {0.7,0.8,0.9,1.0}, silver-gray
(192,192,192) always appended last for "Others".

The port renders without matplotlib: the confidence colormap is
matplotlib's 256-entry viridis table, stored here as the uint8 values
``(viridis(i / 256)[:3] * 255).astype(uint8)`` that ribca_tpu's
matplotlib path produces, and the legend is drawn with PIL.
"""

from __future__ import annotations

import colorsys
import os

import numpy as np

STANDARD_COLORS: tuple[tuple[int, int, int], ...] = (
    (255, 0, 0), (0, 0, 255), (0, 128, 0), (255, 255, 0), (255, 0, 255),
    (0, 255, 255), (255, 165, 0), (128, 0, 128), (0, 128, 128),
    (128, 0, 0), (0, 0, 128), (128, 128, 0), (255, 192, 203),
    (165, 42, 42), (0, 255, 0), (135, 206, 235), (75, 0, 130),
    (255, 215, 0), (192, 192, 192),
)
GRAY = (192, 192, 192)
_GOLDEN = 0.618033988749895
_SATS = (0.7, 0.8, 0.9, 1.0)
_VALS = (0.7, 0.8, 0.9, 1.0)


def get_colors(n: int) -> list[tuple[int, int, int]]:
    """n visually distinct colors; the last is always gray (utils.py:33-108)."""
    n = n - 1
    if n <= len(STANDARD_COLORS):
        return list(STANDARD_COLORS[:n]) + [GRAY]
    colors = list(STANDARD_COLORS)
    h = 0.1
    while len(colors) < n:
        h = (h + _GOLDEN) % 1.0
        s = _SATS[len(colors) % len(_SATS)]
        v = _VALS[len(colors) % len(_VALS)]
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    colors.append(GRAY)
    return colors


def rgb_to_hex(rgb) -> str:
    return "#{:02x}{:02x}{:02x}".format(rgb[0], rgb[1], rgb[2])


# viridis, 256 entries of (r, g, b) uint8, row-major
_VIRIDIS_HEX = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"
)
_VIRIDIS = np.frombuffer(bytes.fromhex("".join(_VIRIDIS_HEX)),
                         np.uint8).reshape(256, 3)


def viridis_lut(values: np.ndarray, reject_gray=GRAY) -> np.ndarray:
    """Per-cell confidences (N,) -> (N, 3) uint8 viridis colors, as
    matplotlib's ``get_cmap("viridis")`` indexes its table: entry
    min(int(v * 256), 255) of v clipped to [0, 1], black for NaN; values
    <= 0 map to gray (model.py:832 rejected-cell rule)."""
    values = np.asarray(values, dtype=np.float64)
    vals = np.clip(values, 0.0, 1.0)
    nan = np.isnan(vals)
    idx = np.minimum((np.where(nan, 0.0, vals) * 256).astype(np.int64), 255)
    rgb = _VIRIDIS[idx].copy()
    rgb[nan] = 0
    rgb[values <= 0] = reject_gray
    return rgb


def color_legend(main_dir: str, colors: dict, cell: bool = True) -> str:
    """6-column legend grid PNG (utils.py:111-140): ``colors`` maps label ->
    hex; luminance picks black/white text; filename depends on ``cell``.
    Drawn with PIL, so the layout matches the reference's grid but not its
    matplotlib pixels."""
    from PIL import Image, ImageDraw, ImageFont

    cell_w, cell_h = 250, 40
    num_cols = 6
    num_rows = max((len(colors) + num_cols - 1) // num_cols, 1)
    img = Image.new("RGB", (num_cols * cell_w, num_rows * cell_h), "white")
    draw = ImageDraw.Draw(img)
    font = ImageFont.load_default()
    for i, name in enumerate(colors):
        row, col = divmod(i, num_cols)
        hexcolor = colors[name]
        rgb = tuple(int(hexcolor[k:k + 2], 16) for k in (1, 3, 5))
        box = (col * cell_w, row * cell_h,
               (col + 1) * cell_w - 1, (row + 1) * cell_h - 1)
        draw.rectangle(box, fill=rgb)
        lum = (0.299 * rgb[0] + 0.587 * rgb[1] + 0.114 * rgb[2]) / 255
        draw.text(
            ((box[0] + box[2]) / 2, (box[1] + box[3]) / 2), str(name),
            fill="black" if lum > 0.5 else "white", font=font, anchor="mm",
        )
    name = "cell_color_legend.png" if cell else "tissue_region_color_legend.png"
    path = os.path.join(main_dir, name)
    img.save(path)
    return path
