"""Color palettes for the probability PNGs.

Counterpart of robosat_tpu/colors.py, limited to what `predict` uses: the
named colors and the continuous palette, byte for byte those of the
reference robosat (robosat/colors.py:19-95), so the palette PNGs are
interchangeable with both packages'.
"""

import colorsys

# Mapbox-themed named colors (https://www.mapbox.com/base/styling/color/).
NAMED_COLORS = {
    "dark": (0x40, 0x40, 0x40),
    "gray": (0xEE, 0xEE, 0xEE),
    "light": (0xF8, 0xF8, 0xF8),
    "white": (0xFF, 0xFF, 0xFF),
    "cyan": (0x3B, 0xB2, 0xD0),
    "blue": (0x38, 0x87, 0xBE),
    "bluedark": (0x22, 0x3B, 0x53),
    "denim": (0x50, 0x66, 0x7F),
    "navy": (0x28, 0x35, 0x3D),
    "navydark": (0x22, 0x2B, 0x30),
    "purple": (0x8A, 0x8A, 0xCB),
    "teal": (0x41, 0xAF, 0xA5),
    "green": (0x56, 0xB8, 0x81),
    "yellow": (0xF1, 0xF0, 0x75),
    "mustard": (0xFB, 0xB0, 0x3B),
    "orange": (0xF9, 0x88, 0x6C),
    "red": (0xE5, 0x5E, 0x5E),
    "pink": (0xED, 0x64, 0x98),
}


def continuous_palette_for_color(color, bins=256):
    """Continuous palette ramping a named color's HSV saturation over `bins`.

    Bin i gets saturation (i+1)/bins at the color's hue/value; used for the
    quantized probability PNGs. Parity: robosat/colors.py:70-95.
    """
    r, g, b = (v / 255 for v in NAMED_COLORS[color])
    h, _, v = colorsys.rgb_to_hsv(r, g, b)

    palette = []
    for i in range(bins):
        saturation = (i + 1) / bins
        palette.extend(int(c * 255) for c in colorsys.hsv_to_rgb(h, saturation, v))

    assert len(palette) // 3 == bins
    return palette
