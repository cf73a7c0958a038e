"""Headless RGB rasterizer for situations (replaces the PyQt5 renderer).

Draws the same scene the reference renders (gym_minigrid/rendering.py +
minigrid.py:304-378,705-760): white background, grey grid lines, size-scaled
colored shapes, the agent as a pink triangle pointing in its heading, and
optional attention shading of cells. Rasterized with numpy alone, and written
as PNG (``zlib``) and animated GIF (an LZW encoder of its own), so that
rendering needs neither a display server nor an imaging library.

The geometry and palette are the JAX package's (``analysis/render.py``, which
draws with PIL). Grid lines, shading and squares land on the same pixels by
construction. Circles and polygons (the cylinder, the agent) follow the
scan rules of PIL's filled ellipse and polygon as far as they were read off
its output, so pixels on their rims could differ;
``tests/test_torch_engine_parity.py`` measures the share that does.
"""

import functools
import math
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

from multimodal_seq2seq_gscan_tpu_torch.gscan.types import (
    DIR_TO_INT, Situation)

CELL_PIXELS = 60

# Rendering palette (same RGB constants the reference renderer uses).
COLORS = {
    "red": (128, 0, 0),
    "green": (46, 139, 87),
    "blue": (25, 25, 112),
    "purple": (112, 39, 195),
    "yellow": (255, 191, 0),
    "grey": (100, 100, 100),
    "pink": (255, 192, 203),
}

AGENT_COLOR = (255, 192, 203)
GRID_LINE_COLOR = (100, 100, 100)


# Pixel coordinates here are never negative.
def _round_half_up(value: float) -> int:
    return math.floor(value + 0.5)


def _round_half_down(value: float) -> int:
    return math.ceil(value - 0.5)


def _polygon_mask(points: Sequence[tuple]):
    """(x offset, y offset, boolean mask) of a filled polygon: the vertices
    are truncated to whole pixels, then each row from the top vertex to the
    bottom one is filled between pairs of edge crossings (computed in
    float32), from the left crossing rounded half up to the right one
    rounded half down. A crossing at the lower end of an edge counts twice
    above the last row, and horizontal edges are filled whole."""
    vertices = [(int(x), int(y)) for x, y in points]
    xs = [x for x, _ in vertices]
    ys = [y for _, y in vertices]
    x_min, y_min, y_max = min(xs), min(ys), max(ys)
    mask = np.zeros((y_max - y_min + 1, max(xs) - x_min + 1), dtype=bool)
    edges = []
    for (xa, ya), (xb, yb) in zip(vertices, vertices[1:] + vertices[:1]):
        if ya == yb:
            mask[ya - y_min, min(xa, xb) - x_min:max(xa, xb) - x_min + 1] = True
            continue
        edges.append((min(ya, yb), max(ya, yb), np.float32(xa), ya,
                      np.float32(xb - xa) / np.float32(yb - ya)))
    for y in range(y_min, y_max + 1):
        crossings = []
        for low, high, x0, y0, dx in edges:
            if low <= y <= high:
                crossings.append(float(np.float32(y - y0) * dx + x0))
                if y == high and y < y_max:
                    crossings.append(crossings[-1])
        crossings.sort()
        for left, right in zip(crossings[::2], crossings[1::2]):
            start, end = _round_half_up(left), _round_half_down(right)
            if end >= start:
                mask[y - y_min, start - x_min:end - x_min + 1] = True
    return x_min, y_min, mask


def _disc_mask(diameter: int) -> np.ndarray:
    """The filled circle over a (diameter + 1)-pixel square box. Its rows
    come from a walk of the quarter arc in doubled coordinates (x, y from
    the centre, even steps): from (d, 0), each step goes to whichever of
    (x, y + 2), (x - 2, y + 2), (x - 2, y) lies closest to the curve
    x^2 + y^2 = d^2, preferring them in that order on ties, until (0, d);
    a row's half-width is the largest x the walk visits on it."""
    d = diameter
    half_widths = {}
    x, y = d, 0

    def miss(px, py):
        return abs(py * py + px * px - d * d)

    while True:
        half_widths.setdefault(y, x)
        if (x, y) == (0, d):
            break
        nx, ny = x, y + 2
        if x > 1:
            for cx, cy in ((x - 2, y + 2), (x - 2, y)):
                if miss(nx, ny) > miss(cx, cy):
                    nx, ny = cx, cy
        x, y = nx, ny
    mask = np.zeros((d + 1, d + 1), dtype=bool)
    for y, x in half_widths.items():
        for row in {(d + y) // 2, (d - y) // 2}:
            mask[row, (d - x) // 2:(d + x) // 2 + 1] = True
    return mask


@functools.lru_cache(maxsize=None)
def _shape_mask(shape: str, size: int):
    """(x offset, y offset, mask) of an object drawn in the cell at (0, 0);
    the same pixels shifted by whole cells for any other cell."""
    scale = size / 4.0
    if shape == "square":
        side = _round_half_up(CELL_PIXELS * scale)
        return 0, 0, np.ones((side + 1, side + 1), dtype=bool)
    if shape == "circle":
        radius = (CELL_PIXELS // 10) * size
        center = CELL_PIXELS // 2
        return center - radius, center - radius, _disc_mask(2 * radius)
    if shape == "cylinder":
        half_width = (CELL_PIXELS / 2) * scale
        height = CELL_PIXELS * scale
        mid = CELL_PIXELS / 2
        return _polygon_mask([(mid, 0), (mid + half_width, 0),
                              (mid, height), (mid - half_width, height)])
    raise ValueError("Unknown shape to render: {}".format(shape))


@functools.lru_cache(maxsize=None)
def _agent_mask(col: int, row: int, direction: int):
    """(x, y, mask) of the agent in its cell, in image pixels. Made for each
    cell: the rotated vertices' last bits, and so their truncation, depend
    on the cell's centre."""
    cx = CELL_PIXELS * (col + 0.5)
    cy = CELL_PIXELS * (row + 0.5)
    angle = math.radians(direction * 90)
    cos_a, sin_a = math.cos(angle), math.sin(angle)
    base = [(-12, 10), (12, 0), (-12, -10)]
    return _polygon_mask([(cx + x * cos_a - y * sin_a,
                           cy + x * sin_a + y * cos_a) for x, y in base])


def _stamp(image: np.ndarray, mask_spec, col: int, row: int, rgb):
    """Paint ``mask_spec``'s (x, y, mask), shifted by whole cells."""
    x_off, y_off, mask = mask_spec
    x0 = col * CELL_PIXELS + x_off
    y0 = row * CELL_PIXELS + y_off
    height, width = image.shape[:2]
    x1 = min(x0 + mask.shape[1], width)
    y1 = min(y0 + mask.shape[0], height)
    window = image[y0:y1, x0:x1]
    window[mask[:y1 - y0, :x1 - x0]] = rgb


def render_situation(situation: Situation,
                     attention_weights: Optional[Sequence[float]] = None
                     ) -> np.ndarray:
    """Render a situation to an RGB uint8 array [grid*60, grid*60, 3]."""
    grid = situation.grid_size
    size_px = grid * CELL_PIXELS
    image = np.full((size_px, size_px, 3), 255, dtype=np.uint8)

    # Attention shading: darker cell = higher weight.
    if attention_weights is not None and len(attention_weights) > 0:
        weights = np.asarray(attention_weights, dtype=np.float32).reshape(
            grid, grid)
        shade = np.array([[int(150 * (1 - float(weights[r, c])))
                           for c in range(grid)] for r in range(grid)])
        cells = np.repeat(np.repeat(shade, CELL_PIXELS, axis=0),
                          CELL_PIXELS, axis=1)
        image[...] = np.clip(cells, 0, 255)[..., None].astype(np.uint8)

    image[::CELL_PIXELS, :] = GRID_LINE_COLOR
    image[:, ::CELL_PIXELS] = GRID_LINE_COLOR

    for positioned_object in situation.placed_objects:
        _stamp(image, _shape_mask(positioned_object.object.shape,
                                  int(positioned_object.object.size)),
               positioned_object.position.column,
               positioned_object.position.row,
               COLORS.get(positioned_object.object.color, COLORS["grey"]))

    _stamp(image, _agent_mask(situation.agent_pos.column,
                              situation.agent_pos.row,
                              DIR_TO_INT[situation.agent_direction]),
           0, 0, AGENT_COLOR)
    return image


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(array: np.ndarray) -> bytes:
    """An RGB uint8 [H, W, 3] array as PNG bytes (8-bit truecolour, filter
    type 0 on every row)."""
    array = np.ascontiguousarray(array, dtype=np.uint8)
    height, width, channels = array.shape
    if channels != 3:
        raise ValueError("encode_png takes RGB arrays, got {} channels".format(
            channels))
    rows = np.concatenate([np.zeros((height, 1), dtype=np.uint8),
                           array.reshape(height, width * 3)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_png(array: np.ndarray, path: str) -> str:
    with open(path, "wb") as outfile:
        outfile.write(encode_png(array))
    return path


def save_situation_png(situation: Situation, path: str,
                       attention_weights: Optional[Sequence[float]] = None
                       ) -> str:
    return save_png(render_situation(situation, attention_weights), path)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

_MAX_CODE = 4096


def _lzw(runs: List[tuple], min_code_size: int) -> bytes:
    """GIF's variable-width LZW of a pixel stream given as (index, length)
    runs. Codes are emitted as in the classic ``compress`` encoder (width
    grows once the next free code passes the largest code of the current
    width; a clear code when the table is full). Inside a run the greedy
    match walks the table's chain of same-colour strings in one step,
    which gives the codes a pixel-by-pixel walk would."""
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    state = {"acc": 0, "bits": 0, "width": min_code_size + 1,
             "next": end + 1}
    table = {}
    runs_of = {}    # colour -> codes of its strings c, cc, ccc, ...
    pure = {}       # code of a same-colour string -> (colour, length)

    def emit(code):
        state["acc"] |= code << state["bits"]
        state["bits"] += state["width"]
        while state["bits"] >= 8:
            out.append(state["acc"] & 0xFF)
            state["acc"] >>= 8
            state["bits"] -= 8
        if state["next"] > (1 << state["width"]) - 1 and \
                state["width"] < 12:
            state["width"] += 1

    def reset():
        table.clear()
        runs_of.clear()
        pure.clear()
        for colour in range(clear):
            runs_of[colour] = [colour]
            pure[colour] = (colour, 1)

    def add(prefix, colour, same_colour_length):
        """Enter prefix+colour; a clear code instead when full."""
        if state["next"] < _MAX_CODE:
            code = state["next"]
            table[(prefix << 8) | colour] = code
            if same_colour_length:
                runs_of[colour].append(code)
                pure[code] = (colour, same_colour_length)
            state["next"] += 1
        else:
            emit(clear)
            state["width"] = min_code_size + 1
            state["next"] = end + 1
            reset()

    reset()
    emit(clear)
    w = None
    for colour, length in runs:
        i = 0
        while i < length:
            if w is None:
                w = colour
                i += 1
                continue
            run = pure.get(w)
            if run is not None and run[0] == colour:
                chain = runs_of[colour]
                reach = min(len(chain), run[1] + length - i)
                i += reach - run[1]
                w = chain[reach - 1]
                if i < length:
                    emit(w)
                    add(w, colour, reach + 1)
                    w = colour
                    i += 1
                continue
            code = table.get((w << 8) | colour)
            if code is not None:
                w = code
            else:
                emit(w)
                add(w, colour, 0)
                w = colour
            i += 1
    emit(w)
    emit(end)
    if state["bits"]:
        out.append(state["acc"] & 0xFF)
    blocks = bytearray([min_code_size])
    for start in range(0, len(out), 255):
        chunk = out[start:start + 255]
        blocks.append(len(chunk))
        blocks += chunk
    blocks.append(0)
    return bytes(blocks)


def encode_gif(frames: List[np.ndarray], duration_ms: int = 200) -> bytes:
    """RGB uint8 frames as an animated, looping GIF89a over one exact
    palette of the frames' colours (at most 256 of them)."""
    frames = [np.ascontiguousarray(frame, dtype=np.uint8) for frame in frames]
    height, width = frames[0].shape[:2]
    packed = [(frame[..., 0].astype(np.uint32) << 16)
              | (frame[..., 1].astype(np.uint32) << 8) | frame[..., 2]
              for frame in frames]
    palette = np.unique(np.concatenate([p.ravel() for p in packed]))
    if len(palette) > 256:
        raise ValueError("a GIF holds at most 256 colours; the frames have "
                         "{}".format(len(palette)))
    bits = max(1, int(len(palette) - 1).bit_length())
    table = np.zeros(3 << bits, dtype=np.uint8)
    table[0:3 * len(palette):3] = palette >> 16
    table[1:3 * len(palette):3] = (palette >> 8) & 0xFF
    table[2:3 * len(palette):3] = palette & 0xFF
    min_code_size = max(2, bits)
    delay = int(round(duration_ms / 10))
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", width, height, 0xF0 | (bits - 1), 0, 0)
    out += table.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for p in packed:
        if p.shape != (height, width):
            raise ValueError("GIF frames differ in size")
        flat = np.searchsorted(palette, p.ravel())
        starts = np.concatenate([[0], np.flatnonzero(flat[1:] != flat[:-1])
                                 + 1])
        lengths = np.diff(np.concatenate([starts, [flat.size]]))
        runs = list(zip(flat[starts].tolist(), lengths.tolist()))
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, width, height, 0)
        out += _lzw(runs, min_code_size)
    out += b"\x3b"
    return bytes(out)


def save_gif(frames: List[np.ndarray], path: str, fps: int = 5) -> str:
    with open(path, "wb") as outfile:
        outfile.write(encode_gif(frames, duration_ms=int(1000 / fps)))
    return path
