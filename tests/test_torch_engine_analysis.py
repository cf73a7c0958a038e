"""The port's analysis tools without JAX, matplotlib or PIL: the .xls
writer (``analysis/workbook.py``), case for case the JAX package's
tests/test_workbook.py and tests/test_biff8_independent.py (read back
through ``tests/biff8_reader.py``, standard library only); the renderer,
as in tests/test_utils.py; and the writers the port adds in place of PIL
and matplotlib: PNG and GIF round-trip exactly, and the SVG bar plots are
well-formed XML holding the bars' values. Imports nothing of JAX, so that
the engine's ``--mode=test`` runs it where JAX is not installed.
"""

import io
import os
import struct
import sys
import xml.etree.ElementTree as ElementTree
import zlib

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from biff8_reader import BiffError, read_xls  # noqa: E402
from multimodal_seq2seq_gscan_tpu_torch.analysis import plots  # noqa: E402
from multimodal_seq2seq_gscan_tpu_torch.analysis.render import (  # noqa: E402
    encode_gif, encode_png, render_situation)
from multimodal_seq2seq_gscan_tpu_torch.analysis.workbook import (  # noqa: E402
    Workbook)
from multimodal_seq2seq_gscan_tpu_torch.gscan.types import (  # noqa: E402
    INT_TO_DIR, Object, Position, PositionedObject, Situation)

ENDOFCHAIN = 0xFFFFFFFE


def _read_xls(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1", "not a CFB file"
    (minor, major, order, shift) = struct.unpack_from("<HHHH", data, 24)
    assert major == 3 and order == 0xFFFE and shift == 9
    n_fat = struct.unpack_from("<I", data, 44)[0]
    dir_sector = struct.unpack_from("<I", data, 48)[0]

    def sector(i):
        offset = 512 * (i + 1)
        return data[offset:offset + 512]

    fat = []
    difat = struct.unpack_from("<109I", data, 76)
    for s in difat[:n_fat]:
        fat.extend(struct.unpack_from("<128I", sector(s), 0))

    directory = sector(dir_sector)
    # Entry 0 = Root Entry, entry 1 = the Workbook stream.
    name_len = struct.unpack_from("<H", directory, 128 + 64)[0]
    name = directory[128:128 + name_len - 2].decode("utf-16-le")
    assert name == "Workbook", name
    start = struct.unpack_from("<I", directory, 128 + 116)[0]
    size = struct.unpack_from("<I", directory, 128 + 120)[0]

    chain, s = [], start
    while s != ENDOFCHAIN:
        chain.append(sector(s))
        s = fat[s]
    stream = b"".join(chain)[:size]

    # Walk BIFF records, collecting sheet names and cells.
    sheets, names, cells = [], [], None
    pos = 0
    while pos < len(stream):
        tag, length = struct.unpack_from("<HH", stream, pos)
        payload = stream[pos + 4:pos + 4 + length]
        pos += 4 + length
        if tag == 0x0809:  # BOF
            if struct.unpack_from("<H", payload, 2)[0] == 0x0010:
                cells = {}
                sheets.append(cells)
        elif tag == 0x0085:  # BOUNDSHEET
            n = payload[6]
            body = payload[8:]
            names.append(body[:n * 2].decode("utf-16-le") if payload[7] & 1
                         else body[:n].decode("latin-1"))
        elif tag == 0x0203:  # NUMBER
            row, col, _ = struct.unpack_from("<HHH", payload, 0)
            cells[(row, col)] = struct.unpack_from("<d", payload, 6)[0]
        elif tag == 0x0205:  # BOOLERR
            row, col, _ = struct.unpack_from("<HHH", payload, 0)
            cells[(row, col)] = bool(payload[6])
        elif tag == 0x0204:  # LABEL
            row, col, _ = struct.unpack_from("<HHH", payload, 0)
            n = struct.unpack_from("<H", payload, 6)[0]
            body = payload[9:]
            cells[(row, col)] = (body[:n * 2].decode("utf-16-le")
                                 if payload[8] & 1
                                 else body[:n].decode("latin-1"))
    return names, sheets


def test_xls_round_trip(tmp_path):
    workbook = Workbook()
    sheet = workbook.add_sheet("error analysis")
    sheet.write(0, 0, "split")
    sheet.write(0, 1, "exact match")
    sheet.write(1, 0, "dev")
    sheet.write(1, 1, 97.75)
    sheet.write(2, 1, True)
    other = workbook.add_sheet("ünïcode")
    other.write(0, 0, "ünïcode välue")
    other.write(5, 3, 42)

    path = str(tmp_path / "report.xls")
    workbook.save(path)

    names, sheets = _read_xls(path)
    assert names == ["error analysis", "ünïcode"]
    assert sheets[0][(0, 0)] == "split"
    assert sheets[0][(0, 1)] == "exact match"
    assert sheets[0][(1, 0)] == "dev"
    assert sheets[0][(1, 1)] == 97.75
    assert sheets[0][(2, 1)] is True
    assert sheets[1][(0, 0)] == "ünïcode välue"
    assert sheets[1][(5, 3)] == 42.0


def test_xls_large_sheet_spans_multiple_sectors(tmp_path):
    workbook = Workbook()
    sheet = workbook.add_sheet("big")
    for row in range(400):
        sheet.write(row, 0, "value-{}".format(row))
        sheet.write(row, 1, row * 1.5)
    path = str(tmp_path / "big.xls")
    workbook.save(path)
    names, sheets = _read_xls(path)
    assert names == ["big"]
    assert sheets[0][(399, 0)] == "value-399"
    assert sheets[0][(399, 1)] == 598.5


def test_independent_reader_roundtrip(tmp_path):
    wb = Workbook()
    s1 = wb.add_sheet("error_analysis")
    s1.write(0, 0, "exact match")
    s1.write(0, 1, True)
    s1.write(0, 2, False)
    s1.write(1, 0, 3)
    s1.write(1, 1, -2.5)
    s1.write(1, 2, 0.1)
    s1.write(2, 5, "walk to the red circle while spinning")
    s1.write(3, 0, "unicode: héllo ↑↓ ✓")
    s2 = wb.add_sheet("position")
    s2.write(10, 3, 98.15)
    wb.add_sheet("empty")
    path = str(tmp_path / "out.xls")
    wb.save(path)

    sheets = read_xls(path)
    assert list(sheets) == ["error_analysis", "position", "empty"]
    s1r = sheets["error_analysis"]
    assert s1r[(0, 0)] == "exact match"
    assert s1r[(0, 1)] is True
    assert s1r[(0, 2)] is False
    assert s1r[(1, 0)] == 3.0
    assert s1r[(1, 1)] == -2.5
    assert s1r[(1, 2)] == 0.1
    assert s1r[(2, 5)] == "walk to the red circle while spinning"
    assert s1r[(3, 0)] == "unicode: héllo ↑↓ ✓"
    assert sheets["position"] == {(10, 3): 98.15}
    assert sheets["empty"] == {}


def test_independent_reader_string_clamp(tmp_path):
    # The writer clamps LABEL strings to the 255-char record cap; the reader
    # must see exactly the clamped value.
    wb = Workbook()
    sheet = wb.add_sheet("s")
    long = "x" * 300
    sheet.write(0, 0, long)
    path = str(tmp_path / "clamp.xls")
    wb.save(path)
    assert read_xls(path)["s"][(0, 0)] == long[:255]


def test_independent_reader_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.xls")
    with open(path, "wb") as f:
        f.write(b"not an OLE2 file at all" * 40)
    try:
        read_xls(path)
    except BiffError:
        pass
    else:
        raise AssertionError("garbage accepted")


def test_committed_analysis_xls_parse_independently(tmp_path):
    """Every .xls artifact committed under documentation/ must parse with the
    independent reader and contain at least one populated sheet — so the
    real campaign analysis outputs, not just synthetic fixtures, prove out
    the format. The port's writer, given each one's cells, writes a file
    that reads back to the same sheets."""
    import glob

    repo = os.path.join(os.path.dirname(__file__), os.pardir)
    paths = glob.glob(os.path.join(repo, "documentation", "**", "*.xls"),
                      recursive=True)
    if not paths:
        pytest.skip("no committed .xls artifacts yet")
    for i, path in enumerate(paths):
        sheets = read_xls(path)
        assert any(cells for cells in sheets.values()), path
        workbook = Workbook()
        for name, cells in sheets.items():
            sheet = workbook.add_sheet(name)
            for (row, col), value in cells.items():
                sheet.write(row, col, value)
        copy = str(tmp_path / "copy_{}.xls".format(i))
        workbook.save(copy)
        assert read_xls(copy) == sheets, path


def test_render_situation_shapes_and_agent():
    """As tests/test_utils.py::test_render_situation_shapes_and_agent."""
    ov_vec = np.array([1, 0, 1])
    situation = Situation(
        grid_size=4, agent_position=Position(row=1, column=2),
        agent_direction=INT_TO_DIR[1],
        target_object=PositionedObject(
            object=Object(size=3, color="red", shape="circle"),
            position=Position(row=0, column=0), vector=ov_vec),
        placed_objects=[
            PositionedObject(object=Object(size=3, color="red", shape="circle"),
                             position=Position(row=0, column=0), vector=ov_vec),
            PositionedObject(object=Object(size=2, color="blue",
                                           shape="square"),
                             position=Position(row=3, column=3),
                             vector=ov_vec),
            PositionedObject(object=Object(size=4, color="green",
                                           shape="cylinder"),
                             position=Position(row=2, column=1),
                             vector=ov_vec)],
        carrying=None)
    image = render_situation(situation)
    assert image.shape == (240, 240, 3)
    # Red circle pixels near cell (0,0) center.
    assert (image[20:40, 20:40] == np.array([128, 0, 0])).all(axis=-1).any()
    # Agent (pink) around cell (row 1, col 2).
    assert (image[60:120, 120:180] == np.array([255, 192, 203])).all(
        axis=-1).any()
    # Attention shading darkens unattended cells.
    attention = np.zeros(16)
    attention[0] = 1.0
    shaded = render_situation(situation, attention_weights=attention)
    assert shaded.shape == (240, 240, 3)
    assert shaded.mean() < image.mean()


# ---------------------------------------------------------------------------
# PNG, GIF and SVG writers
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(data: bytes) -> np.ndarray:
    """A PNG decoder from the specification (8-bit RGB, any row filter),
    standard library only."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc, tag
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    width, height, depth, colour, _, _, interlace = header
    assert (depth, colour, interlace) == (8, 2, 0)
    raw = zlib.decompress(idat)
    stride = width * 3
    rows, previous = [], bytearray(stride)
    for y in range(height):
        kind = raw[y * (stride + 1)]
        line = bytearray(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        for x in range(stride):
            a = line[x - 3] if x >= 3 else 0
            b = previous[x]
            c = previous[x - 3] if x >= 3 else 0
            add = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            line[x] = (line[x] + add) & 0xFF
        rows.append(bytes(line))
        previous = line
    return np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(
        height, width, 3)


def _frames(count, grid=5, seed=0):
    rng = np.random.RandomState(seed)
    colors = ["red", "green", "blue", "yellow"]
    shapes = ["circle", "square", "cylinder"]
    frames = []
    for i in range(count):
        objects = [PositionedObject(
            object=Object(size=int(rng.randint(1, 5)),
                          color=colors[rng.randint(4)],
                          shape=shapes[rng.randint(3)]),
            position=Position(row=int(rng.randint(grid)),
                              column=int(rng.randint(grid))),
            vector=np.zeros(3)) for _ in range(4)]
        situation = Situation(
            grid_size=grid,
            agent_position=Position(row=int(rng.randint(grid)),
                                    column=int(rng.randint(grid))),
            agent_direction=INT_TO_DIR[int(rng.randint(4))],
            target_object=None, placed_objects=objects, carrying=None)
        attention = rng.dirichlet(np.ones(grid * grid)) if i % 2 else None
        frames.append(render_situation(situation, attention_weights=attention))
    return frames


def test_png_round_trip():
    for frame in _frames(3) + [
            np.random.RandomState(1).randint(0, 256, (7, 11, 3),
                                             dtype=np.uint8)]:
        assert np.array_equal(decode_png(encode_png(frame)), frame)


def test_gif_round_trip():
    """Every frame back exactly, through an independent decoder (PIL): the
    rendered frames, then noise of 64 colours whose LZW table fills and
    is cleared many times over."""
    Image = pytest.importorskip("PIL.Image")
    noise = np.random.RandomState(2).randint(0, 4, (150, 190, 3),
                                             dtype=np.uint8) * 60
    for frames in (_frames(6), [noise, noise[::-1].copy()]):
        data = encode_gif(frames)
        assert data[:6] == b"GIF89a"
        image = Image.open(io.BytesIO(data))
        assert image.n_frames == len(frames)
        for i, frame in enumerate(frames):
            image.seek(i)
            assert np.array_equal(np.asarray(image.convert("RGB")), frame)


def test_gif_refuses_more_than_256_colours():
    frame = np.arange(300 * 3, dtype=np.uint32).reshape(1, 300, 3) % 256
    frame[0, :, 0] = np.arange(300) % 256
    frame[0, :, 1] = np.arange(300) // 256
    with pytest.raises(ValueError, match="256"):
        encode_gif([frame.astype(np.uint8)])


def test_svg_bar_plots(tmp_path):
    path = str(tmp_path / "plot.svg")
    plots.bar_plot({"walk": 3, "push": 7, "pull": 5}, "verbs", path,
                   errors={"walk": 0.5, "push": 1.0, "pull": 0.0},
                   y_axis_label="count")
    root = ElementTree.parse(path).getroot()
    namespace = "{http://www.w3.org/2000/svg}"
    bars = [rect.find(namespace + "title").text
            for rect in root.iter(namespace + "rect")
            if rect.find(namespace + "title") is not None]
    assert bars == ["3", "5", "7"]  # sorted by value, as the reference
    texts = [t.text for t in root.iter(namespace + "text")]
    assert "verbs" in texts and "count" in texts
    assert ["walk", "pull", "push"] == [t for t in texts
                                        if t in ("walk", "push", "pull")]
    assert len(list(root.iter(namespace + "line"))) == 3  # error bars

    path = str(tmp_path / "grouped.svg")
    plots.grouped_bar_plot({"b": {True: 2, False: 1}, "a": {True: 4}},
                           True, False, "exact <matches>", path)
    root = ElementTree.parse(path).getroot()
    bars = [rect.find(namespace + "title").text
            for rect in root.iter(namespace + "rect")
            if rect.find(namespace + "title") is not None]
    assert bars == ["4", "2", "0", "1"]
    assert "exact <matches>" in [t.text for t in root.iter(namespace + "text")]
