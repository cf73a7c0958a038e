"""Minimal genuine ``.xls`` (BIFF8) workbook writer.

The reference emits real Excel workbooks via xlwt (reference
GroundedScan/dataset.py:673,810-811). xlwt is not available in this
environment, so this module implements the two public file formats needed to
produce an equivalent file from scratch:

- the OLE2 / Compound File Binary container ([MS-CFB]): one FAT-allocated
  "Workbook" stream (padded past the 4096-byte mini-stream cutoff so no
  mini-FAT is required);
- the BIFF8 record stream ([MS-XLS]): workbook globals (BOF, CODEPAGE,
  WINDOW1, FONTs, XFs, BOUNDSHEETs) followed by one worksheet substream per
  sheet (BOF, DIMENSIONS, NUMBER/BOOLERR/LABEL cell records, EOF).

API matches xlwt's subset used by the analysis tools: ``Workbook()``,
``workbook.add_sheet(name)``, ``sheet.write(row, col, value)``,
``workbook.save(path)``.
"""

import struct
from typing import Dict, List, Tuple

SECTOR = 512
ENDOFCHAIN = 0xFFFFFFFE
FATSECT = 0xFFFFFFFD
FREESECT = 0xFFFFFFFF
NOSTREAM = 0xFFFFFFFF

_CELL_XF = 16  # index of the first (and only) cell XF we emit


def _record(tag: int, payload: bytes) -> bytes:
    return struct.pack("<HH", tag, len(payload)) + payload


def _short_unicode(text: str) -> bytes:
    """BIFF8 ShortXLUnicodeString (1-byte length), UTF-16 when needed."""
    raw = text[:31]
    if all(ord(ch) < 256 for ch in raw):
        return struct.pack("<BB", len(raw), 0) + raw.encode("latin-1")
    return struct.pack("<BB", len(raw), 1) + raw.encode("utf-16-le")


def _long_unicode(text: str) -> bytes:
    """BIFF8 XLUnicodeString (2-byte length).

    Clamped to the Label record's 255-character cap ([MS-XLS] 2.4.148) —
    longer strings would need CONTINUE records, which the analysis outputs
    never require.
    """
    text = text[:255]
    if all(ord(ch) < 256 for ch in text):
        return struct.pack("<HB", len(text), 0) + text.encode("latin-1")
    return struct.pack("<HB", len(text), 1) + text.encode("utf-16-le")


def _font_record() -> bytes:
    # height 10pt, no attributes, automatic color, normal weight, 'Arial'.
    return _record(0x0031, struct.pack(
        "<HHHHHBBBB", 200, 0, 0x7FFF, 400, 0, 0, 0, 0, 0)
        + _short_unicode("Arial"))


def _xf_record(style: bool) -> bytes:
    # ifnt, ifmt, flags (fLocked + fStyle for style XFs), alignment,
    # rotation/indent/usedattr, borders/fill (none), pattern colors.
    flags = 0xFFF5 if style else 0x0001
    return _record(0x00E0, struct.pack(
        "<HHHBBBBIIH", 0, 0, flags, 0x20, 0, 0, 0, 0, 0, 0x20C0))


class Sheet:
    def __init__(self, name: str):
        self.name = name
        self._cells: Dict[Tuple[int, int], object] = {}

    def write(self, row: int, col: int, value):
        self._cells[(row, col)] = value

    def _substream(self) -> bytes:
        parts = [_record(0x0809, struct.pack(  # BOF, worksheet substream
            "<HHHHII", 0x0600, 0x0010, 0x0DBB, 0x07CC, 0, 0x0006))]
        max_row = max((r for r, _ in self._cells), default=0)
        max_col = max((c for _, c in self._cells), default=0)
        parts.append(_record(0x0200, struct.pack(  # DIMENSIONS
            "<IIHHH", 0, max_row + 1, 0, max_col + 1, 0)))
        for (row, col) in sorted(self._cells):
            value = self._cells[(row, col)]
            head = struct.pack("<HHH", row, col, _CELL_XF)
            if isinstance(value, bool):
                parts.append(_record(0x0205, head  # BOOLERR
                                     + struct.pack("<BB", int(value), 0)))
            elif isinstance(value, (int, float)):
                parts.append(_record(0x0203, head  # NUMBER
                                     + struct.pack("<d", float(value))))
            else:
                parts.append(_record(0x0204, head  # LABEL
                                     + _long_unicode(str(value))))
        parts.append(_record(0x000A, b""))  # EOF
        return b"".join(parts)


class Workbook:
    def __init__(self):
        self._sheets: List[Sheet] = []

    def add_sheet(self, name: str) -> Sheet:
        sheet = Sheet(name)
        self._sheets.append(sheet)
        return sheet

    # -- BIFF stream -----------------------------------------------------

    def _biff_stream(self) -> bytes:
        globals_parts = [
            _record(0x0809, struct.pack(  # BOF, workbook globals
                "<HHHHII", 0x0600, 0x0005, 0x0DBB, 0x07CC, 0, 0x0006)),
            _record(0x0042, struct.pack("<H", 0x04B0)),  # CODEPAGE UTF-16
            _record(0x003D, struct.pack(  # WINDOW1
                "<HHHHHHHHH", 0x0168, 0x010E, 0x3A5C, 0x23BE, 0x0038,
                0, 0, 1, 0x0258)),
        ]
        globals_parts.extend(_font_record() for _ in range(5))
        globals_parts.extend(_xf_record(style=True) for _ in range(16))
        globals_parts.append(_xf_record(style=False))

        substreams = [sheet._substream() for sheet in self._sheets]
        boundsheets = [
            _record(0x0085, b"\x00\x00\x00\x00\x00\x00"
                    + _short_unicode(sheet.name or "Sheet{}".format(i + 1)))
            for i, sheet in enumerate(self._sheets)]
        globals_blob = (b"".join(globals_parts) + b"".join(boundsheets)
                        + _record(0x000A, b""))

        # Patch each BOUNDSHEET's absolute stream position of its sheet BOF.
        offsets = []
        position = len(globals_blob)
        for sub in substreams:
            offsets.append(position)
            position += len(sub)
        blob = bytearray(globals_blob)
        cursor = len(b"".join(globals_parts))
        for record, offset in zip(boundsheets, offsets):
            struct.pack_into("<I", blob, cursor + 4, offset)
            cursor += len(record)
        return bytes(blob) + b"".join(substreams)

    # -- CFB container -----------------------------------------------------

    @staticmethod
    def _cfb(stream: bytes) -> bytes:
        # [MS-CFB] requires streams smaller than the 4096-byte cutoff to live
        # in the root entry's mini stream — a conforming reader looks for
        # them there, so small workbooks must take the mini-FAT path.
        size = len(stream)
        if size < 4096:
            return Workbook._cfb_mini(stream)
        padded = size + (-size) % SECTOR
        stream = stream + b"\x00" * (padded - len(stream))
        n_stream = padded // SECTOR

        def dir_entry(name, entry_type, start, length, child=NOSTREAM):
            encoded = name.encode("utf-16-le") + b"\x00\x00"
            entry = bytearray(128)
            entry[0:len(encoded)] = encoded
            struct.pack_into("<H", entry, 64, len(encoded))
            entry[66] = entry_type  # 5 = root storage, 2 = stream, 0 = unused
            entry[67] = 1           # black
            struct.pack_into("<III", entry, 68, NOSTREAM, NOSTREAM, child)
            struct.pack_into("<I", entry, 116, start)
            struct.pack_into("<I", entry, 120, length)
            return bytes(entry)

        directory = (
            dir_entry("Root Entry", 5, ENDOFCHAIN, 0, child=1)
            + dir_entry("Workbook", 2, 0, size)
            + bytes(128) + bytes(128))
        dir_sector = n_stream

        # FAT: stream chain, directory sector, then the FAT sectors
        # themselves; sized iteratively since the FAT describes itself.
        n_fat = 1
        while True:
            total = n_stream + 1 + n_fat
            needed = (total + SECTOR // 4 - 1) // (SECTOR // 4)
            if needed <= n_fat:
                break
            n_fat = needed
        fat = [i + 1 for i in range(n_stream - 1)] + [ENDOFCHAIN]
        fat.append(ENDOFCHAIN)  # directory sector
        fat.extend([FATSECT] * n_fat)
        fat.extend([FREESECT] * (n_fat * (SECTOR // 4) - len(fat)))
        fat_blob = struct.pack("<{}I".format(len(fat)), *fat)

        header = bytearray(SECTOR)
        header[0:8] = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
        struct.pack_into("<HHHHH", header, 24, 0x003E, 0x0003, 0xFFFE, 9, 6)
        struct.pack_into("<I", header, 44, n_fat)
        struct.pack_into("<I", header, 48, dir_sector)
        struct.pack_into("<I", header, 56, 4096)          # mini cutoff
        struct.pack_into("<I", header, 60, ENDOFCHAIN)    # first mini FAT
        struct.pack_into("<I", header, 64, 0)
        struct.pack_into("<I", header, 68, ENDOFCHAIN)    # first DIFAT
        struct.pack_into("<I", header, 72, 0)
        difat = [dir_sector + 1 + i for i in range(n_fat)]
        difat.extend([FREESECT] * (109 - len(difat)))
        struct.pack_into("<109I", header, 76, *difat)

        return bytes(header) + stream + directory.ljust(SECTOR, b"\x00") \
            + fat_blob

    @staticmethod
    def _cfb_mini(stream: bytes) -> bytes:
        """Container for a sub-cutoff stream: mini-FAT + root mini stream."""
        size = len(stream)
        mini_count = max(1, -(-size // 64))
        mini = stream + b"\x00" * (mini_count * 64 - size)
        mini_padded = mini + b"\x00" * ((-len(mini)) % SECTOR)
        n_mini_sect = len(mini_padded) // SECTOR

        # Mini-FAT: one chain covering the Workbook's mini sectors.
        minifat = [i + 1 for i in range(mini_count - 1)] + [ENDOFCHAIN]
        minifat.extend([FREESECT] * ((-len(minifat)) % (SECTOR // 4)))
        minifat_blob = struct.pack("<{}I".format(len(minifat)), *minifat)
        n_minifat_sect = len(minifat_blob) // SECTOR

        # Sector layout: mini stream | directory | mini FAT | FAT.
        dir_sector = n_mini_sect
        minifat_sector = dir_sector + 1
        fat_sector = minifat_sector + n_minifat_sect
        n_fat = 1
        while True:
            total = fat_sector + n_fat
            needed = (total + SECTOR // 4 - 1) // (SECTOR // 4)
            if needed <= n_fat:
                break
            n_fat = needed

        fat = [i + 1 for i in range(n_mini_sect - 1)] + [ENDOFCHAIN]
        fat.append(ENDOFCHAIN)  # directory sector
        fat.extend([minifat_sector + i + 1
                    for i in range(n_minifat_sect - 1)] + [ENDOFCHAIN])
        fat.extend([FATSECT] * n_fat)
        fat.extend([FREESECT] * (n_fat * (SECTOR // 4) - len(fat)))
        fat_blob = struct.pack("<{}I".format(len(fat)), *fat)

        def dir_entry(name, entry_type, start, length, child=NOSTREAM):
            encoded = name.encode("utf-16-le") + b"\x00\x00"
            entry = bytearray(128)
            entry[0:len(encoded)] = encoded
            struct.pack_into("<H", entry, 64, len(encoded))
            entry[66] = entry_type
            entry[67] = 1
            struct.pack_into("<III", entry, 68, NOSTREAM, NOSTREAM, child)
            struct.pack_into("<I", entry, 116, start)
            struct.pack_into("<I", entry, 120, length)
            return bytes(entry)

        directory = (
            dir_entry("Root Entry", 5, 0, len(mini), child=1)
            + dir_entry("Workbook", 2, 0, size)
            + bytes(128) + bytes(128))

        header = bytearray(SECTOR)
        header[0:8] = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
        struct.pack_into("<HHHHH", header, 24, 0x003E, 0x0003, 0xFFFE, 9, 6)
        struct.pack_into("<I", header, 44, n_fat)
        struct.pack_into("<I", header, 48, dir_sector)
        struct.pack_into("<I", header, 56, 4096)            # mini cutoff
        struct.pack_into("<I", header, 60, minifat_sector)  # first mini FAT
        struct.pack_into("<I", header, 64, n_minifat_sect)
        struct.pack_into("<I", header, 68, ENDOFCHAIN)      # first DIFAT
        struct.pack_into("<I", header, 72, 0)
        difat = [fat_sector + i for i in range(n_fat)]
        difat.extend([FREESECT] * (109 - len(difat)))
        struct.pack_into("<109I", header, 76, *difat)

        return (bytes(header) + mini_padded
                + directory.ljust(SECTOR, b"\x00")
                + minifat_blob + fat_blob)

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self._cfb(self._biff_stream()))
        return path
