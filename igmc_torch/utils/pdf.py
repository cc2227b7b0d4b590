"""A one-page vector PDF writer (standard library only).

    page = Page(1440, 720)                     # width, height in points
    page.line(10, 10, 100, 50, (1, 0, 0))      # stroked segment, RGB in [0, 1]
    page.rect(10, 10, 30, 20, (0, 0, 1))       # filled (or fill=False: stroked)
    page.disc(200, 200, 6, (0, 0.5, 0))        # filled disc, four Bezier arcs
    page.text(720, 20, "1.2345 (4.0)", 20, anchor="center")
    page.save("out.pdf")

Coordinates are PDF points with the origin at the bottom left. Text is set
in the standard Helvetica font (one of the 14 fonts every reader has, so
nothing is embedded); its width for centring comes from Helvetica's
published metrics. The content stream is deflated with zlib unless
`compress=False`. Each drawing call writes one line of the content stream:
`... m ... l S` for a segment, `... re f` / `... re S` for a rectangle,
`... m ... c ... c ... c ... c f` for a disc and `BT ... Tj ET` for text.
"""

from __future__ import annotations

import zlib

# Helvetica's advance widths (1/1000 em) of the printable ASCII characters
# 32..126, from its AFM file; other characters are drawn as "?"
_HELVETICA_WIDTHS = (
    278, 278, 355, 556, 556, 889, 667, 191, 333, 333, 389, 584, 278, 333, 278, 278,
    556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 278, 278, 584, 584, 584, 556,
    1015, 667, 667, 722, 722, 667, 611, 778, 722, 278, 500, 667, 556, 833, 722, 778,
    667, 778, 722, 667, 611, 722, 667, 944, 667, 667, 611, 278, 278, 278, 469, 556,
    333, 556, 556, 500, 556, 556, 278, 556, 556, 222, 222, 500, 222, 833, 556, 556,
    556, 556, 333, 500, 278, 556, 500, 722, 500, 500, 500, 334, 260, 334, 584)

# a quarter circle of radius 1 as one cubic Bezier: control points at KAPPA
KAPPA = 0.5522847498307936


def _num(x: float) -> str:
    """A coordinate or colour component: at most 3 decimals, no trailing
    zeros, no negative zero."""
    s = f"{x:.3f}".rstrip("0").rstrip(".")
    return "0" if s in ("-0", "") else s


def _rgb(rgb) -> str:
    return " ".join(_num(min(max(float(c), 0.0), 1.0)) for c in rgb)


def _printable(s: str) -> str:
    return "".join(c if 32 <= ord(c) <= 126 else "?" for c in s)


def escape_text(s: str) -> str:
    """`s` as the body of a PDF literal string: \\, ( and ) escaped."""
    return (_printable(s).replace("\\", "\\\\").replace("(", "\\(")
            .replace(")", "\\)"))


def text_width(s: str, size: float) -> float:
    """Width in points of `s` set in Helvetica at `size` points."""
    return sum(_HELVETICA_WIDTHS[ord(c) - 32] for c in _printable(s)) * size / 1000.0


class Page:
    """One page of `width` x `height` points; drawing calls append to its
    content stream in order (later calls paint over earlier ones)."""

    def __init__(self, width: float, height: float):
        self.width, self.height = float(width), float(height)
        self.ops: list = []

    def line(self, x0, y0, x1, y1, rgb, width: float = 1.0) -> None:
        self.ops.append(f"{_num(width)} w {_rgb(rgb)} RG {_num(x0)} {_num(y0)} m "
                        f"{_num(x1)} {_num(y1)} l S")

    def rect(self, x, y, w, h, rgb, fill: bool = True, width: float = 1.0) -> None:
        box = f"{_num(x)} {_num(y)} {_num(w)} {_num(h)} re"
        if fill:
            self.ops.append(f"{_rgb(rgb)} rg {box} f")
        else:
            self.ops.append(f"{_num(width)} w {_rgb(rgb)} RG {box} S")

    def disc(self, cx, cy, r, rgb) -> None:
        k = KAPPA * r
        pts = [(cx + r, cy), (cx + r, cy + k), (cx + k, cy + r), (cx, cy + r),
               (cx - k, cy + r), (cx - r, cy + k), (cx - r, cy),
               (cx - r, cy - k), (cx - k, cy - r), (cx, cy - r),
               (cx + k, cy - r), (cx + r, cy - k), (cx + r, cy)]
        p = lambda i: f"{_num(pts[i][0])} {_num(pts[i][1])}"
        arcs = " ".join(f"{p(i)} {p(i + 1)} {p(i + 2)} c" for i in (1, 4, 7, 10))
        self.ops.append(f"{_rgb(rgb)} rg {p(0)} m {arcs} f")

    def text(self, x, y, s: str, size: float, rgb=(0, 0, 0),
             anchor: str = "left") -> None:
        """`s` with its baseline at y, starting at x (anchor "left") or
        centred on x ("center")."""
        shift = {"left": 0.0, "center": 0.5}[anchor]
        x = x - shift * text_width(s, size)
        self.ops.append(f"BT {_rgb(rgb)} rg /F1 {_num(size)} Tf {_num(x)} {_num(y)} Td "
                        f"({escape_text(s)}) Tj ET")

    def content(self) -> bytes:
        return ("\n".join(self.ops) + "\n").encode("latin-1")

    def save(self, path: str, compress: bool = True) -> None:
        """Write the page as a PDF file: catalog, page tree, page, font,
        content stream, then the xref table and trailer."""
        stream = self.content()
        if compress:
            stream = zlib.compress(stream)
        head = (f"<< /Length {len(stream)}"
                + (" /Filter /FlateDecode" if compress else "") + " >>")
        objects = [
            b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {_num(self.width)} "
             f"{_num(self.height)}] /Resources << /Font << /F1 4 0 R >> >> "
             f"/Contents 5 0 R >>").encode(),
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
            b"/Encoding /WinAnsiEncoding >>",
            (head + "\nstream\n").encode() + stream
            + b"\nendstream",
        ]
        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = []
        for i, body in enumerate(objects, start=1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
        xref = len(out)
        out += f"xref\n0 {len(objects) + 1}\n".encode()
        out += b"0000000000 65535 f \n"
        out += b"".join(f"{o:010d} 00000 n \n".encode() for o in offsets)
        out += (f"trailer\n<< /Size {len(objects) + 1} /Root 1 0 R >>\n"
                f"startxref\n{xref}\n%%EOF\n").encode()
        with open(path, "wb") as f:
            f.write(out)


def check_pdf(path: str) -> str:
    """Check the structure of a PDF that Page.save wrote and return its
    content stream as text: the `%PDF-` header and `%%EOF` end, `startxref`
    pointing at the `xref` table, every in-use xref offset pointing at its
    `<n> 0 obj`, and the stream's /Length (inflated when /FlateDecode).
    Raises ValueError naming the first fault."""
    data = open(path, "rb").read()
    if not data.startswith(b"%PDF-"):
        raise ValueError(f"{path}: no %PDF- header")
    if not data.rstrip().endswith(b"%%EOF"):
        raise ValueError(f"{path}: does not end with %%EOF")
    tail = data[data.rindex(b"startxref"):].split()
    xref = int(tail[1])
    if not data[xref:].startswith(b"xref"):
        raise ValueError(f"{path}: startxref {xref} does not point at xref")
    lines = data[xref:].split(b"\n")
    first, count = (int(v) for v in lines[1].split())
    for n, entry in enumerate(lines[2:2 + count], start=first):
        offset, _, kind = entry.split()
        if kind == b"n" and not data[int(offset):].startswith(f"{n} 0 obj".encode()):
            raise ValueError(f"{path}: xref entry {n} does not point at its object")
    start = data.index(b"stream\n") + len(b"stream\n")
    head = data[data.rindex(b"<<", 0, start):start]
    length = int(head.split(b"/Length")[1].split()[0])
    stream = data[start:start + length]
    if not data[start + length:].startswith(b"\nendstream"):
        raise ValueError(f"{path}: the content stream's /Length is wrong")
    if b"/FlateDecode" in head:
        stream = zlib.decompress(stream)
    return stream.decode("latin-1")
