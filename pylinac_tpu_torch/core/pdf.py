"""A self-written PDF report writer: no reportlab, no matplotlib.

Carried over from ``pylinac_tpu/core/pdf.py`` (``_PdfWriter`` ``:19``,
``PylinacCanvas`` ``:112``), unchanged: PDF 1.4 with Helvetica text and
embedded PNG images on A4 pages, written byte for byte as JAX writes it.
The calibration worksheets' ``publish_pdf`` use it.
"""

from __future__ import annotations

import io
import zlib
from datetime import datetime
from pathlib import Path

A4_PT = (595.27, 841.89)  # points
CM_TO_PT = 28.3465


class _PdfWriter:
    """Assembles a multi-page PDF with Helvetica text and PNG images."""

    def __init__(self):
        self.pages: list[dict] = []
        self.new_page()

    def new_page(self):
        self.pages.append({"content": [], "images": []})

    def add_text(self, x_pt: float, y_pt: float, text: str, font_size: float = 10):
        safe = text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
        self.pages[-1]["content"].append(
            f"BT /F1 {font_size} Tf {x_pt:.2f} {y_pt:.2f} Td ({safe}) Tj ET")

    def add_image(self, png_bytes: bytes, x_pt, y_pt, w_pt, h_pt):
        self.pages[-1]["images"].append((png_bytes, x_pt, y_pt, w_pt, h_pt))

    def save(self, filename):
        objects: list[bytes] = []

        def add_obj(body: bytes) -> int:
            objects.append(body)
            return len(objects)  # 1-indexed

        font_id = add_obj(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")

        page_ids = []
        kids_placeholder = add_obj(b"PLACEHOLDER_PAGES")  # parent /Pages node
        for page in self.pages:
            xobj_refs = {}
            for img_i, (png, x, y, w, h) in enumerate(page["images"]):
                img_id = self._add_png_xobject(add_obj, png)
                if img_id is not None:
                    xobj_refs[f"Im{img_i}"] = (img_id, x, y, w, h)
            content = "\n".join(page["content"])
            for name, (img_id, x, y, w, h) in xobj_refs.items():
                content += f"\nq {w:.2f} 0 0 {h:.2f} {x:.2f} {y:.2f} cm /{name} Do Q"
            stream = zlib.compress(content.encode("latin-1", "replace"))
            content_id = add_obj(
                b"<< /Length " + str(len(stream)).encode() +
                b" /Filter /FlateDecode >>\nstream\n" + stream + b"\nendstream")
            xobj_dict = " ".join(f"/{name} {oid} 0 R" for name, (oid, *_rest) in xobj_refs.items())
            page_body = (
                f"<< /Type /Page /Parent {kids_placeholder} 0 R "
                f"/MediaBox [0 0 {A4_PT[0]} {A4_PT[1]}] "
                f"/Resources << /Font << /F1 {font_id} 0 R >> "
                f"/XObject << {xobj_dict} >> >> "
                f"/Contents {content_id} 0 R >>"
            ).encode()
            page_ids.append(add_obj(page_body))

        kids = " ".join(f"{pid} 0 R" for pid in page_ids)
        objects[kids_placeholder - 1] = (
            f"<< /Type /Pages /Kids [{kids}] /Count {len(page_ids)} >>").encode()
        catalog_id = add_obj(f"<< /Type /Catalog /Pages {kids_placeholder} 0 R >>".encode())

        out = io.BytesIO()
        out.write(b"%PDF-1.4\n")
        offsets = [0]
        for i, body in enumerate(objects, start=1):
            offsets.append(out.tell())
            out.write(f"{i} 0 obj\n".encode())
            out.write(body)
            out.write(b"\nendobj\n")
        xref_pos = out.tell()
        out.write(f"xref\n0 {len(objects) + 1}\n".encode())
        out.write(b"0000000000 65535 f \n")
        for off in offsets[1:]:
            out.write(f"{off:010d} 00000 n \n".encode())
        out.write(
            f"trailer\n<< /Size {len(objects) + 1} /Root {catalog_id} 0 R >>\n"
            f"startxref\n{xref_pos}\n%%EOF".encode())
        Path(filename).write_bytes(out.getvalue()) if not hasattr(filename, "write") \
            else filename.write(out.getvalue())

    @staticmethod
    def _add_png_xobject(add_obj, png_bytes: bytes) -> int | None:
        """Decode a PNG via PIL and embed as a FlateDecode RGB image."""
        try:
            from PIL import Image

            img = Image.open(io.BytesIO(png_bytes)).convert("RGB")
            raw = zlib.compress(img.tobytes())
            body = (
                f"<< /Type /XObject /Subtype /Image /Width {img.width} "
                f"/Height {img.height} /ColorSpace /DeviceRGB /BitsPerComponent 8 "
                f"/Filter /FlateDecode /Length {len(raw)} >>\nstream\n").encode() + raw + b"\nendstream"
            return add_obj(body)
        except Exception:
            return None


class PylinacCanvas:
    """A4 canvas with a cm-based coordinate API: (x, y) locations in cm
    from the bottom left."""

    def __init__(self, filename, page_title: str, metadata: dict | None = None,
                 metadata_location: tuple[float, float] = (2, 25.5),
                 font: str = "Helvetica", logo: str | Path | None = None):
        self._writer = _PdfWriter()
        self._filename = filename
        self._title = page_title
        self._metadata = metadata
        self._metadata_location = metadata_location
        self._logo = logo
        self._initialize_page()

    def _initialize_page(self):
        self.add_text(self._title, location=(1.5, 26.5), font_size=18)
        self.add_text(f"Generated by pylinac-tpu on {datetime.now():%Y-%m-%d %H:%M}",
                      location=(1.5, 0.5), font_size=8)
        if self._metadata is not None:
            text = ["Metadata:"] + [f"{k}: {v}" for k, v in self._metadata.items()]
            self.add_text(text=text, location=self._metadata_location, font_size=8)

    def add_new_page(self):
        self._writer.new_page()
        self._initialize_page()

    def add_text(self, text: str | list[str], location: tuple[float, float],
                 font_size: int = 10):
        x_pt = location[0] * CM_TO_PT
        y_pt = location[1] * CM_TO_PT
        lines = text if isinstance(text, list) else str(text).split("\n")
        for i, line in enumerate(lines):
            self._writer.add_text(x_pt, y_pt - i * font_size * 1.35, line, font_size)

    def add_image(self, image_data: io.BytesIO | str | Path,
                  location: tuple[float, float], dimensions: tuple[float, float]):
        if hasattr(image_data, "getvalue"):
            png = image_data.getvalue()
        else:
            png = Path(image_data).read_bytes()
        x_pt = location[0] * CM_TO_PT
        y_pt = location[1] * CM_TO_PT
        w_pt = dimensions[0] * CM_TO_PT
        h_pt = dimensions[1] * CM_TO_PT
        self._writer.add_image(png, x_pt, y_pt, w_pt, h_pt)

    def finish(self):
        self._writer.save(self._filename)
