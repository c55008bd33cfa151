"""label-generation service (reference: service-label-generation,
[SURVEY.md §2.2]): render scannable labels for devices/assets.

The reference uses ZXing to render QR symbols; the dependency-free
equivalent here renders **SVG labels with a Code 39 barcode** (a real
scannable symbology with a trivial encoding table) plus entity name and
token text. The generator protocol is open so a QR generator can be
registered later without touching callers.
"""

from __future__ import annotations

from typing import Optional, Protocol

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine

# Code 39: each symbol is 9 elements (bars/spaces), 3 wide. '1' = wide.
_CODE39 = {
    "0": "000110100", "1": "100100001", "2": "001100001", "3": "101100000",
    "4": "000110001", "5": "100110000", "6": "001110000", "7": "000100101",
    "8": "100100100", "9": "001100100", "A": "100001001", "B": "001001001",
    "C": "101001000", "D": "000011001", "E": "100011000", "F": "001011000",
    "G": "000001101", "H": "100001100", "I": "001001100", "J": "000011100",
    "K": "100000011", "L": "001000011", "M": "101000010", "N": "000010011",
    "O": "100010010", "P": "001010010", "Q": "000000111", "R": "100000110",
    "S": "001000110", "T": "000010110", "U": "110000001", "V": "011000001",
    "W": "111000000", "X": "010010001", "Y": "110010000", "Z": "011010000",
    "-": "010000101", ".": "110000100", " ": "011000100", "$": "010101000",
    "/": "010100010", "+": "010001010", "%": "000101010", "*": "010010100",
}


def code39_svg(text: str, *, bar_height: int = 60, narrow: int = 2,
               wide: int = 5, quiet: int = 12) -> tuple[str, int]:
    """Render `text` as a Code 39 barcode SVG fragment (bars only)."""
    payload = "*" + "".join(
        c for c in text.upper() if c in _CODE39 and c != "*") + "*"
    x = quiet
    bars = []
    for ch in payload:
        pattern = _CODE39[ch]
        for i, w in enumerate(pattern):
            width = wide if w == "1" else narrow
            if i % 2 == 0:  # even positions are bars, odd are spaces
                bars.append(f'<rect x="{x}" y="0" width="{width}" '
                            f'height="{bar_height}" fill="black"/>')
            x += width
        x += narrow  # inter-character gap
    return f'<g>{"".join(bars)}</g>', x + quiet


class LabelGenerator(Protocol):
    """(reference: symbol generator SPI)"""

    def generate(self, title: str, token: str, subtitle: str = "") -> bytes: ...


class Code39LabelGenerator:
    def generate(self, title: str, token: str, subtitle: str = "") -> bytes:
        from xml.sax.saxutils import escape

        title, subtitle = escape(title), escape(subtitle)
        barcode, width = code39_svg(token)
        width = max(width, 240)
        svg = f"""<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="120">
<rect width="100%" height="100%" fill="white"/>
<text x="12" y="18" font-family="monospace" font-size="14" font-weight="bold">{title}</text>
<text x="12" y="34" font-family="monospace" font-size="10" fill="#555">{subtitle}</text>
<g transform="translate(0,42)">{barcode}</g>
<text x="12" y="116" font-family="monospace" font-size="10">{escape(token.upper())}</text>
</svg>"""
        return svg.encode()


class QrLabelGenerator:
    """QR symbology (reference: ZXing QR) — real ISO 18004 byte-mode
    encoding (services/qrcode.py), verified scannable."""

    def generate(self, title: str, token: str, subtitle: str = "") -> bytes:
        from xml.sax.saxutils import escape

        from sitewhere_tpu_torch.services.qrcode import qr_matrix

        M = qr_matrix(token.encode("utf-8"))
        module, quiet = 4, 4
        qdim = (len(M) + 2 * quiet) * module
        path = []
        for r, row in enumerate(M):
            for c, v in enumerate(row):
                if v:
                    x, y = (c + quiet) * module, (r + quiet) * module
                    path.append(f"M{x} {y}h{module}v{module}h-{module}z")
        width = max(qdim + 24, 240)
        height = qdim + 56
        svg = f"""<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}">
<rect width="100%" height="100%" fill="white"/>
<text x="12" y="18" font-family="monospace" font-size="14" font-weight="bold">{escape(title)}</text>
<text x="12" y="34" font-family="monospace" font-size="10" fill="#555">{escape(subtitle)}</text>
<g transform="translate(12,40)"><path fill="#000" d="{''.join(path)}"/></g>
<text x="12" y="{height - 6}" font-family="monospace" font-size="10">{escape(token)}</text>
</svg>"""
        return svg.encode()


class LabelGenerationEngine(TenantEngine):
    def __init__(self, service: "LabelGenerationService", tenant: TenantConfig):
        super().__init__(service, tenant)
        self.generators: dict[str, LabelGenerator] = {
            "code39": Code39LabelGenerator(),
            "qr": QrLabelGenerator()}
        self.default_generator = tenant.section(
            "label-generation", {}).get("generator", "code39")

    def register_generator(self, name: str, gen: LabelGenerator) -> None:
        self.generators[name] = gen

    def device_label(self, device_token: str,
                     generator: Optional[str] = None) -> bytes:
        dm = self.runtime.api("device-management").management(self.tenant_id)
        device = dm.get_device_by_token(device_token)
        if device is None:
            raise KeyError(f"unknown device {device_token!r}")
        dtype = dm.get_device_type(device.device_type_id)
        gen = self.generators[generator or self.default_generator]
        return gen.generate(dtype.name if dtype else "device",
                            device.token, f"index {device.index}")

    def asset_label(self, asset_token: str,
                    generator: Optional[str] = None) -> bytes:
        am = self.runtime.api("asset-management").management(self.tenant_id)
        asset = am.get_asset_by_token(asset_token)
        if asset is None:
            raise KeyError(f"unknown asset {asset_token!r}")
        gen = self.generators[generator or self.default_generator]
        return gen.generate(asset.name or "asset", asset.token, "asset")


class LabelGenerationService(Service):
    identifier = "label-generation"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> LabelGenerationEngine:
        return LabelGenerationEngine(self, tenant)

    def labels(self, tenant_id: str) -> LabelGenerationEngine:
        return self.engine(tenant_id)  # type: ignore[return-value]
