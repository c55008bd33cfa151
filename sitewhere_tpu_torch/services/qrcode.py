"""Dependency-free QR code generator (ISO/IEC 18004, byte mode).

The reference renders device/asset labels with ZXing's QR symbology
[SURVEY.md §2.2 label-generation]; this image has no barcode library, so
the encoder is implemented here: byte-mode segments, Reed-Solomon error
correction over GF(256), versions 1-6 (up to 106 payload bytes — tokens
and URLs), EC level M, mask pattern 0 with matching BCH format info.
Output is the module matrix (for tests) and an SVG rendering (for the
REST label endpoint), scannable by any standard reader.
"""

from __future__ import annotations

# --- GF(256) arithmetic (polynomial 0x11d) ---------------------------------

_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11d
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def _rs_generator(n: int) -> list[int]:
    """Product of (x - a^i) for i in 0..n-1, monic, highest-degree
    coefficient first (g[0] == 1)."""
    g = [1]
    for i in range(n):
        ng = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            ng[j] ^= c                       # c · x
            ng[j + 1] ^= _gf_mul(c, _EXP[i])  # c · a^i
        g = ng
    return g


def _rs_encode(data: list[int], n_ec: int) -> list[int]:
    gen = _rs_generator(n_ec)
    rem = [0] * n_ec
    for d in data:
        factor = d ^ rem[0]
        rem = rem[1:] + [0]
        if factor:
            for j in range(n_ec):
                rem[j] ^= _gf_mul(gen[j + 1], factor)
    return rem


# --- version tables (EC level M) -------------------------------------------

# version -> (data codewords per block list, ec codewords per block)
_VERSIONS = {
    1: ([16], 10),
    2: ([28], 16),
    3: ([44], 26),
    4: ([32, 32], 18),
    5: ([43, 43], 24),
    6: ([27, 27, 27, 27], 16),
}
_ALIGN = {1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30], 6: [6, 34]}


def _pick_version(n_bytes: int) -> int:
    for v, (blocks, _) in _VERSIONS.items():
        # byte mode header: 4 bits mode + 8 bits count (versions 1-9)
        if sum(blocks) - 2 >= n_bytes:
            return v
    raise ValueError(f"payload of {n_bytes} bytes exceeds QR v6-M capacity")


def _data_codewords(payload: bytes, version: int) -> list[int]:
    blocks, _ = _VERSIONS[version]
    capacity = sum(blocks)
    bits: list[int] = []

    def put(value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            bits.append((value >> i) & 1)

    put(0b0100, 4)                 # byte mode
    put(len(payload), 8)           # count (8 bits for versions 1-9)
    for b in payload:
        put(b, 8)
    put(0, min(4, capacity * 8 - len(bits)))  # terminator
    while len(bits) % 8:
        bits.append(0)
    out = [sum(bit << (7 - i) for i, bit in enumerate(bits[o:o + 8]))
           for o in range(0, len(bits), 8)]
    pads = (0xEC, 0x11)
    i = 0
    while len(out) < capacity:
        out.append(pads[i % 2])
        i += 1
    return out


def _interleave(version: int, data: list[int]) -> list[int]:
    blocks, n_ec = _VERSIONS[version]
    parts, o = [], 0
    for size in blocks:
        parts.append(data[o:o + size])
        o += size
    ecs = [_rs_encode(p, n_ec) for p in parts]
    out: list[int] = []
    for i in range(max(blocks)):
        for p in parts:
            if i < len(p):
                out.append(p[i])
    for i in range(n_ec):
        for e in ecs:
            out.append(e[i])
    return out


# --- matrix construction ----------------------------------------------------

def _bch_format(ec_mask: int) -> int:
    """15-bit format info: 5 data bits + BCH(15,5) + fixed XOR mask."""
    g = 0b10100110111
    value = ec_mask << 10
    rem = value
    for i in range(14, 9, -1):
        if rem & (1 << i):
            rem ^= g << (i - 10)
    return (value | rem) ^ 0b101010000010010


def qr_matrix(payload: bytes) -> list[list[int]]:
    """Encode `payload` → module matrix (1=dark). EC level M, mask 0."""
    version = _pick_version(len(payload))
    size = 17 + 4 * version
    codewords = _interleave(version, _data_codewords(payload, version))

    M = [[-1] * size for _ in range(size)]  # -1 = unset (data area)

    def set_region(r0, c0, pattern):
        for dr, row in enumerate(pattern):
            for dc, v in enumerate(row):
                if 0 <= r0 + dr < size and 0 <= c0 + dc < size:
                    M[r0 + dr][c0 + dc] = v

    finder = [[1] * 7, [1, 0, 0, 0, 0, 0, 1], [1, 0, 1, 1, 1, 0, 1],
              [1, 0, 1, 1, 1, 0, 1], [1, 0, 1, 1, 1, 0, 1],
              [1, 0, 0, 0, 0, 0, 1], [1] * 7]
    for r0, c0 in ((0, 0), (0, size - 7), (size - 7, 0)):
        set_region(r0, c0, finder)
    # separators
    for i in range(8):
        for r, c in ((7, i), (i, 7), (7, size - 8 + i), (i, size - 8),
                     (size - 8, i), (size - 8 + i, 7)):
            if 0 <= r < size and 0 <= c < size and M[r][c] == -1:
                M[r][c] = 0
    # timing
    for i in range(8, size - 8):
        M[6][i] = M[i][6] = (i + 1) % 2
    # alignment patterns (not overlapping finders)
    centers = _ALIGN[version]
    align = [[1] * 5, [1, 0, 0, 0, 1], [1, 0, 1, 0, 1],
             [1, 0, 0, 0, 1], [1] * 5]
    for r in centers:
        for c in centers:
            if M[r][c] == -1:
                set_region(r - 2, c - 2, align)
    # dark module + format info (EC M = 0b00, mask 0)
    M[size - 8][8] = 1
    fmt = _bch_format(0b00 << 3 | 0)
    fbits = [(fmt >> i) & 1 for i in range(14, -1, -1)]
    coords_a = [(8, c) for c in (0, 1, 2, 3, 4, 5, 7, 8)] \
        + [(r, 8) for r in (7, 5, 4, 3, 2, 1, 0)]
    coords_b = [(r, 8) for r in range(size - 1, size - 8, -1)] \
        + [(8, c) for c in range(size - 8, size)]
    for (r, c), bit in zip(coords_a, fbits):
        M[r][c] = bit
    for (r, c), bit in zip(coords_b, fbits):
        M[r][c] = bit

    # zigzag data fill with mask 0 ((r+c) % 2 == 0 flips)
    bits = []
    for cw in codewords:
        for i in range(7, -1, -1):
            bits.append((cw >> i) & 1)
    bit_i = 0
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:  # vertical timing column is skipped entirely
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for c in (col, col - 1):
                if M[r][c] == -1:
                    bit = bits[bit_i] if bit_i < len(bits) else 0
                    bit_i += 1
                    if (r + c) % 2 == 0:
                        bit ^= 1
                    M[r][c] = bit
        upward = not upward
        col -= 2
    return M


def qr_svg(payload: bytes | str, *, module: int = 4,
           quiet: int = 4) -> bytes:
    """Scannable SVG QR for `payload` (UTF-8 if str)."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    M = qr_matrix(payload)
    size = len(M)
    dim = (size + 2 * quiet) * module
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{dim}" '
        f'height="{dim}" viewBox="0 0 {dim} {dim}">',
        f'<rect width="{dim}" height="{dim}" fill="#fff"/>',
        '<path fill="#000" d="',
    ]
    for r, row in enumerate(M):
        for c, v in enumerate(row):
            if v == 1:
                x = (c + quiet) * module
                y = (r + quiet) * module
                parts.append(f"M{x} {y}h{module}v{module}h-{module}z")
    parts.append('"/></svg>')
    return "".join(parts).encode()
