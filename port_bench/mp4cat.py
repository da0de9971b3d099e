"""Join MP4 files of one video track, written one after another by the same
writer, into one MP4: the clip's parts are encoded on several threads
(``cv2.VideoWriter`` releases the interpreter lock while it encodes), then
joined here without decoding.

Each part starts on a keyframe and has the same sample description
(codec, size and decoder configuration; the bitrates it states may
differ), one constant frame duration and no composition offsets; anything
else is refused. The result is
``ftyp``, ``moov`` (the first part's, its tables rebuilt: one sample per
chunk) and ``mdat``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}


def _parse(buf: bytes, start: int, end: int) -> List[list]:
    out, off = [], start
    while off + 8 <= end:
        size, kind = struct.unpack(">I4s", buf[off:off + 8])
        if size < 8 or off + size > end:
            raise ValueError(f"unsupported box {kind!r} of size {size}")
        body = buf[off + 8:off + size]
        out.append([kind, _parse(buf, off + 8, off + size)
                    if kind in _CONTAINERS else body])
        off += size
    return out


def _build(boxes: List[list]) -> bytes:
    parts = []
    for kind, body in boxes:
        data = _build(body) if isinstance(body, list) else body
        parts.append(struct.pack(">I4s", len(data) + 8, kind) + data)
    return b"".join(parts)


def _find(boxes: List[list], *path: bytes) -> list:
    """The box at ``path`` itself (``[kind, body]``, edited in place)."""
    for box in boxes:
        if box[0] == path[0]:
            return box if len(path) == 1 else _find(box[1], *path[1:])
    raise ValueError(f"no box {path[0]!r}")


def _table(body: bytes, width: int) -> List[Tuple[int, ...]]:
    (n,) = struct.unpack(">I", body[4:8])
    fmt = ">" + "I" * width
    return [struct.unpack(fmt, body[8 + i * 4 * width:8 + (i + 1) * 4
                                    * width]) for i in range(n)]


def _full(entries, fmt: str) -> bytes:
    return struct.pack(">II", 0, len(entries)) + b"".join(
        struct.pack(fmt, *e) for e in entries)


def _samples(path: str) -> Dict:
    with open(path, "rb") as fh:
        buf = fh.read()
    top = _parse(buf, 0, len(buf))
    moov = _find(top, b"moov")
    stbl = _find(moov[1], b"trak", b"mdia", b"minf", b"stbl")[1]
    names = {k for k, _ in stbl}
    if b"ctts" in names or b"co64" in names:
        raise ValueError(f"{path}: composition offsets or 64-bit offsets")
    tabs = {k: v for k, v in stbl}
    stts = _table(tabs[b"stts"], 2)
    if len(stts) != 1:
        raise ValueError(f"{path}: frame durations differ")
    size0, count = struct.unpack(">II", tabs[b"stsz"][4:12])
    sizes = ([size0] * count if size0 else
             list(struct.unpack(f">{count}I", tabs[b"stsz"][12:12 + 4 * count])))
    chunks = [c[0] for c in _table(tabs[b"stco"], 1)]
    stsc = _table(tabs[b"stsc"], 3)
    data, k = [], 0
    for ci, off in enumerate(chunks, start=1):
        per = [e[1] for e in stsc if e[0] <= ci][-1]
        for _ in range(per):
            data.append(buf[off:off + sizes[k]])
            off += sizes[k]
            k += 1
    sync = [s[0] for s in _table(tabs[b"stss"], 1)] if b"stss" in tabs \
        else list(range(1, count + 1))
    return {"top": top, "moov": moov, "stsd": tabs[b"stsd"],
            "delta": stts[0][1], "data": data, "sync": sync}


def _set_duration(body: bytes, duration: int, at: Tuple[int, int]) -> bytes:
    """Overwrite the duration field of an ``mvhd``/``tkhd``/``mdhd`` body
    (offsets for version 0 and 1)."""
    v0, v1 = at
    if body[0] == 1:
        return body[:v1] + struct.pack(">Q", duration) + body[v1 + 8:]
    return body[:v0] + struct.pack(">I", duration) + body[v0 + 4:]


def _config(stsd: bytes) -> bytes:
    """The sample description without its bitrate fields (which each part
    states for itself): the bytes before the decoder configuration's
    descriptor, and the decoder-specific information (from the first
    start code to the SL configuration descriptor)."""
    at = stsd.find(b"\x00\x00\x01\xb0")
    end = stsd.find(b"\x06\x80\x80\x80\x01", at)
    if at < 0 or end < 0:
        return stsd
    return stsd[:stsd.rfind(b"\x04\x80\x80\x80", 0, at)] + stsd[at:end]


def _gov_at(sample: bytes, seconds: int) -> bytes:
    """An MPEG-4 Part 2 sample that opens with a group-of-VOPs header,
    its time code set to ``seconds`` (the decoder times the group's frames
    from it, so a part encoded alone would restart the clock at 0)."""
    if not sample.startswith(b"\x00\x00\x01\xb3"):
        raise ValueError("a part does not open with a group-of-VOPs header")
    h, rest = divmod(int(seconds), 3600)
    m, sec = divmod(rest, 60)
    bits = (h << 13) | (m << 7) | (1 << 6) | sec          # 18 bits
    old = int.from_bytes(sample[4:7], "big")
    new = (bits << 6) | (old & 0x3F)
    return sample[:4] + new.to_bytes(3, "big") + sample[7:]


def join(paths: List[str], out: str, starts: List[int] = ()) -> None:
    """``starts``: each part's first frame time in whole seconds, written
    into its group-of-VOPs header (MPEG-4 Part 2 parts)."""
    parts = [_samples(p) for p in paths]
    for p, sec in zip(parts, starts):
        p["data"][0] = _gov_at(p["data"][0], sec)
    first = parts[0]
    for p, path in zip(parts, paths):
        if _config(p["stsd"]) != _config(first["stsd"]) \
                or p["delta"] != first["delta"]:
            raise ValueError(f"{path}: another sample description")
        if p["sync"][:1] != [1]:
            raise ValueError(f"{path}: does not start on a keyframe")
    data, sync = [], []
    for p in parts:
        sync += [len(data) + s for s in p["sync"]]
        data += p["data"]
    n = len(data)
    moov = first["moov"]
    trak = _find(moov[1], b"trak")[1]
    mdia = _find(trak, b"mdia")[1]
    stbl = _find(mdia, b"minf", b"stbl")[1]
    mvhd, tkhd, mdhd = (_find(moov[1], b"mvhd"), _find(trak, b"tkhd"),
                        _find(mdia, b"mdhd"))
    media_scale = struct.unpack(">I", mdhd[1][12:16] if mdhd[1][0] == 0
                                else mdhd[1][20:24])[0]
    movie_scale = struct.unpack(">I", mvhd[1][12:16] if mvhd[1][0] == 0
                                else mvhd[1][20:24])[0]
    media = n * first["delta"]
    movie = media * movie_scale // media_scale
    mdhd[1] = _set_duration(mdhd[1], media, (16, 24))
    mvhd[1] = _set_duration(mvhd[1], movie, (16, 24))
    tkhd[1] = _set_duration(tkhd[1], movie, (20, 28))
    for box in trak:
        if box[0] == b"edts":
            elst = _find(box[1], b"elst")
            ver = elst[1][0]
            entries = _table(elst[1], 3 if ver == 0 else 5)
            if ver != 0 or len(entries) != 1:
                raise ValueError("unsupported edit list")
            elst[1] = _full([(movie, entries[0][1], entries[0][2])], ">III")
    stbl[:] = [[b"stsd", first["stsd"]],
               [b"stts", _full([(n, first["delta"])], ">II")],
               [b"stss", _full([(s,) for s in sync], ">I")],
               [b"stsc", _full([(1, 1, 1)], ">III")],
               [b"stsz", struct.pack(">III", 0, 0, n) + b"".join(
                   struct.pack(">I", len(d)) for d in data)],
               [b"stco", _full([(0,)] * n, ">I")]]
    ftyp = _build([_find(first["top"], b"ftyp")])
    head = len(ftyp) + len(_build([moov])) + 8
    offsets, at = [], head
    for d in data:
        offsets.append((at,))
        at += len(d)
    if at >= 2**32:
        raise ValueError("clip too large for 32-bit chunk offsets")
    stbl[-1] = [b"stco", _full(offsets, ">I")]
    payload = b"".join(data)
    with open(out, "wb") as fh:
        fh.write(ftyp)
        fh.write(_build([moov]))
        fh.write(struct.pack(">I4s", len(payload) + 8, b"mdat"))
        fh.write(payload)
