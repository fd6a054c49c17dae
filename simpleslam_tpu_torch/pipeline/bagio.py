"""Recorded-data ingest: ROS1 bag (v2.0) reader/writer + KITTI velodyne.

The reference's primary harness replays real recorded sensor streams from
rosbags (``app/main.cpp:155-207``; bag paths in
``config/params.json:14-17``), converting ROS messages with
``imuFromROS/wheelFromROS/pcFromROS`` (``app/main.cpp:44-73``). This module
is the framework's equivalent ingest edge, with no ROS dependency:

- a from-scratch ROS1 bag format 2.0 parser (records/chunks/connections;
  ``none``, ``bz2`` and ``lz4`` chunk compression — the lz4 frame codec is
  implemented in-module, no lz4 package needed) with hand-rolled deserializers for
  the three message types the reference consumes — ``sensor_msgs/PointCloud2``,
  ``sensor_msgs/Imu``, ``nav_msgs/Odometry`` — plus ``sensor_msgs/NavSatFix``
  for the GPS ground-truth path (``eval/scripts/gps2tum.py``);
- a matching writer (fixture converter), so synthetic sequences can be
  persisted as real bags and the reader is round-trip tested without the
  private reference recordings;
- a KITTI-style velodyne reader (``.bin`` float32 x,y,z,intensity frames +
  ``times.txt``), the standard public recorded-sequence format.

Both readers produce the same ``SensorStreams`` bundle the executors consume,
so ``run_offline``/``run_streamed`` replay recorded data exactly like the
reference's bag mode (blocking backpressure included — the producer thread in
``pipeline/streamed.py`` is the LidarDataProxy role).
"""

from __future__ import annotations

import bz2
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONN = 0x07

# well-known ROS1 md5sums for the message types we write
_MD5 = {
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "sensor_msgs/Imu": "6a62c6daae103f4ff57a132d6f95cec2",
    "nav_msgs/Odometry": "cd5e73d190d741a2f92e81eda573aca7",
    "sensor_msgs/NavSatFix": "2d3a8cd499b9b4a0249fb98fd05cfa48",
}

_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2",
              5: "i4", 6: "u4", 7: "f4", 8: "f8"}


# --------------------------------------------------------------------------
# LZ4 frame codec (pure Python)
# --------------------------------------------------------------------------
#
# rosbag's default chunk compression in most recording tooling is lz4
# (roslz4 emits the standard LZ4 Frame format, magic 0x184D2204); this image
# ships no lz4 module, so the ~100 lines of the spec are implemented here.
# The decoder handles the general frame layout (block checksums and content
# checksums are skipped, not verified); the encoder emits spec-correct
# frames (greedy hash-table block compressor + xxhash32 header checksum) so
# bags we write interoperate with standard readers.

_LZ4_MAGIC = 0x184D2204
_XXH_P1, _XXH_P2, _XXH_P3 = 2654435761, 2246822519, 3266489917
_XXH_P4, _XXH_P5 = 668265263, 374761393
_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _XXH_P1 + _XXH_P2) & _M32
        v2 = (seed + _XXH_P2) & _M32
        v3 = seed
        v4 = (seed - _XXH_P1) & _M32
        while i + 16 <= n:
            for k, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[i + 4 * k:i + 4 * k + 4], "little")
                v = (v + lane * _XXH_P2) & _M32
                v = (_rotl32(v, 13) * _XXH_P1) & _M32
                if k == 0:
                    v1 = v
                elif k == 1:
                    v2 = v
                elif k == 2:
                    v3 = v
                else:
                    v4 = v
            i += 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12)
             + _rotl32(v4, 18)) & _M32
    else:
        h = (seed + _XXH_P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        h = (h + int.from_bytes(data[i:i + 4], "little") * _XXH_P3) & _M32
        h = (_rotl32(h, 17) * _XXH_P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _XXH_P5) & _M32
        h = (_rotl32(h, 11) * _XXH_P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _XXH_P2) & _M32
    h ^= h >> 13
    h = (h * _XXH_P3) & _M32
    h ^= h >> 16
    return h


def _lz4_decompress_block(src: bytes, out: bytearray,
                          max_out: int) -> None:
    """LZ4 block into ``out`` (appended); raises ValueError on corruption.
    ``max_out`` bounds the output so a corrupt match length cannot balloon
    memory (the bag chunk record declares the uncompressed size)."""
    i, n = 0, len(src)
    while i < n:
        if len(out) > max_out:
            raise ValueError("lz4: output exceeds declared size")
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated literal length")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("lz4: truncated literals")
        out += src[i:i + lit]
        i += lit
        if i >= n:
            return  # last sequence: literals only
        if i + 2 > n:
            raise ValueError("lz4: truncated match offset")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        if off == 0 or off > len(out):
            raise ValueError("lz4: bad match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        if len(out) + mlen > max_out:
            raise ValueError("lz4: output exceeds declared size")
        pos = len(out) - off
        if off >= mlen:
            # non-overlapping match (the common case): one slice copy
            out += out[pos:pos + mlen]
        else:
            # overlapping match = periodic repetition of the last ``off``
            # bytes; replicate the period instead of a per-byte loop
            period = bytes(out[pos:])
            reps, rem = divmod(mlen, off)
            out += period * reps + period[:rem]


def lz4_decompress_frame(buf: bytes,
                         max_out: int = 1 << 30) -> bytes:
    """Decode one LZ4 frame (the roslz4 chunk payload format)."""
    if len(buf) < 7 or int.from_bytes(buf[:4], "little") != _LZ4_MAGIC:
        raise ValueError("lz4: bad frame magic")
    flg, bd = buf[4], buf[5]
    if (flg >> 6) != 0b01:
        raise ValueError("lz4: unsupported frame version")
    has_bsum = bool(flg & 0x10)
    has_csize = bool(flg & 0x08)
    has_csum = bool(flg & 0x04)
    has_dict = bool(flg & 0x01)
    del bd
    i = 6 + (8 if has_csize else 0) + (4 if has_dict else 0) + 1  # + HC byte
    out = bytearray()
    while True:
        if i + 4 > len(buf):
            raise ValueError("lz4: truncated block header")
        bsize = int.from_bytes(buf[i:i + 4], "little")
        i += 4
        if bsize == 0:
            break  # EndMark
        raw = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        if i + bsize > len(buf):
            raise ValueError("lz4: truncated block")
        block = buf[i:i + bsize]
        i += bsize
        if has_bsum:
            i += 4  # block checksum (not verified)
        if raw:
            out += block
            if len(out) > max_out:
                raise ValueError("lz4: output exceeds declared size")
        else:
            _lz4_decompress_block(block, out, max_out)
    if has_csum:
        i += 4  # content checksum (not verified)
    return bytes(out)


def _lz4_compress_block(src: bytes) -> bytes:
    """Greedy hash-table LZ4 block compressor (spec-correct, not maximal)."""
    n = len(src)
    out = bytearray()
    table: Dict[int, int] = {}
    anchor = 0
    i = 0
    # spec: last 5 bytes are always literals; matches must not start there
    while i + 12 <= n:
        key = src[i:i + 4]
        h = int.from_bytes(key, "little")
        cand = table.get(h)
        table[h] = i
        if cand is not None and i - cand <= 65535 and src[cand:cand + 4] == key:
            mlen = 4
            limit = n - 5
            while i + mlen < limit and src[cand + mlen] == src[i + mlen]:
                mlen += 1
            lit = i - anchor
            tok_lit = 15 if lit >= 15 else lit
            tok_m = mlen - 4
            tok_mm = 15 if tok_m >= 15 else tok_m
            out.append((tok_lit << 4) | tok_mm)
            rem = lit - 15
            while rem >= 0:
                out.append(min(rem, 255))
                if rem < 255:
                    break
                rem -= 255
            out += src[anchor:i]
            off = i - cand
            out += off.to_bytes(2, "little")
            rem = tok_m - 15
            while rem >= 0:
                out.append(min(rem, 255))
                if rem < 255:
                    break
                rem -= 255
            i += mlen
            anchor = i
        else:
            i += 1
    lit = n - anchor
    tok_lit = 15 if lit >= 15 else lit
    out.append(tok_lit << 4)
    rem = lit - 15
    while rem >= 0:
        out.append(min(rem, 255))
        if rem < 255:
            break
        rem -= 255
    out += src[anchor:]
    return bytes(out)


def lz4_compress_frame(data: bytes) -> bytes:
    """Encode one spec-correct LZ4 frame (64 KB blocks, no checksums except
    the mandatory header checksum byte)."""
    flg = (0b01 << 6) | 0x40 * 0 | 0x20  # version 01, block independence
    bd = 0x40  # block max size 64 KB
    header = bytes([flg, bd])
    hc = (_xxh32(header) >> 8) & 0xFF
    out = bytearray()
    out += _LZ4_MAGIC.to_bytes(4, "little")
    out += header
    out.append(hc)
    for i in range(0, max(len(data), 1), 65536):
        block = data[i:i + 65536]
        if not block:
            break
        comp = _lz4_compress_block(block)
        if len(comp) < len(block):
            out += len(comp).to_bytes(4, "little")
            out += comp
        else:
            out += (len(block) | 0x80000000).to_bytes(4, "little")
            out += block
    out += (0).to_bytes(4, "little")  # EndMark
    return bytes(out)


# --------------------------------------------------------------------------
# message containers (only fields the pipeline consumes)
# --------------------------------------------------------------------------

@dataclass
class PointCloud2:
    stamp: float
    frame_id: str
    xyz: np.ndarray                     # (N, 3) float32
    intensity: Optional[np.ndarray] = None  # (N,) float32

    TYPE = "sensor_msgs/PointCloud2"


@dataclass
class Imu:
    stamp: float
    frame_id: str
    quat: np.ndarray                    # (4,) (w, x, y, z) orientation
    ang_vel: np.ndarray = field(default_factory=lambda: np.zeros(3))
    lin_acc: np.ndarray = field(default_factory=lambda: np.zeros(3))

    TYPE = "sensor_msgs/Imu"


@dataclass
class Odometry:
    stamp: float
    frame_id: str
    child_frame_id: str
    pos: np.ndarray                     # (3,)
    quat: np.ndarray                    # (4,) (w, x, y, z)

    TYPE = "nav_msgs/Odometry"


@dataclass
class NavSatFix:
    stamp: float
    frame_id: str
    lat: float
    lon: float
    alt: float
    status: int = 0                     # STATUS_FIX

    TYPE = "sensor_msgs/NavSatFix"


# --------------------------------------------------------------------------
# primitive (de)serialization
# --------------------------------------------------------------------------

def _w_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _r_str(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    return buf[off + 4: off + 4 + n].decode(errors="replace"), off + 4 + n


def _w_time(t: float) -> bytes:
    secs = int(t)
    return struct.pack("<II", secs, int(round((t - secs) * 1e9)))


def _r_time(buf: bytes, off: int) -> Tuple[float, int]:
    secs, nsecs = struct.unpack_from("<II", buf, off)
    return secs + nsecs * 1e-9, off + 8


def _w_header_msg(stamp: float, frame_id: str, seq: int = 0) -> bytes:
    return struct.pack("<I", seq) + _w_time(stamp) + _w_str(frame_id)


def _r_header_msg(buf: bytes, off: int) -> Tuple[float, str, int]:
    off += 4  # seq
    stamp, off = _r_time(buf, off)
    frame_id, off = _r_str(buf, off)
    return stamp, frame_id, off


def ser_pointcloud2(m: PointCloud2) -> bytes:
    xyz = np.ascontiguousarray(m.xyz, np.float32)
    n = len(xyz)
    has_i = m.intensity is not None
    step = 16 if has_i else 12
    data = np.zeros((n, step // 4), np.float32)
    data[:, :3] = xyz
    if has_i:
        data[:, 3] = np.asarray(m.intensity, np.float32)
    raw = data.tobytes()
    fields = [("x", 0), ("y", 4), ("z", 8)] + ([("intensity", 12)] if has_i else [])
    out = [_w_header_msg(m.stamp, m.frame_id),
           struct.pack("<II", 1, n),                       # height, width
           struct.pack("<I", len(fields))]
    for name, offset in fields:
        out.append(_w_str(name) + struct.pack("<IBI", offset, 7, 1))
    out.append(struct.pack("<BII", 0, step, step * n))     # bigendian, steps
    out.append(struct.pack("<I", len(raw)) + raw)
    out.append(struct.pack("<B", 1))                       # is_dense
    return b"".join(out)


def de_pointcloud2(buf: bytes) -> PointCloud2:
    stamp, frame_id, off = _r_header_msg(buf, 0)
    height, width = struct.unpack_from("<II", buf, off)
    off += 8
    (nf,) = struct.unpack_from("<I", buf, off)
    off += 4
    fields = []
    for _ in range(nf):
        name, off = _r_str(buf, off)
        f_off, dt, cnt = struct.unpack_from("<IBI", buf, off)
        off += 9
        fields.append((name, f_off, dt, cnt))
    bigendian = buf[off]
    off += 1
    point_step, _row_step = struct.unpack_from("<II", buf, off)
    off += 8
    (nbytes,) = struct.unpack_from("<I", buf, off)
    off += 4
    raw = np.frombuffer(buf, np.uint8, nbytes, off).reshape(-1, point_step)
    n = height * width
    end = "<" if not bigendian else ">"

    def col(name):
        for fn, f_off, dt, _ in fields:
            if fn == name:
                dtype = np.dtype(end + _PF_DTYPES[dt])
                col = raw[:n, f_off: f_off + dtype.itemsize].copy()
                return col.view(dtype)[:, 0].astype(np.float32)
        return None

    x, y, z = col("x"), col("y"), col("z")
    if x is None or y is None or z is None:
        raise ValueError("PointCloud2 without x/y/z fields")
    return PointCloud2(stamp, frame_id, np.stack([x, y, z], 1),
                       intensity=col("intensity"))


def ser_imu(m: Imu) -> bytes:
    w, x, y, z = np.asarray(m.quat, np.float64)
    cov = np.zeros(9).tobytes()
    return (_w_header_msg(m.stamp, m.frame_id)
            + struct.pack("<4d", x, y, z, w) + cov
            + struct.pack("<3d", *np.asarray(m.ang_vel, np.float64)) + cov
            + struct.pack("<3d", *np.asarray(m.lin_acc, np.float64)) + cov)


def de_imu(buf: bytes) -> Imu:
    stamp, frame_id, off = _r_header_msg(buf, 0)
    x, y, z, w = struct.unpack_from("<4d", buf, off)
    off += 32 + 72
    av = np.asarray(struct.unpack_from("<3d", buf, off))
    off += 24 + 72
    la = np.asarray(struct.unpack_from("<3d", buf, off))
    return Imu(stamp, frame_id, np.array([w, x, y, z]), av, la)


def ser_odometry(m: Odometry) -> bytes:
    w, x, y, z = np.asarray(m.quat, np.float64)
    cov36 = np.zeros(36).tobytes()
    return (_w_header_msg(m.stamp, m.frame_id) + _w_str(m.child_frame_id)
            + struct.pack("<3d", *np.asarray(m.pos, np.float64))
            + struct.pack("<4d", x, y, z, w) + cov36
            + struct.pack("<6d", *np.zeros(6)) + cov36)


def de_odometry(buf: bytes) -> Odometry:
    stamp, frame_id, off = _r_header_msg(buf, 0)
    child, off = _r_str(buf, off)
    px, py, pz, x, y, z, w = struct.unpack_from("<7d", buf, off)
    return Odometry(stamp, frame_id, child,
                    np.array([px, py, pz]), np.array([w, x, y, z]))


def ser_navsatfix(m: NavSatFix) -> bytes:
    # status: NavSatStatus {int8 status, uint16 service}
    return (_w_header_msg(m.stamp, m.frame_id)
            + struct.pack("<bH", m.status, 1)
            + struct.pack("<3d", m.lat, m.lon, m.alt)
            + np.zeros(9).tobytes() + struct.pack("<B", 0))


def de_navsatfix(buf: bytes) -> NavSatFix:
    stamp, frame_id, off = _r_header_msg(buf, 0)
    status, _svc = struct.unpack_from("<bH", buf, off)
    lat, lon, alt = struct.unpack_from("<3d", buf, off + 3)
    return NavSatFix(stamp, frame_id, lat, lon, alt, status)


_SER = {PointCloud2: ser_pointcloud2, Imu: ser_imu, Odometry: ser_odometry,
        NavSatFix: ser_navsatfix}
_DE = {"sensor_msgs/PointCloud2": de_pointcloud2,
       "sensor_msgs/Imu": de_imu,
       "nav_msgs/Odometry": de_odometry,
       "sensor_msgs/NavSatFix": de_navsatfix}


# --------------------------------------------------------------------------
# bag records
# --------------------------------------------------------------------------

def _w_fields(fields: Dict[str, bytes]) -> bytes:
    out = []
    for k, v in fields.items():
        kv = k.encode() + b"=" + v
        out.append(struct.pack("<I", len(kv)) + kv)
    return b"".join(out)


def _w_record(fields: Dict[str, bytes], data: bytes) -> bytes:
    hdr = _w_fields(fields)
    return (struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", len(data)) + data)


def _r_fields(hdr: bytes) -> Dict[str, bytes]:
    fields: Dict[str, bytes] = {}
    off = 0
    while off < len(hdr):
        if off + 4 > len(hdr):
            raise ValueError("truncated field length")
        (n,) = struct.unpack_from("<I", hdr, off)
        if off + 4 + n > len(hdr):
            raise ValueError("field runs past header end")
        kv = hdr[off + 4: off + 4 + n]
        off += 4 + n
        k, _, v = kv.partition(b"=")
        fields[k.decode(errors="replace")] = v
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    """Iterate <hlen, header, dlen, data> records; raises ValueError on a
    record that runs past the end of ``buf`` (truncated/corrupt input must
    fail cleanly, not parse garbage — tests/test_bagio_golden.py fuzzes
    this path)."""
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        if off + 4 + hlen + 4 > n:
            raise ValueError("truncated record header")
        fields = _r_fields(buf[off + 4: off + 4 + hlen])
        off += 4 + hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        if off + 4 + dlen > n:
            raise ValueError("truncated record data")
        data = buf[off + 4: off + 4 + dlen]
        off += 4 + dlen
        yield fields, data
    if off != n:
        raise ValueError("trailing garbage after last record")


def write_bag(path: str, messages: Sequence[Tuple[str, object, float]],
              chunk_msgs: int = 256, compression: str = "none") -> None:
    """Write ``(topic, msg, t_sec)`` tuples as a ROS1 v2.0 bag.

    Standard enough for the framework's own reader and for rosbag tooling:
    bag header, chunks (``none``/``bz2``/``lz4`` compression) with embedded
    connection records, per-chunk index records, then trailing connection +
    chunk-info records.
    """
    if compression not in ("none", "bz2", "lz4"):
        raise ValueError(f"unsupported compression {compression!r}")
    msgs = sorted(messages, key=lambda m: m[2])
    conns: Dict[str, int] = {}
    conn_recs: List[bytes] = []
    for topic, msg, _ in msgs:
        if topic not in conns:
            cid = len(conns)
            conns[topic] = cid
            mtype = type(msg).TYPE
            conn_data = _w_fields({
                "topic": topic.encode(),
                "type": mtype.encode(),
                "md5sum": _MD5[mtype].encode(),
                "message_definition": b"",
            })
            conn_recs.append(_w_record(
                {"op": bytes([_OP_CONN]),
                 "conn": struct.pack("<I", cid),
                 "topic": topic.encode()}, conn_data))

    with open(path, "wb") as f:
        f.write(MAGIC)
        # bag header record padded to 4096 bytes total
        hdr_fields = {"op": bytes([_OP_BAGHDR]),
                      "index_pos": struct.pack("<Q", 0),
                      "conn_count": struct.pack("<I", len(conns)),
                      "chunk_count": struct.pack(
                          "<I", (len(msgs) + chunk_msgs - 1) // max(chunk_msgs, 1))}
        hdr = _w_fields(hdr_fields)
        pad = 4096 - 8 - len(hdr)
        f.write(struct.pack("<I", len(hdr)) + hdr
                + struct.pack("<I", pad) + b" " * pad)

        chunk_infos = []  # (pos, t0, t1, {conn: count})
        for lo in range(0, len(msgs), chunk_msgs):
            batch = msgs[lo: lo + chunk_msgs]
            parts = list(conn_recs) if lo == 0 else []
            counts: Dict[int, int] = {}
            index: Dict[int, List[Tuple[float, int]]] = {}
            base = sum(len(p) for p in parts)
            for topic, msg, t in batch:
                cid = conns[topic]
                rec = _w_record(
                    {"op": bytes([_OP_MSG]),
                     "conn": struct.pack("<I", cid),
                     "time": _w_time(t)}, _SER[type(msg)](msg))
                index.setdefault(cid, []).append((t, base))
                counts[cid] = counts.get(cid, 0) + 1
                parts.append(rec)
                base += len(rec)
            chunk_data = b"".join(parts)
            pos = f.tell()
            if compression == "bz2":
                payload = bz2.compress(chunk_data)
            elif compression == "lz4":
                payload = lz4_compress_frame(chunk_data)
            else:
                payload = chunk_data
            f.write(_w_record(
                {"op": bytes([_OP_CHUNK]),
                 "compression": compression.encode(),
                 "size": struct.pack("<I", len(chunk_data))}, payload))
            for cid, entries in index.items():
                idx_data = b"".join(
                    _w_time(t) + struct.pack("<I", off) for t, off in entries)
                f.write(_w_record(
                    {"op": bytes([_OP_INDEX]), "ver": struct.pack("<I", 1),
                     "conn": struct.pack("<I", cid),
                     "count": struct.pack("<I", len(entries))}, idx_data))
            chunk_infos.append((pos, batch[0][2], batch[-1][2], counts))

        index_pos = f.tell()
        for rec in conn_recs:
            f.write(rec)
        for pos, t0, t1, counts in chunk_infos:
            info_data = b"".join(
                struct.pack("<II", cid, c) for cid, c in counts.items())
            f.write(_w_record(
                {"op": bytes([_OP_CHUNKINFO]), "ver": struct.pack("<I", 1),
                 "chunk_pos": struct.pack("<Q", pos),
                 "start_time": _w_time(t0), "end_time": _w_time(t1),
                 "count": struct.pack("<I", len(counts))}, info_data))

        # backpatch index_pos in the bag header
        f.seek(len(MAGIC))
        hdr_fields["index_pos"] = struct.pack("<Q", index_pos)
        hdr = _w_fields(hdr_fields)
        f.write(struct.pack("<I", len(hdr)) + hdr)


def read_bag(path: str, topics: Optional[Sequence[str]] = None
             ) -> Iterator[Tuple[str, object, float]]:
    """Yield ``(topic, msg, t_sec)`` in stored order (chunk-sequential).

    Supports ``none``/``bz2``/``lz4`` chunk compression and the four message
    types above; unknown types/topics are skipped silently (the reference's
    replay loop also dispatches only the topics it knows,
    app/main.cpp:168-199).
    """
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a ROS1 v2.0 bag")
        buf = f.read()
    want = set(topics) if topics is not None else None
    conns: Dict[int, Tuple[str, str]] = {}  # cid -> (topic, type)

    def handle(fields: Dict[str, bytes], data: bytes):
        op = fields["op"][0]
        if op == _OP_CONN:
            (cid,) = struct.unpack("<I", fields["conn"])
            info = _r_fields(data)
            conns[cid] = (info.get("topic", fields.get("topic", b"")).decode(),
                          info.get("type", b"").decode())
        elif op == _OP_MSG:
            (cid,) = struct.unpack("<I", fields["conn"])
            t, _ = _r_time(fields["time"], 0)
            topic, mtype = conns.get(cid, ("", ""))
            if want is not None and topic not in want:
                return None
            de = _DE.get(mtype)
            if de is None:
                return None
            return topic, de(data), t
        return None

    try:
        for fields, data in _iter_records(buf):
            if "op" not in fields or len(fields["op"]) < 1:
                raise ValueError("record without op field")
            op = fields["op"][0]
            if op == _OP_CHUNK:
                comp = fields.get("compression", b"none")
                if comp == b"bz2":
                    payload = bz2.decompress(data)
                elif comp == b"lz4":
                    declared = fields.get("size")
                    max_out = (struct.unpack("<I", declared)[0]
                               if declared and len(declared) == 4
                               else 1 << 30)
                    payload = lz4_decompress_frame(data, max_out)
                elif comp == b"none":
                    payload = data
                else:
                    raise ValueError(
                        f"unsupported chunk compression {comp!r}")
                for ifields, idata in _iter_records(payload):
                    out = handle(ifields, idata)
                    if out is not None:
                        yield out
            elif op in (_OP_CONN, _OP_MSG):
                out = handle(fields, data)
                if out is not None:
                    yield out
    except (struct.error, KeyError, IndexError, OSError, EOFError) as e:
        # corrupt/truncated input must surface as ONE clean error type,
        # never a random low-level exception or a hang
        raise ValueError(f"corrupt bag: {e}") from e


# --------------------------------------------------------------------------
# SensorStreams bridges
# --------------------------------------------------------------------------

def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w > 1e-6:
        return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                         (R[0, 2] - R[2, 0]) / (4 * w),
                         (R[1, 0] - R[0, 1]) / (4 * w)])
    # fallback for 180-degree rotations
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1e-12, 1 + R[i, i] - R[j, j] - R[k, k])) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = s / 4
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def streams_from_bag(path: str, scan_topic: str, wheel_topic: str = "",
                     imu_topic: str = ""):
    """Replay a bag into the executors' ``SensorStreams`` bundle.

    The reference's topic wiring (config/params.json "lidar"/"wheel"/"imu"
    keys, app/main.cpp:163-199). gt_poses are identity (recorded data has no
    inline ground truth; evaluation uses the GPS path, eval/gps.py).
    """
    from . import simulate as sim

    topics = {t for t in (scan_topic, wheel_topic, imu_topic) if t}
    scan_stamps, scans = [], []
    wheel_stamps, wheel_poses = [], []
    imu_stamps, imu_quats = [], []
    for topic, msg, t in read_bag(path, topics):
        if topic == scan_topic and isinstance(msg, PointCloud2):
            xyz = msg.xyz
            keep = np.isfinite(xyz).all(axis=1)  # NaN strip (pcp role)
            scan_stamps.append(msg.stamp or t)
            scans.append(np.ascontiguousarray(xyz[keep]))
        elif topic == wheel_topic and isinstance(msg, Odometry):
            T = np.eye(4)
            T[:3, :3] = _quat_to_rot(msg.quat)
            T[:3, 3] = msg.pos
            wheel_stamps.append(msg.stamp or t)
            wheel_poses.append(T)
        elif topic == imu_topic and isinstance(msg, Imu):
            imu_stamps.append(msg.stamp or t)
            imu_quats.append(msg.quat)
    if not scans:
        raise ValueError(f"{path}: no PointCloud2 messages on '{scan_topic}'")
    n = len(scans)
    return sim.SensorStreams(
        np.asarray(scan_stamps), scans,
        np.tile(np.eye(4), (n, 1, 1)),
        np.asarray(wheel_stamps),
        np.stack(wheel_poses) if wheel_poses else np.zeros((0, 4, 4)),
        np.asarray(imu_stamps),
        np.stack(imu_quats) if imu_quats else np.zeros((0, 4)))


def bag_from_streams(streams, path: str, scan_topic: str = "/lidar_points",
                     wheel_topic: str = "/wheel_odom",
                     imu_topic: str = "/imu",
                     compression: str = "none") -> None:
    """Fixture converter: persist a (synthetic) sequence as a real bag, its
    chunks compressed as ``write_bag`` names them (``none``, ``bz2``,
    ``lz4``)."""
    msgs: List[Tuple[str, object, float]] = []
    for i, t in enumerate(np.asarray(streams.scan_stamps, np.float64)):
        msgs.append((scan_topic,
                     PointCloud2(float(t), "lidar",
                                 np.asarray(streams.scans[i], np.float32)),
                     float(t)))
    for i, t in enumerate(np.asarray(streams.wheel_stamps, np.float64)):
        T = streams.wheel_poses[i]
        msgs.append((wheel_topic,
                     Odometry(float(t), "odom", "base",
                              T[:3, 3].copy(), _rot_to_quat(T[:3, :3])),
                     float(t)))
    for i, t in enumerate(np.asarray(streams.imu_stamps, np.float64)):
        msgs.append((imu_topic,
                     Imu(float(t), "imu", np.asarray(streams.imu_quats[i])),
                     float(t)))
    write_bag(path, msgs, compression=compression)


def kitti_streams(velodyne_dir: str, times_file: Optional[str] = None,
                  max_scans: Optional[int] = None, rate_hz: float = 10.0):
    """Read a KITTI-style velodyne sequence directory of ``.bin`` frames.

    Each frame is float32 (N, 4) x,y,z,reflectance. ``times.txt`` (one float
    per line) supplies stamps when present; otherwise a fixed ``rate_hz``
    clock. Returns ``SensorStreams`` (lidar-only: lo mode).
    """
    from . import simulate as sim

    names = sorted(f for f in os.listdir(velodyne_dir) if f.endswith(".bin"))
    if max_scans is not None:
        names = names[:max_scans]
    if not names:
        raise ValueError(f"{velodyne_dir}: no .bin frames")
    scans = []
    for name in names:
        raw = np.fromfile(os.path.join(velodyne_dir, name), np.float32)
        scans.append(raw.reshape(-1, 4)[:, :3].copy())
    if times_file is None:
        cand = os.path.join(os.path.dirname(velodyne_dir.rstrip("/")),
                            "times.txt")
        times_file = cand if os.path.exists(cand) else None
    if times_file:
        stamps = np.loadtxt(times_file, dtype=np.float64)[: len(scans)]
    else:
        stamps = np.arange(len(scans), dtype=np.float64) / rate_hz
    n = len(scans)
    return sim.SensorStreams(
        stamps, scans, np.tile(np.eye(4), (n, 1, 1)),
        np.zeros(0), np.zeros((0, 4, 4)), np.zeros(0), np.zeros((0, 4)))
