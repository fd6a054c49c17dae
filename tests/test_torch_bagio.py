"""The port's own copy of the recorded-data ingest (``pipeline/bagio.py``)
against the JAX package's: the cases of tests/test_bagio.py and
tests/test_bagio_golden.py on the copy, plus the two packages held against
each other: the golden bag read to the same arrays, a bag written by one
read by the other, and byte-equal files from the two writers for the same
messages (the codecs are numpy and struct only, so equality is exact).
"""

import bz2
import os
import struct

import numpy as np
import pytest

from simpleslam_tpu.pipeline import bagio as jbag
from simpleslam_tpu_torch.pipeline import bagio as tbag
from simpleslam_tpu_torch.pipeline import simulate as sim

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_indexed.bag")
TOPICS = ("/lidar_points", "/wheel_odom", "/imu")


@pytest.fixture(scope="module")
def streams():
    world = sim.make_world(seed=0)
    return sim.simulate_sequence(world, n_scans=6, seed=0, n_az=360, n_el=8)


def _assert_streams_equal(back, streams, exact=False):
    tol = 0.0 if exact else 1e-9
    np.testing.assert_allclose(back.scan_stamps, streams.scan_stamps,
                               atol=tol)
    assert len(back.scans) == len(streams.scans)
    for a, b in zip(back.scans, streams.scans):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   atol=0.0 if exact else 1e-6)
    np.testing.assert_allclose(back.wheel_stamps, streams.wheel_stamps,
                               atol=tol)
    np.testing.assert_allclose(back.wheel_poses, streams.wheel_poses,
                               atol=0.0 if exact else 1e-6)
    np.testing.assert_allclose(back.imu_stamps, streams.imu_stamps, atol=tol)
    if exact:
        np.testing.assert_array_equal(back.imu_quats, streams.imu_quats)
    else:  # quaternions match up to sign
        dots = np.abs(np.einsum("ij,ij->i", back.imu_quats,
                                streams.imu_quats))
        np.testing.assert_allclose(
            dots, np.linalg.norm(streams.imu_quats, axis=1) ** 2, atol=1e-6)


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_roundtrip(tmp_path, streams, compression):
    path = str(tmp_path / "seq.bag")
    tbag.bag_from_streams(streams, path, compression=compression)
    back = tbag.streams_from_bag(path, *TOPICS)
    _assert_streams_equal(back, streams)
    np.testing.assert_array_equal(back.gt_poses,
                                  np.tile(np.eye(4), (len(back.scans), 1, 1)))


def test_bag_message_order_and_topics(tmp_path, streams):
    path = str(tmp_path / "seq.bag")
    tbag.bag_from_streams(streams, path)
    msgs = list(tbag.read_bag(path))
    stamps = [t for _, _, t in msgs]
    assert stamps == sorted(stamps)
    assert {topic for topic, _, _ in msgs} == set(TOPICS)
    only = list(tbag.read_bag(path, topics=["/imu"]))
    assert all(t == "/imu" for t, _, _ in only)
    assert len(only) == len(streams.imu_stamps)


def test_bag_bz2_recompressed_chunks(tmp_path, streams):
    """Reader handles chunks recompressed as bz2 outside the writer."""
    plain = str(tmp_path / "plain.bag")
    tbag.bag_from_streams(streams, plain)
    with open(plain, "rb") as f:
        assert f.read(len(tbag.MAGIC)) == tbag.MAGIC
        buf = f.read()
    out = [tbag.MAGIC]
    for fields, data in tbag._iter_records(buf):
        if fields["op"][0] == tbag._OP_CHUNK:
            out.append(tbag._w_record(
                {"op": bytes([tbag._OP_CHUNK]), "compression": b"bz2",
                 "size": struct.pack("<I", len(data))}, bz2.compress(data)))
        else:
            out.append(tbag._w_record(fields, data))
    packed = str(tmp_path / "packed.bag")
    with open(packed, "wb") as f:
        f.write(b"".join(out))
    a = list(tbag.read_bag(plain))
    b = list(tbag.read_bag(packed))
    assert len(a) == len(b) > 0
    for (ta, ma, sa), (tb, mb, sb) in zip(a, b):
        assert ta == tb and sa == sb and type(ma) is type(mb)


def test_navsatfix_roundtrip(tmp_path):
    msgs = [("/gps", tbag.NavSatFix(float(i), "gps", 30.0 + i * 1e-5,
                                    114.0, 10.0, status=2), float(i))
            for i in range(5)]
    path = str(tmp_path / "gps.bag")
    tbag.write_bag(path, msgs)
    back = list(tbag.read_bag(path))
    assert len(back) == 5
    for i, (topic, m, _) in enumerate(back):
        assert topic == "/gps"
        assert m.lat == pytest.approx(30.0 + i * 1e-5)
        assert m.status == 2


def _write_kitti(seq, streams, n):
    vdir = seq / "velodyne"
    os.makedirs(vdir)
    for i, scan in enumerate(streams.scans[:n]):
        arr = np.zeros((len(scan), 4), np.float32)
        arr[:, :3] = scan
        arr.tofile(str(vdir / f"{i:06d}.bin"))
    with open(seq / "times.txt", "w") as f:
        for t in streams.scan_stamps[:n]:
            f.write(f"{t:.6f}\n")
    return str(vdir)


def test_kitti_directory_roundtrip(tmp_path, streams):
    vdir = _write_kitti(tmp_path / "00", streams, 4)
    got = tbag.kitti_streams(vdir)
    ref = jbag.kitti_streams(vdir)
    assert len(got.scans) == 4 and len(got.wheel_stamps) == 0
    np.testing.assert_allclose(got.scan_stamps, streams.scan_stamps[:4],
                               atol=1e-6)
    for i in range(4):
        np.testing.assert_array_equal(
            got.scans[i], np.asarray(streams.scans[i], np.float32))
        np.testing.assert_array_equal(got.scans[i], ref.scans[i])
    np.testing.assert_array_equal(got.scan_stamps, ref.scan_stamps)
    assert len(tbag.kitti_streams(vdir, max_scans=2).scans) == 2
    with pytest.raises(ValueError, match="no .bin frames"):
        tbag.kitti_streams(str(tmp_path))


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------

def _assert_msgs_equal(got, want):
    assert len(got) == len(want) > 0
    for (tg, mg, sg), (tw, mw, sw) in zip(got, want):
        assert tg == tw and sg == sw
        assert type(mg).__name__ == type(mw).__name__
        for name, value in vars(mw).items():
            other = getattr(mg, name)
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(other, value)
            else:
                assert other == value


def test_golden_bag_reads_like_the_reference():
    """The checked-in bag of an independent generator (padded header,
    repeated and latched connections, none + bz2 + lz4 chunks)."""
    got = list(tbag.read_bag(GOLDEN))
    _assert_msgs_equal(got, list(jbag.read_bag(GOLDEN)))
    assert len(got) == 7
    assert sorted(s for _, _, s in got) == [10.0, 10.5, 11.0, 12.0, 12.25,
                                            13.0, 13.5]
    rng = np.random.default_rng(7)
    clouds = [rng.normal(size=(50, 3)).astype(np.float32) for _ in range(4)]
    pcs = [m for t, m, _ in got if t == "/points_latched"]
    for have, want in zip(pcs, clouds):
        np.testing.assert_allclose(have.xyz, want, rtol=1e-6)
    only = list(tbag.read_bag(GOLDEN, topics=["/imu"]))
    assert len(only) == 3 and all(t == "/imu" for t, _, _ in only)


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_writers_are_byte_equal(tmp_path, streams, compression):
    """The same messages through both ``write_bag``s give the same file."""
    msgs = list(jbag.read_bag(GOLDEN))
    tmsgs = list(tbag.read_bag(GOLDEN))
    a, b = str(tmp_path / "j.bag"), str(tmp_path / "t.bag")
    jbag.write_bag(a, msgs, chunk_msgs=3, compression=compression)
    tbag.write_bag(b, tmsgs, chunk_msgs=3, compression=compression)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    if compression == "none":
        jbag.bag_from_streams(streams, a)
        tbag.bag_from_streams(streams, b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bag_of_one_package_read_by_the_other(tmp_path, streams, writer):
    path = str(tmp_path / "seq.bag")
    w, r = (jbag, tbag) if writer == "reference" else (tbag, jbag)
    w.bag_from_streams(streams, path)
    _assert_streams_equal(r.streams_from_bag(path, *TOPICS),
                          w.streams_from_bag(path, *TOPICS), exact=True)


# ---------------------------------------------------------------------------
# the in-module LZ4 frame codec and the reader's robustness
# ---------------------------------------------------------------------------

def test_lz4_codec_roundtrip():
    assert tbag._xxh32(b"") == 0x02CC5D05
    assert tbag._xxh32(b"a") == 0x550D7456
    assert tbag._xxh32(b"abc") == 0x32D153FF
    rng = np.random.default_rng(3)
    for n in (0, 1, 17, 1000, 65536, 70001):
        data = bytes(rng.integers(0, 40, n, dtype=np.uint8))  # compressible
        frame = tbag.lz4_compress_frame(data)
        assert frame == jbag.lz4_compress_frame(data)
        assert tbag.lz4_decompress_frame(frame) == data
    rep = b"the spammish repetition " * 2048
    frame = tbag.lz4_compress_frame(rep)
    assert len(frame) < len(rep) // 10
    assert tbag.lz4_decompress_frame(frame) == rep


def test_lz4_frame_truncation_fuzz():
    """Truncated or corrupt frames raise ValueError, never hang or throw a
    low-level exception."""
    rng = np.random.default_rng(5)
    data = bytes(rng.integers(0, 30, 20000, dtype=np.uint8))
    frame = tbag.lz4_compress_frame(data)
    for cut in list(range(0, len(frame), 97)) + [len(frame) - 1]:
        try:
            tbag.lz4_decompress_frame(frame[:cut])
        except ValueError:
            pass
    buf = bytearray(frame)
    for _ in range(60):
        pos = int(rng.integers(0, len(buf)))
        old = buf[pos]
        buf[pos] ^= 0xFF
        try:
            tbag.lz4_decompress_frame(bytes(buf))
        except ValueError:
            pass
        buf[pos] = old


@pytest.mark.parametrize("kind", ["truncation", "corruption"])
def test_reader_fuzz(tmp_path, kind):
    """Every truncation point and every flipped byte either parses or raises
    ValueError."""
    raw = bytearray(open(GOLDEN, "rb").read())
    p = tmp_path / "f.bag"
    if kind == "truncation":
        cases = [bytes(raw[:cut]) for cut in
                 list(range(0, len(raw), 173)) + [len(raw) - 1]]
    else:
        rng = np.random.default_rng(0)
        cases = []
        for _ in range(60):
            pos = int(rng.integers(0, len(raw)))
            flipped = bytearray(raw)
            flipped[pos] ^= 0xFF
            cases.append(bytes(flipped))
    for data in cases:
        p.write_bytes(data)
        try:
            list(tbag.read_bag(str(p)))
        except ValueError:
            pass


def test_unknown_compression_is_refused(tmp_path, streams):
    with pytest.raises(ValueError, match="unsupported compression"):
        tbag.bag_from_streams(streams, str(tmp_path / "x.bag"),
                              compression="zstd")
