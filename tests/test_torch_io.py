"""The port's data layer against the JAX package's, on the same numpy data
made from a seed: ``io/binfile.py``, ``io/textfile.py``, ``io/image.py``,
``io/loader.py``, ``snapshot.py``, ``image_tool.py`` and ``data.py``.

* BinFile files are byte-identical between the packages, both ways,
  through the native codec (each package builds ``native/singa_io.cpp``
  its own way: the port into ``singa_tpu_torch/_build/``) and the
  pure-Python codec, and each package reads the other's;
* a truncated tail record and a CRC flip raise ``CorruptRecordError``
  naming the key and the record's offset, through either codec;
* text files are byte-identical both ways;
* a ``Snapshot`` written by either package reads back in the other, bf16
  included (the JAX package reads bf16 through ``ml_dtypes``, the port
  as the raw bits);
* ``DataLoader(num_workers=1)`` yields the JAX loader's batches for a
  seed, two epochs (the seed rises by one an epoch);
* ``augment_batch`` equals the JAX package's in eval and train mode, both
  through the shared native source; the per-image transforms, the
  ``ImageTool`` chain, ``ImageBatchIter`` and ``train_test_split`` equal
  theirs under the same numpy seeds;
* JPEG bytes equal between the packages (when Pillow is installed), and
  the codec's ``ImportError`` without it.

Everything is compared exactly: these are copies and integer
arithmetic, and the float ones run the same numpy code.
"""

import os
import struct
import sys

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import ml_dtypes
import torch

from singa_tpu import data as jdata
from singa_tpu import image_tool as jimg
from singa_tpu import snapshot as jsnap
from singa_tpu import tensor as jt
from singa_tpu.io import binfile as jbf
from singa_tpu.io import loader as jloader
from singa_tpu.io import textfile as jtext
from singa_tpu_torch import data, image_tool, snapshot
from singa_tpu_torch.io import CorruptRecordError, binfile, loader, textfile
from singa_tpu_torch.resilience import faults

PKGS = {"jax": jbf, "port": binfile}


def _records(seed=0, n=6):
    rng = np.random.RandomState(seed)
    return [(f"key/{i}" + "x" * rng.randint(0, 20),
             rng.bytes(int(rng.randint(0, 300)))) for i in range(n)] + \
        [("empty", b"")]


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """Both packages on one codec: their native libraries, or neither."""
    if request.param == "python":
        for mod in PKGS.values():
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_lib_err", RuntimeError("off"))
    else:
        assert binfile.native_available() and jbf.native_available()
    return request.param


def _write(mod, path, recs):
    with mod.BinFileWriter(str(path)) as w:
        for k, v in recs:
            w.put(k, v)
    return open(path, "rb").read()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_binfile_bytes_and_records_interchange(tmp_path, codec, writer,
                                               reader):
    recs = _records(len(writer + reader))
    ours = _write(PKGS[writer], tmp_path / "a.bin", recs)
    theirs = _write(PKGS[reader], tmp_path / "b.bin", recs)
    assert ours == theirs
    with PKGS[reader].BinFileReader(str(tmp_path / "a.bin")) as r:
        assert r.count() == len(recs)
        assert list(r.items()) == recs
        assert r.key(2) == recs[2][0] and r.value(2) == recs[2][1]


def test_native_library_is_the_ports_own():
    path = binfile.native_library_path()
    assert binfile.native_available()
    assert os.path.dirname(path).endswith(os.path.join("singa_tpu_torch",
                                                       "_build"))
    assert os.path.exists(path)


@pytest.mark.parametrize("cut", ["crc_footer", "value", "value_header",
                                 "key", "key_header"])
def test_truncated_tail_raises_typed(tmp_path, codec, cut):
    recs = _records(3, n=3)
    blob = _write(binfile, tmp_path / "a.bin", recs)
    # append one more record, then cut it at the named place
    k, v = "tail-key", b"0123456789abcdef"
    rec = struct.pack("<I", len(k)) + k.encode() + struct.pack("<Q", len(v)) \
        + v + struct.pack("<I", 0)
    keep = {"crc_footer": len(rec) - 2, "value": len(rec) - 10,
            "value_header": 4 + len(k) + 3, "key": 6,
            "key_header": 2}[cut]
    path = tmp_path / "cut.bin"
    open(path, "wb").write(blob + rec[:keep])
    with pytest.raises(CorruptRecordError) as ei:
        with binfile.BinFileReader(str(path)) as r:
            r.read_all()
    e = ei.value
    assert e.offset == len(blob)
    assert "truncated tail" in str(e) or "exceeds remaining file" in str(e)
    # the key is named once the record's key is whole (the native index
    # drops a record whose value-length header is cut, key and all)
    if cut in ("crc_footer", "value") or (cut, codec) == ("value_header",
                                                          "python"):
        assert e.key == k and repr(k) in str(e)


def test_crc_flip_raises_typed(tmp_path, codec):
    recs = _records(4, n=4)
    blob = bytearray(_write(binfile, tmp_path / "a.bin", recs))
    off = 8
    for k, v in recs[:2]:
        off += 4 + len(k) + 8 + len(v) + 4
    k, v = recs[2]
    assert len(v) > 0
    blob[off + 4 + len(k) + 8 + len(v) // 2] ^= 0x40
    path = tmp_path / "flip.bin"
    open(path, "wb").write(bytes(blob))
    with pytest.raises(CorruptRecordError) as ei:
        with binfile.BinFileReader(str(path)) as r:
            r.read_all()
    e = ei.value
    assert e.key == k and e.offset == off and e.reason == "CRC mismatch"
    assert e.expected != e.actual and f"offset={off}" in str(e)


def test_binfile_fault_site_and_prefetch_queue(tmp_path, codec):
    path = str(tmp_path / "a.bin")
    _write(binfile, path, _records())
    with faults.injected("io.binfile", faults.FailOnce()):
        with pytest.raises(faults.FaultInjected):
            binfile.BinFileReader(path)
    q = binfile.PrefetchQueue(capacity=4)
    for i in range(3):
        q.put(f"k{i}", bytes([i]) * (i + 1))
    assert q.qsize() == 3
    assert [q.get() for _ in range(3)] == [(f"k{i}", bytes([i]) * (i + 1))
                                           for i in range(3)]
    q.close()
    assert q.get() is None
    q.free()


def test_textfile_bytes_interchange(tmp_path):
    vals = ["plain", "with\nnewline", "back\\slash\\n", "", "ünïcode ✓"]
    for W, R in ((jtext, textfile), (textfile, jtext)):
        a, b = tmp_path / "a.txt", tmp_path / "b.txt"
        for mod, p in ((W, a), (R, b)):
            with mod.TextFileWriter(str(p)) as w:
                for v in vals[:-1]:
                    w.put(v)
                w.Write(vals[-1])
        assert open(a, "rb").read() == open(b, "rb").read()
        r = R.TextFileReader(str(a))
        assert [v for _, v in r.items()] == vals
        assert r.Read() == ("0", "plain")
        r.close()


def _states(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "step": np.asarray(12, np.int32),
            "ids": rng.randint(0, 1000, (2, 4)).astype(np.int64),
            "half": rng.standard_normal((4, 2)).astype(np.float32)}


def test_snapshot_interchange_bf16_included(tmp_path):
    st = _states()
    bf = st["half"].astype(ml_dtypes.bfloat16)
    # JAX writes, the port reads
    with jsnap.Snapshot(str(tmp_path / "j"), jsnap.Snapshot.kWrite) as s:
        for k, v in st.items():
            s.write(k, jt.from_numpy(v) if k != "ids" else v)
        s.write("bf16", jt.from_numpy(st["half"]).as_type(jt.bfloat16))
    with snapshot.Snapshot(str(tmp_path / "j"), snapshot.Snapshot.kRead) as s:
        got = s.read("cpu")
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].view(torch.int16).numpy(),
                                  bf.view(np.int16))
    for k, v in st.items():
        want = v.astype(np.int32) if k == "ids" and got[k].dtype == \
            torch.int32 else v
        np.testing.assert_array_equal(got[k].numpy(), want)
    # the port writes (torch tensors, numpy arrays, bf16), JAX reads
    with snapshot.Snapshot(str(tmp_path / "p"), snapshot.Snapshot.kWrite) as s:
        for k, v in st.items():
            s.write(k, torch.from_numpy(v) if k != "b" else v)
        s.write("bf16", torch.from_numpy(st["half"]).bfloat16())
    with jsnap.Snapshot(str(tmp_path / "p"), jsnap.Snapshot.kRead) as s:
        back = s.read_numpy()
    assert back["bf16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["bf16"].view(np.int16),
                                  bf.view(np.int16))
    for k, v in st.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    with snapshot.Snapshot(str(tmp_path / "p"), snapshot.Snapshot.kRead) as s:
        nums = s.read_numpy()
    np.testing.assert_array_equal(nums["bf16"], bf.astype(np.float32))
    # same records, same bytes (JAX stores the int64 ids as given here)
    for name in ("j", "p"):
        with binfile.BinFileReader(str(tmp_path / f"{name}.bin")) as r:
            assert r.count() == len(st) + 1


def _dataset(path, mod, seed=0, n=37):
    rng = np.random.RandomState(seed)
    xs = rng.randint(0, 50257, (n, 9)).astype(np.int64)
    ys = rng.randint(0, 10, n)
    mod.write_dataset(str(path), xs, ys)
    return xs, ys


def test_loader_batches_equal_jax(tmp_path, codec):
    _dataset(tmp_path / "j.bin", jloader)
    xs, ys = _dataset(tmp_path / "p.bin", loader)
    assert open(tmp_path / "j.bin", "rb").read() == \
        open(tmp_path / "p.bin", "rb").read()
    mine = loader.DataLoader(str(tmp_path / "p.bin"), 8, num_workers=1,
                             seed=5)
    theirs = jloader.DataLoader(str(tmp_path / "j.bin"), 8, num_workers=1,
                                seed=5)
    assert len(mine) == len(theirs) == 4
    for _ in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 4
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == np.float32 and gy.dtype == np.int32
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    assert mine.seed == theirs.seed == 7
    # token ids round-trip exactly through the float32 records
    x0, y0 = loader.decode_example(loader.encode_example(xs[0], ys[0]))
    np.testing.assert_array_equal(x0.astype(np.int64), xs[0])
    # several workers: the same batches, in some order
    many = loader.DataLoader(str(tmp_path / "p.bin"), 8, num_workers=3,
                             shuffle=False)
    got = sorted(tuple(b[1]) for b in many)
    want = sorted(tuple(ys[i * 8:(i + 1) * 8]) for i in range(4))
    assert got == want


@pytest.mark.parametrize("train", [False, True])
def test_augment_batch_equals_jax(train):
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (5, 20, 24, 3)).astype(np.uint8)
    kw = dict(mean=[0.4, 0.5, 0.6], std=[0.2, 0.25, 0.3], train=train,
              seed=17, threads=2)
    got = image_tool.augment_batch(imgs, (16, 18), **kw)
    want = jimg.augment_batch(imgs, (16, 18), **kw)
    assert got.shape == (5, 3, 16, 18) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if train:
        assert not np.array_equal(
            got, image_tool.augment_batch(imgs, (16, 18), **dict(kw,
                                                                 seed=18)))


def test_image_transforms_equal_jax():
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (20, 26, 3)).astype(np.uint8)
    for pos in ("center", "left_top", "left_bottom", "right_top",
                "right_bottom"):
        np.testing.assert_array_equal(image_tool.crop(img, (9, 11), pos),
                                      jimg.crop(img, (9, 11), pos))
    for d in ("horizontal", "vertical"):
        np.testing.assert_array_equal(image_tool.flip(img, d),
                                      jimg.flip(img, d))
    np.testing.assert_array_equal(image_tool.resize(img, (13, 31)),
                                  jimg.resize(img, (13, 31)))
    np.testing.assert_array_equal(
        image_tool.normalize(img, [1, 2, 3], [2, 3, 4]),
        jimg.normalize(img, [1, 2, 3], [2, 3, 4]))
    np.testing.assert_array_equal(
        image_tool.color_jitter(img, 0.2, 0.3, np.random.RandomState(1)),
        jimg.color_jitter(img, 0.2, 0.3, np.random.RandomState(1)))
    np.testing.assert_array_equal(image_tool.to_chw(img), jimg.to_chw(img))
    outs = []
    for mod in (image_tool, jimg):
        np.random.seed(9)
        outs.append(mod.ImageTool(img).resize_by_range((22, 30))
                    .crop((16, 16), "random").flip(prob=0.5).get())
    np.testing.assert_array_equal(*outs)


def test_batch_iter_and_split_equal_jax():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((23, 4)).astype(np.float32)
    y = rng.randint(0, 3, 23)
    for shuffle in (True, False):
        a = data.ImageBatchIter(x, y, 5, shuffle=shuffle, seed=3,
                                augment=lambda v: v * 2)
        b = jdata.ImageBatchIter(x, y, 5, shuffle=shuffle, seed=3,
                                 augment=lambda v: v * 2)
        assert len(a) == len(b) == 4
        for _ in range(2):
            for (ax, ay), (bx, by) in zip(a, b, strict=True):
                np.testing.assert_array_equal(ax, bx)
                np.testing.assert_array_equal(ay, by)
    for frac in (0.2, 0.5):
        got = data.train_test_split(x, y, test_frac=frac, seed=8)
        want = jdata.train_test_split(x, y, test_frac=frac, seed=8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])


def test_jpeg_round_trip_equals_jax():
    pytest.importorskip("PIL")
    from singa_tpu.io import image as jimage
    from singa_tpu_torch.io import image

    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)
    blob = image.encode_jpg(img, quality=90)
    assert blob == jimage.encode_jpg(img, quality=90)
    np.testing.assert_array_equal(image.decode_jpg(blob),
                                  jimage.decode_jpg(blob))
    assert image.JPGDecoder().Decode(blob).shape == (12, 16, 3)
    with pytest.raises(ValueError, match="uint8"):
        image.encode_jpg(img.astype(np.float32))


def test_jpeg_codec_without_pillow_raises_import_error(monkeypatch):
    from singa_tpu_torch.io import image

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs Pillow"):
        image.encode_jpg(np.zeros((2, 2, 3), np.uint8))
