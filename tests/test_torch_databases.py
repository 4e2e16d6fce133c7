"""Port differential: the pack store (`databases/`).

The port keeps its own copy of the JAX package's PackDB writer and of its
Python reader (the native reader, `native/libpackdb.so`, is not copied). A
pack written by either package's writer must read back bit for bit through
both packages' readers, the JAX one held to its Python reader too, and both
writers must write the same bytes. The typed databases the KBR datasets read
(`ImageDatabase`, `LabelDatabase`, `ArrayDatabase`, `MaskDatabase`, and the
KITTI devkit's `DepthDatabase` of uint16 benchmark depth) must decode to
bitwise-equal values.
"""
import io

import numpy as np
import pytest
from PIL import Image

from slowtv_monodepth_tpu import databases as jdb
from slowtv_monodepth_tpu.data.devkits import kitti_raw_pack as jkrp
from slowtv_monodepth_tpu.databases import packdb as jpackdb
from slowtv_monodepth_tpu_torch import databases as tdb
from slowtv_monodepth_tpu_torch.data.devkits import kitti_raw_pack as tkrp
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

PACKAGES = {'jax': jdb, 'port': tdb}


@pytest.fixture(autouse=True)
def python_reader_on_both_sides(monkeypatch):
    """The JAX package reads through its Python reader, as the port does."""
    monkeypatch.setattr(jpackdb, '_lib', False)


def _blobs() -> dict:
    rng = np.random.default_rng(0)
    blobs = {f'seq/{i:05}': rng.bytes(int(rng.integers(0, 300))) for i in range(300)}
    blobs['ünïcode/é'] = b'\x00\xff' * 7
    return blobs


def _readers(path) -> dict:
    return {'jax': jdb.PackReader(path, use_native=False), 'port': tdb.PackReader(path)}


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_a_pack_reads_back_bitwise_through_both_readers(tmp_path, writer):
    blobs, path = _blobs(), tmp_path / 'db.pack'
    with PACKAGES[writer].PackWriter(path, meta={'kind': 'test', 'n': 3}) as w:
        for k, v in blobs.items():
            w.put(k, v)
    readers = _readers(path)
    assert readers['port'].keys == readers['jax'].keys
    for name, r in readers.items():
        assert len(r) == len(blobs), name
        assert r.meta == {'kind': 'test', 'n': 3, 'protocol': r.meta['protocol']}, name
        assert all(r.get(k) == v for k, v in blobs.items()), name
        assert 'seq/00000' in r and 'nope' not in r
        with pytest.raises(KeyError):
            r.get('nope')
        r.close()


def test_both_writers_write_the_same_bytes(tmp_path):
    for name, pkg in PACKAGES.items():
        with pkg.PackWriter(tmp_path / f'{name}.pack', meta={'kind': 'image'}) as w:
            for k, v in _blobs().items():
                w.put(k, v)
    assert (tmp_path / 'jax.pack').read_bytes() == (tmp_path / 'port.pack').read_bytes()


def _png(arr: np.ndarray) -> bytes:
    b = io.BytesIO()
    Image.fromarray(arr).save(b, 'PNG')  # uint16 -> mode I;16
    return b.getvalue()


def _write_typed(pkg, root) -> dict:
    """Image, benchmark-depth, label, array and mask packs -> their paths."""
    rng = np.random.default_rng(1)
    imgs = {f'{i:010}': _png(rng.integers(0, 255, (9, 14, 3), dtype=np.uint8)) for i in range(4)}
    depth = {f'{i:010}': _png((rng.random((9, 14)) * 80 * 256).astype(np.uint16))
             for i in range(4)}
    masks = {f'{i:010}': _png((rng.random((9, 14)) > 0.5).astype(np.uint8) * 255) for i in range(2)}
    labels = {'K': rng.random((4, 4)).astype(np.float32), 'shape': (375, 1242), 'n': {'a': 1}}
    arrays = {'a': rng.random((3, 5)), 'b': np.arange(7, dtype=np.int16)}
    return {'image': pkg.write_image_database(imgs, root / 'images'),
            'depth': pkg.write_image_database(depth, root / 'depth'),
            'mask': pkg.write_image_database(masks, root / 'masks', kind='mask'),
            'label': pkg.write_label_database(labels, root / 'labels'),
            'array': pkg.write_array_database(arrays, root / 'arrays')}


def _typed_values(side, files) -> dict:
    pkg, devkit = (jdb, jkrp) if side == 'jax' else (tdb, tkrp)
    dbs = {'image': pkg.ImageDatabase(files['image'].parent),
           'depth': devkit.DepthDatabase(files['depth'].parent),
           'mask': pkg.MaskDatabase(files['mask'].parent),
           'label': pkg.LabelDatabase(files['label'].parent),
           'array': pkg.ArrayDatabase(files['array'].parent)}
    out = {(name, k): db[k] for name, db in dbs.items() for k in db.keys}
    out.update({('pil', k): np.asarray(dbs['image'].pil(k)) for k in dbs['image'].keys})
    out[('index', 0)] = dbs['label'].index(0)[0]
    out[('batch', 0)] = dbs['array'][['a', 'b']]
    return out


def _assert_bitwise(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            _assert_bitwise(u, v)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bitwise(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_typed_databases_decode_bitwise_alike(tmp_path, writer):
    files = _write_typed(PACKAGES[writer], tmp_path)
    want, got = _typed_values('jax', files), _typed_values('port', files)
    assert got.keys() == want.keys() and len(want) == 4 + 4 + 2 + 3 + 2 + 4 + 2
    for k in want:
        _assert_bitwise(got[k], want[k])
    depth = got[('depth', '0000000000')]
    assert depth.dtype == np.float32 and depth.shape == (9, 14) and 1 < depth.max() <= 80


def _bump_first_depth(path) -> None:
    """Rewrite a benchmark-depth pack with its first pixel one step (1/256 m) deeper."""
    r = tdb.PackReader(path)
    recs = {k: bytes(r.get(k)) for k in r.keys}
    r.close()
    k = sorted(recs)[0]
    arr = np.array(Image.open(io.BytesIO(recs[k])), dtype=np.uint16)
    arr[0, 0] += 1
    recs[k] = _png(arr)
    tdb.write_image_database(recs, path.parent)


def test_the_bitwise_comparison_has_teeth(tmp_path):
    """The same draws with one depth pixel 1/256 m off do not compare equal."""
    want = _typed_values('jax', _write_typed(jdb, tmp_path / 'a'))
    files = _write_typed(tdb, tmp_path / 'b')
    _bump_first_depth(files['depth'])
    got = _typed_values('port', files)
    with pytest.raises(AssertionError):
        for k in want:
            _assert_bitwise(got[k], want[k])
