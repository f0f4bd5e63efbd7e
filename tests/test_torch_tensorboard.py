"""The port's hand-written TensorBoard event file against srtpu's
tensorboardX ``TBLogger`` on the CPU.

* The same scalars, an image and a histogram (srtpu's weight histogram:
  ``add_histogram`` with tensorboardX's default ``bins='tensorflow'``)
  written by both, parsed with tensorboardX's own ``Event`` protocol
  buffer: every field equal but ``wall_time``. The PNG bytes of the image
  are compared as the pixels they decode to (two encoders: the port's
  stdlib one, tensorboardX's Pillow), and their height, width and
  colorspace as fields.
* Every record's framing checked on the bytes: the length, and the
  masked CRC32C of the length and of the payload, computed with
  tensorboardX's CRC32C; the port's CRC32C (its numpy lanes included)
  against tensorboardX's on random bytes of many lengths.
* The port's reader (``read_events``) gives back what was written, and
  raises on a flipped byte.
* ``Trainer.fit`` with ``log_weights_every_n_epochs=1`` writes every
  parameter's histogram each epoch, and its val images and metrics.
"""

import io
import struct

import numpy as np
import pytest
import torch
from PIL import Image
from tensorboardX.crc32c import crc32c as tbx_crc32c
from tensorboardX.proto import event_pb2

from srtpu.utils.logging import TBLogger
from srtpu_torch.utils import tensorboard as tb

from test_torch_fit_val import OPT, SEED, write_sets

torch.set_num_threads(1)


def _masked(data: bytes) -> int:
    x = tbx_crc32c(data) & 0xFFFFFFFF
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _records(path) -> list:
    """tensorboardX's Events of an event file, each record's framing and
    CRCs checked with tensorboardX's CRC32C."""
    data, out, i = path.read_bytes(), [], 0
    while i < len(data):
        n, = struct.unpack('<Q', data[i:i + 8])
        assert struct.unpack('<I', data[i + 8:i + 12])[0] == \
            _masked(data[i:i + 8])
        body = data[i + 12:i + 12 + n]
        assert struct.unpack('<I', data[i + 12 + n:i + 16 + n])[0] == \
            _masked(body)
        ev = event_pb2.Event()
        ev.ParseFromString(body)
        out.append(ev)
        i += 16 + n
    return out


def _file(d):
    files = list(d.glob('events.out.tfevents.*'))
    assert len(files) == 1
    return files[0]


def _write(writer, img):
    writer.scalars({'loss/total': 0.25, 'Val/PSNR': 21.5, 'odd tag!': -3.0},
                   3)
    writer.image('Val/img0/epoch_00004', img, 7)
    writer.image('Val/img0/epoch_00004_center', img[:4, :5], 7)


def test_event_file_matches_tensorboardx(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((9, 13, 3)).astype(np.float32) * 1.2 - 0.1
    hists = {'weights/head.weight': rng.standard_normal((3, 3, 3, 16))
             .astype(np.float32),
             'weights/tail.bias': np.zeros(3, np.float32),
             'weights/w': np.array([1e-13, -2.0, 7.5e3], np.float32)}
    ref = TBLogger(tmp_path / 'srtpu')
    _write(ref, img)
    for tag, v in hists.items():
        ref._writer.add_histogram(tag, v, 2)
    ref.close()
    port = tb.EventWriter(tmp_path / 'port')
    _write(port, img)
    for tag, v in hists.items():
        port.histogram(tag, v, 2)
    port.close()
    want, got = (_records(_file(tmp_path / d)) for d in ('srtpu', 'port'))
    assert len(got) == len(want) == 1 + 3 + 2 + 3
    assert got[0].file_version == want[0].file_version == 'brain.Event:2'
    kinds = set()
    for g, w in zip(got, want):
        g.wall_time = w.wall_time = 0.0
        for gv, wv in zip(g.summary.value, w.summary.value):
            kinds.add(gv.WhichOneof('value'))
            if gv.HasField('image'):
                pixels = [np.asarray(Image.open(io.BytesIO(
                    v.image.encoded_image_string))) for v in (gv, wv)]
                assert np.array_equal(*pixels)
                gv.image.encoded_image_string = b''
                wv.image.encoded_image_string = b''
        assert g == w
    assert kinds == {'simple_value', 'image', 'histo'}


@pytest.mark.parametrize('n', [0, 1, 7, 4095, 16383, 16384, 16385, 65536,
                               100003, 1 << 20])
def test_crc32c_matches_tensorboardx(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert tb.crc32c(data) == tbx_crc32c(data) & 0xFFFFFFFF
    assert tb.masked_crc32c(data) == _masked(data)


def test_reader_round_trip_and_crc(tmp_path):
    w = tb.EventWriter(tmp_path)
    vals = np.linspace(-1, 2, 50)
    w.scalars({'a': 1.5}, 4)
    w.image('im', np.full((2, 3, 3), 0.5), 5)
    w.histogram('h', vals, 6)
    w.close()
    path = _file(tmp_path)
    ev = tb.read_events(path)
    assert ev[0]['file_version'] == 'brain.Event:2'
    assert (ev[1]['step'], ev[1]['values']) == (4, [{'tag': 'a',
                                                     'simple_value': 1.5}])
    im = ev[2]['values'][0]['image']
    assert (ev[2]['step'], im['height'], im['width'], im['colorspace']) == \
        (5, 2, 3, 3)
    h = ev[3]['values'][0]['histo']
    want = tb.histogram_fields(vals)
    assert ev[3]['step'] == 6 and h['num'] == 50 and h['max'] == 2.0
    assert np.array_equal(h['bucket'], want['bucket'])
    assert np.array_equal(h['bucket_limit'], want['bucket_limit'])
    data = bytearray(path.read_bytes())
    data[-6] ^= 1
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match='CRC'):
        tb.read_events(path)


def test_fit_writes_weight_histograms_and_val_images(tmp_path):
    from srtpu_torch.data import SRData
    from srtpu_torch.models import create_model
    from srtpu_torch.train import Trainer, TrainerConfig
    datasets = write_sets(tmp_path, n_train=2)
    model = create_model('EDSR', scale_factor=4, n_feats=16, n_resblocks=2,
                         generator=torch.Generator().manual_seed(0))
    trainer = Trainer(TrainerConfig(
        default_root_dir=str(tmp_path / 'run'), max_epochs=2,
        check_val_every_n_epoch=2, num_sanity_val_steps=0,
        log_weights_every_n_epochs=1))
    try:
        trainer.fit(model, SRData(
            datasets_dir=str(datasets), train_datasets=['Train'],
            eval_datasets=['Val'], batch_size=2, patch_size=32,
            scale_factor=4, seed=SEED), optimizer_params=OPT)
    finally:
        trainer.close()
    events = tb.read_events(_file(tmp_path / 'run' / 'tensorboard_logs'))
    hist = {}
    for ev in events:
        for v in ev['values']:
            if 'histo' in v:
                hist.setdefault(ev['step'], set()).add(v['tag'])
    names = {f'weights/{n}' for n, _ in model.named_parameters()}
    assert hist == {1: names, 2: names}
    tags = {v['tag'] for ev in events for v in ev['values']}
    assert {'Val/PSNR', 'Val/SSIM', 'Val/000/epoch_00002'} <= tags
    images = [v['image'] for ev in events for v in ev['values']
              if 'image' in v]
    assert (images[0]['height'], images[0]['width']) == (64, 80)
