"""The port's host data pipeline against the JAX package's, on the CPU:
each augment transform and the whole train chain with the same seeds (the
port's sample generator against JAX's global ``np.random`` seeded alike),
the epoch plan, samples and batches of ``TrainData``, ``EvalData``'s
batches and the synth_shapes corpus, all bit for bit. Both packages decode
and resize through cv2."""

import filecmp
import os

import numpy as np
import pytest

from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu.data import augment as jaug
from pqdet_tpu.data.eval_data import EvalData as JaxEvalData
from pqdet_tpu.data.samples import VOCSampleGetter as JaxVOCGetter
from pqdet_tpu.data.scripts.synth_shapes import generate as jax_generate
from pqdet_tpu.data.train_data import TrainData as JaxTrainData
from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.data import augment as aug
from pqdet_tpu_torch.data.eval_data import EvalData
from pqdet_tpu_torch.data.samples import VOCSampleGetter, annotation_path, sample_getter
from pqdet_tpu_torch.data.scripts.synth_shapes import generate
from pqdet_tpu_torch.data.train_data import TrainData, epoch_batches, make_batch
from test_data import CLASSES, _write_voc_fixture

SEEDS = range(6)


@pytest.fixture(scope='module')
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('voc'))
    return _write_voc_fixture(root, n=6)


def _opts(txt, *extra):
    return ['dataset.train_txt_file', txt, 'dataset.eval_txt_file', txt,
            'dataset.classes', '[cat, dog, bird]', 'train.batch_size', '2',
            'train.input_sizes', '[64, 96, 128]', 'eval.batch_size', '4',
            'eval.input_size', '96', 'model.max_gt_boxes', '16', 'augment.device', 'off',
            *extra]


def _image(seed, h=120, w=90):
    return np.random.RandomState(100 + seed).randint(0, 256, (h, w, 3), np.uint8)


def _boxes(seed, n=3, h=120, w=90):
    r = np.random.RandomState(200 + seed)
    xy = r.uniform(0, [w * 0.6, h * 0.6], (n, 2))
    wh = r.uniform(12, 30, (n, 2))
    return np.concatenate([xy, xy + wh, r.randint(0, 3, (n, 1))], 1).astype(np.float32)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    assert np.asarray(a[0]).dtype == np.asarray(b[0]).dtype


def _partner(seed):
    return _image(seed + 50, 96, 96), _boxes(seed + 50, 2, 96, 96)


TRANSFORMS = {
    'hflip': (lambda: jaug.RandomHFlip(p=0.5), lambda: aug.RandomHFlip(p=0.5)),
    'vflip': (lambda: jaug.RandomVFlip(p=0.5), lambda: aug.RandomVFlip(p=0.5)),
    'safe_crop': (lambda: jaug.RandomSafeCrop(p=0.75), lambda: aug.RandomSafeCrop(p=0.75)),
    'color_jitter': (lambda: jaug.ColorJitter(p=1.0), lambda: aug.ColorJitter(p=1.0)),
    'resize': (lambda: jaug.Resize((96, 96)), lambda: aug.Resize((96, 96))),
    'resize_wide': (lambda: jaug.Resize((64, 128)), lambda: aug.Resize((64, 128))),
    'normalize': (lambda: jaug.Normalize(), lambda: aug.Normalize()),
    'compose': (lambda: jaug.Compose([jaug.RandomHFlip(0.5), jaug.RandomSafeCrop(0.75),
                                      jaug.ColorJitter(p=0.8), jaug.Resize((96, 96))]),
                lambda: aug.Compose([aug.RandomHFlip(0.5), aug.RandomSafeCrop(0.75),
                                     aug.ColorJitter(p=0.8), aug.Resize((96, 96))])),
}


@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    """Each transform, seeds 0-5: JAX's draws from the global np.random
    seeded s, the port's from RandomState(s); images and boxes equal."""
    make_jax, make_port = TRANSFORMS[name]
    for s in SEEDS:
        np.random.seed(s)
        want = make_jax()(_image(s), _boxes(s))
        got = make_port()(_image(s), _boxes(s), np.random.RandomState(s))
        _same(got, want)


@pytest.mark.parametrize('name', ['mixup', 'mosaic'])
def test_blend_matches_jax(name):
    """Mixup (beta 1.5, cv2.addWeighted on uint8) and Mosaic at p=1 and 0.5,
    with a partner sampler that draws nothing."""
    for s in SEEDS:
        for p in (1.0, 0.5):
            img, boxes = aug.Resize((96, 96))(_image(s), _boxes(s))
            if name == 'mixup':
                tj = jaug.Mixup(lambda: _partner(s), p=p, beta=1.5)
                tp = aug.Mixup(lambda rng: _partner(s), p=p, beta=1.5)
            else:
                tj = jaug.Mosaic(lambda: _partner(s), size=(96, 96), p=p)
                tp = aug.Mosaic(lambda rng: _partner(s), size=(96, 96), p=p)
            np.random.seed(s)
            want = tj(img.copy(), boxes.copy())
            got = tp(img.copy(), boxes.copy(), np.random.RandomState(s))
            _same(got, want)


def test_train_chain_matches_jax(voc):
    """The VOC getter's whole train chain (flips, safe crop, colour jitter,
    letterbox, mosaic, mixup) over every fixture image: with JAX's partner
    path drawn from np.random as the port's is, each sample is equal."""
    cfg = load_config(opts=_opts(voc, 'augment.color_p', '0.8', 'augment.vflip_p', '0.5',
                                 'augment.mosaic_p', '0.5', 'augment.mixup_p', '0.5'))
    paths = [p.strip() for p in open(voc)]
    jg = JaxVOCGetter(mode='train', classes=CLASSES).set_train_augment(
        cfg.augment, (96, 96), lambda: paths[np.random.randint(0, len(paths))])
    pg = VOCSampleGetter(mode='train', classes=CLASSES).set_train_augment(
        cfg.augment, (96, 96), lambda rng: paths[rng.randint(0, len(paths))])
    n_mixed = 0
    for s in SEEDS:
        for path in paths:
            np.random.seed(s)
            want = jg(path)
            got = pg(path, np.random.RandomState(s))
            _same(got, want)
            n_mixed += int((want[1][:, 5] < 1).any())
    assert n_mixed > 0


def test_train_data_matches_jax(voc):
    """Two epochs of TrainData: the plan (indices, sizes, largest first) is
    JAX's; slot k of epoch e equals JAX's sample with the global np.random
    seeded (seed, e, k); padded GT boxes zero past the real ones."""
    opts = _opts(voc, 'augment.mixup_p', '0', 'augment.color_p', '0.5', 'system.seed', '3')
    jd = JaxTrainData(jax_load_config(opts=opts + ['system.label_assign', 'device']))
    pd = TrainData(load_config(opts=opts))
    for epoch in range(2):
        assert pd._indexes == jd._indexes and pd._sizes == jd._sizes
        assert pd._sizes[0] == (128, 128)
        for k in range(len(pd)):
            np.random.seed([3, epoch, k])
            _same(pd.get(k), jd.get(k))
        jd.init_shuffle()
        pd.init_shuffle()


def test_device_mode_train_data_matches_jax(voc):
    """With augment.device the host only letterboxes (the compose chain is
    empty, mosaic and mixup probabilities notwithstanding): two epochs of
    samples equal JAX's bit for bit, GT rows with a mixup weight of 1."""
    opts = _opts(voc, 'augment.device', 'on', 'augment.mosaic_p', '0.5',
                 'augment.color_p', '0.5', 'system.seed', '5')
    jd = JaxTrainData(jax_load_config(opts=opts))
    pd = TrainData(load_config(opts=opts))
    assert pd.sample_getter.compose_augment.transforms == []
    for _ in range(2):
        assert pd._indexes == jd._indexes and pd._sizes == jd._sizes
        for k in range(len(pd)):
            got = pd.get(k)
            _same(got, jd.get(k))
            real = got[1][..., 2] > got[1][..., 0]
            assert real.any() and (got[1][real, 5] == 1).all()
        jd.init_shuffle()
        pd.init_shuffle()


def test_batches_do_not_depend_on_workers(voc):
    """epoch_batches with 1 and 3 loader threads give the same batches as
    make_batch alone: uint8 (B, H, W, 3) at the planned size, GT (B, 16, 6)
    padded with zeros."""
    cfg = load_config(opts=_opts(voc, 'augment.mixup_p', '0.5', 'augment.mosaic_p', '0.5'))
    data = TrainData(cfg)
    ref = [make_batch(data, idx) for idx in data.batch_indices()]
    for workers in (1, 3):
        got = list(epoch_batches(data, num_workers=workers, prefetch=2))
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g['image'], r['image'])
            np.testing.assert_array_equal(g['gt'], r['gt'])
    for b, size in zip(ref, data._sizes):
        assert b['image'].dtype == np.uint8 and b['image'].shape == (2, *size, 3)
        assert b['gt'].shape == (2, 16, 6)
        real = b['gt'][..., 2] > b['gt'][..., 0]
        assert real.any() and (b['gt'][~real] == 0).all()


@pytest.mark.parametrize('host_normalize', [False, True])
def test_eval_data_matches_jax(voc, host_normalize):
    """EvalData's batches (images, names, shapes, GT, difficult flags, the
    zero-padded tail) equal JAX's, with uint8 or host-normalized images, and
    eval.partial cuts the list."""
    for partial in ('0', '5'):
        opts = _opts(voc, 'eval.host_normalize', str(host_normalize), 'eval.partial', partial)
        jd, pd = JaxEvalData(jax_load_config(opts=opts)), EvalData(load_config(opts=opts))
        assert len(pd) == len(jd) == 2 and pd.length == jd.length
        for want, got in zip(jd.batches(2, 2), pd.batches(2, 2)):
            assert got['count'] == want['count'] and got['file_name'] == want['file_name']
            for key in ('image', 'shape'):
                np.testing.assert_array_equal(got[key], want[key])
                assert got[key].dtype == want[key].dtype
            for key in ('bboxes', 'difficult'):
                for a, b in zip(got[key], want[key]):
                    np.testing.assert_array_equal(a, b)


def test_synth_shapes_matches_jax(tmp_path):
    """The corpus writer gives JAX's files: images, annotations, splits."""
    for gen, name in ((jax_generate, 'jax'), (generate, 'port')):
        gen(str(tmp_path / name), n=6, size=96, seed=1, holdout=0.34, vary_aspect=True)
    for sub in ('JPEGImages', 'Annotations'):
        files = sorted(os.listdir(tmp_path / 'jax' / sub))
        assert files == sorted(os.listdir(tmp_path / 'port' / sub)) and len(files) == 6
        _, bad, err = filecmp.cmpfiles(tmp_path / 'jax' / sub, tmp_path / 'port' / sub, files,
                                       shallow=False)
        assert not bad and not err
    for split in ('train.txt', 'test.txt'):
        want = (tmp_path / 'jax' / split).read_text().replace('/jax/', '/port/')
        assert (tmp_path / 'port' / split).read_text() == want


def test_annotation_path_and_queued_getters():
    """VOC's annotation path for any extension; the COCO and VisDrone
    getters, queued before this slice, are built by name in any case."""
    from pqdet_tpu_torch.data.samples import COCOSampleGetter, VisDroneSampleGetter
    assert annotation_path('/d/JPEGImages/a.b.png') == '/d/Annotations/a.b.xml'
    assert annotation_path('/d/JPEGImages/x.jpg') == '/d/Annotations/x.xml'
    for name, cls in (('coco', COCOSampleGetter), ('VisDrone', VisDroneSampleGetter)):
        assert type(sample_getter(name, mode='train', classes=CLASSES)) is cls


@pytest.mark.parametrize('key,value', [('system.loader', 'process'),
                                       ('system.label_assign', 'host')],
                         ids=['system.loader-process-item 3', 'system.label_assign-host-item 3'])
def test_queued_loader_modes_raise(voc, key, value):
    """The loader modes queued before this slice build their TrainData:
    the process loader's samples are the thread loader's (TrainData does
    not read system.loader), host labels give the label grids and padded
    boxes of each scale; with augment.device, host labels still raise."""
    data = TrainData(load_config(opts=_opts(voc, key, value)))
    sample = data.get(0)
    h, w = data._sizes[0]
    if key == 'system.loader':
        assert len(sample) == 2 and sample[1].shape == (16, 6)
        return
    image, labels, boxes = sample
    assert image.shape == (h, w, 3) and image.dtype == np.uint8
    assert [lab.shape for lab in labels] == [(h // s, w // s, 3, 9) for s in (8, 16, 32)]
    assert [b.shape for b in boxes] == [(16, 4)] * 3
    with pytest.raises(ValueError, match="needs system.label_assign='device'"):
        TrainData(load_config(opts=_opts(voc, key, value, 'augment.device', 'on')))
