"""The rest of the port's host data against the JAX package's, on the CPU:
host label assignment, the COCO and VisDrone getters (labels, eval chains,
train chains under replayed draws), the new transforms, VisDrone's
per-image eval sizes and their inverse affine, non-square decode grids,
host-label epochs, the list scripts, the playground and the shipped coco
and visdrone yamls through the CLIs. Corpora come from ``chip_smoke``'s
writers at small sizes (the ones its phase 18 writes at full size)."""

import os

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from pqdet_tpu.cli.playground import augmented_samples as jax_playground
from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu.data import augment as jaug
from pqdet_tpu.data import samples as jsamples
from pqdet_tpu.data.eval_data import EvalData as JaxEvalData
from pqdet_tpu.data.train_data import TrainData as JaxTrainData
from pqdet_tpu.data.train_data import assign_labels as jax_assign_labels
from pqdet_tpu.data.train_data import smooth_onehot as jax_smooth_onehot
from pqdet_tpu.model.decode import decode as jax_decode
from pqdet_tpu.ops.pallas_decode import decode_pallas
from pqdet_tpu_torch.cli.playground import augmented_samples, grid
from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.data import augment as aug
from pqdet_tpu_torch.data import samples
from pqdet_tpu_torch.data.eval_data import EvalData
from pqdet_tpu_torch.data.scripts import visdrone_txt, voc_txt
from pqdet_tpu_torch.data.train_data import (TrainData, assign_labels, make_batch,
                                             smooth_onehot)
from pqdet_tpu_torch.ops.decode_kernel import decode_heads, head_views
from pqdet_tpu_torch.ops.labels import assign_labels_device
from pqdet_tpu_torch.ops.postprocess import ratio_pad_affine, recover_bboxes
from test_data import _write_voc_fixture
from test_torch_data import _boxes, _image, _same
from test_torch_decode import assert_decode_close

VISDRONE_CLASSES = ['pedestrian', 'people', 'bicycle', 'car', 'van', 'truck', 'tricycle',
                    'awning-tricycle', 'bus', 'motor']
TINY_VISDRONE = ((160, 120), (128, 72), (96, 54))
STRIDES = np.array([8, 16, 32])
ANCHORS = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119], [116, 90],
                    [156, 198], [373, 326]], np.float32)
SEEDS = range(4)


@pytest.fixture(scope='module')
def visdrone(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('visdrone'))
    chip_smoke.write_visdrone(root, sizes=TINY_VISDRONE, per_size=2, boxes=(6, 30))
    visdrone_txt.write_lists(root, seed=0)
    return root


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('coco'))
    return chip_smoke.write_coco(root, 6, 4, boxes=(1, 6))


def _paths(txt):
    return [line.strip() for line in open(txt) if line.strip()]


def _dataset_opts(name, train, test, *extra):
    classes = VISDRONE_CLASSES if name == 'visdrone' else [f'c{i}' for i in range(80)]
    return ['dataset.name', name, 'dataset.train_txt_file', train, 'dataset.eval_txt_file', test,
            'dataset.classes', '[' + ', '.join(classes) + ']', 'train.batch_size', '2',
            'train.input_sizes', '[64, 96]', 'model.max_gt_boxes', '32', 'eval.batch_size', '1',
            'eval.input_size', '96', *extra]


def _lists(name, visdrone, coco):
    if name == 'visdrone':
        return os.path.join(visdrone, 'trainval.txt'), os.path.join(visdrone, 'test.txt')
    return coco['train'], coco['val']


# ------------------------------------------------------------ host labels

def test_smooth_onehot_matches_jax():
    for nc, idx, deta in ((4, 2, 0.01), (80, 79, 0.01), (3, 0, 0.1)):
        np.testing.assert_array_equal(smooth_onehot(nc, idx, deta),
                                      jax_smooth_onehot(nc, idx, deta))


def _scene(rng, n, size, nc):
    cxy = rng.rand(n, 2) * np.array(size)[::-1] * 1.05 - 5      # some centres outside
    wh = np.exp(rng.uniform(np.log(2), np.log(300), (n, 2)))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2, rng.randint(0, nc, (n, 1)),
                           rng.rand(n, 1)], axis=1).astype(np.float32)


@pytest.mark.parametrize('case', ['basic', 'fallback', 'crowded'])
def test_assign_labels_matches_jax(case):
    """Grids and padded boxes bit for bit against JAX's assign_labels: one
    box (tests/test_data.py's basic case), a box no anchor clears (the
    argmax fallback), and crowded scenes at square and non-square sizes with
    contended (cell, anchor) slots, out-of-bounds centres, empty scenes and
    more boxes than max_gt; the crowded grids also equal the device
    assigner's (ops/labels.py) on the same boxes."""
    if case == 'basic':
        scenes = [(np.array([[85, 70, 115, 130, 1, 0.7]], np.float32), (256, 256), ANCHORS)]
    elif case == 'fallback':
        scenes = [(np.array([[10, 10, 20, 20, 0, 1.0]], np.float32), (64, 64),
                   np.full((9, 2), 400, np.float32))]
    else:
        rng = np.random.RandomState(7)
        scenes = [(_scene(rng, n, size, 7), size, ANCHORS)
                  for n, size in ((0, (320, 320)), (5, (320, 416)), (24, (416, 320)),
                                  (40, (416, 416)))]
    for boxes, size, anchors in scenes:
        max_gt = 8 if case != 'crowded' else 4 if len(boxes) > 24 else 24
        got = assign_labels(boxes, size, STRIDES, anchors, 7, max_gt=max_gt)
        want = jax_assign_labels(boxes, size, STRIDES, anchors, 7, max_gt=max_gt)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        if case == 'crowded' and len(boxes) <= max_gt:
            gt = np.zeros((1, max_gt, 6), np.float32)
            gt[0, :len(boxes)] = boxes
            dev = assign_labels_device(torch.from_numpy(gt), size, STRIDES, anchors, 7,
                                       gt_per_grid=3, iou_threshold=0.3)
            for a, b in zip(got[0] + got[1], dev):
                np.testing.assert_array_equal(a, b.numpy()[0])
    if case != 'crowded':
        assert sum(int((lab[..., 4] > 0).sum()) for lab in got[0]) >= 1


@pytest.fixture(scope='module')
def voc(tmp_path_factory):
    return _write_voc_fixture(str(tmp_path_factory.mktemp('voc')), n=6)


def test_host_label_train_data_matches_jax(voc):
    """Two epochs of host-label TrainData: slot k of epoch e equals JAX's
    host-mode sample with the global np.random seeded (seed, e, k), image,
    grids and boxes (no mixup: JAX draws its partner's path from the global
    ``random``); make_batch stacks them into the step's 6 targets."""
    opts = ['dataset.train_txt_file', voc, 'dataset.eval_txt_file', voc,
            'dataset.classes', '[cat, dog, bird]', 'train.batch_size', '2',
            'train.input_sizes', '[64, 96]', 'model.max_gt_boxes', '16',
            'augment.mixup_p', '0', 'augment.color_p', '0.5', 'system.seed', '3',
            'system.label_assign', 'host']
    jd = JaxTrainData(jax_load_config(opts=opts))
    pd = TrainData(load_config(opts=opts))
    for epoch in range(2):
        assert pd._indexes == jd._indexes and pd._sizes == jd._sizes
        for k in range(len(pd)):
            np.random.seed([3, epoch, k])
            want = jd.get(k)
            got = pd.get(k)
            np.testing.assert_array_equal(got[0], want[0])
            for a, b in zip(got[1] + got[2], want[1] + want[2]):
                np.testing.assert_array_equal(a, b)
        batch = make_batch(pd, pd.batch_indices()[0])
        h, w = pd._sizes[0]
        assert [t.shape for t in batch['targets']] == \
            [(2, h // s, w // s, 3, 9) for s in STRIDES] + [(2, 16, 4)] * 3
        jd.init_shuffle()
        pd.init_shuffle()


def test_host_label_epoch_trains(tmp_path):
    """An epoch of the Trainer with host labels: the step reads the
    batches' targets, the losses are finite and equal to the device-label
    epoch's (the two assigners give the same grids; f32, no augmentation)."""
    from pqdet_tpu_torch.train.trainer import Trainer
    from test_torch_trainer import _opts
    losses = {}
    for mode in ('device', 'host'):
        opts = _opts(tmp_path / mode, 4, 'system.label_assign', mode, 'train.max_epochs', '1',
                     'eval.after', '5', 'system.compute_dtype', 'float32',
                     'augment.mixup_p', '0', 'augment.crop_p', '0', 'augment.hflip_p', '0')
        trainer = Trainer(load_config(opts=opts), device='cpu')
        trainer.init_all()
        seen = []
        step = trainer.step_fn

        def probe(params, state, opt_state, batch, rng=None, step=step, seen=seen):
            out = step(params, state, opt_state, batch, rng)
            seen.append((sorted(batch), float(out[3]['loss'])))
            return out
        trainer.step_fn = probe
        trainer.train_epoch(0)
        trainer.close()
        losses[mode] = seen
    assert [k for k, _ in losses['host']] == [['image', 'targets']] * 2
    assert [k for k, _ in losses['device']] == [['gt', 'image']] * 2
    got, want = [x for _, x in losses['host']], [x for _, x in losses['device']]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --------------------------------------------------------- the transforms

TRANSFORMS = {
    'random_crop': (lambda: jaug.RandomCrop((64, 48), p=0.8),
                    lambda: aug.RandomCrop((64, 48), p=0.8)),
    'resize_ratio': (lambda: jaug.ResizeRatio(1.25), lambda: aug.ResizeRatio(1.25)),
    'pad_divisor': (lambda: jaug.PadNearestDivisor(), lambda: aug.PadNearestDivisor()),
    'ratio_pad': (lambda: jaug.Compose([jaug.ResizeRatio((0.75, 1.5)),
                                        jaug.PadNearestDivisor(divisor=16)]),
                  lambda: aug.Compose([aug.ResizeRatio((0.75, 1.5)),
                                       aug.PadNearestDivisor(divisor=16)])),
}


@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    make_jax, make_port = TRANSFORMS[name]
    for s in SEEDS:
        np.random.seed(s)
        want = make_jax()(_image(s), _boxes(s))
        got = make_port()(_image(s), _boxes(s), np.random.RandomState(s))
        _same(got, want)


def test_denormalize_matches_jax():
    img = aug.Normalize()(_image(0), [])[0]
    got = aug.DeNormalize()(img, [])[0]
    np.testing.assert_array_equal(got, jaug.DeNormalize()(img, [])[0])
    assert np.abs(got.astype(int) - _image(0)).max() <= 1


# ------------------------------------------------------------ the getters

JAX_GETTERS = {'coco': jsamples.COCOSampleGetter, 'visdrone': jsamples.VisDroneSampleGetter}


@pytest.mark.parametrize('name', ['coco', 'visdrone'])
def test_getter_labels_match_jax(name, visdrone, coco):
    """Train and eval labels of every image bit for bit: COCO's normalized
    boxes, VisDrone's comma lines with categories 0 and 11 dropped and score
    0 difficult (dropped in train mode)."""
    train, test = _lists(name, visdrone, coco)
    classes = VISDRONE_CLASSES if name == 'visdrone' else None
    n_diff = 0
    for path in sorted(set(_paths(train) + _paths(test))):
        for mode in ('train', 'eval'):
            got = samples.sample_getter(name, mode=mode, classes=classes).label(path)
            want = JAX_GETTERS[name](mode=mode, classes=classes).label(path)
            if mode == 'train':
                np.testing.assert_array_equal(got, want)
            else:
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
                n_diff += int(np.sum(got[1]))
    if name == 'visdrone':
        assert n_diff > 0


@pytest.mark.parametrize('name', ['coco', 'visdrone'])
def test_eval_data_matches_jax(name, visdrone, coco):
    """EvalData's batches bit for bit against JAX's: COCO letterboxed at
    eval.input_size with absolute boxes; VisDrone at batch 1 in per-image
    sizes (resize 1.25, pad to 32), each batch's shape its image's."""
    train, test = _lists(name, visdrone, coco)
    opts = _dataset_opts(name, train, test)
    jd, pd = JaxEvalData(jax_load_config(opts=opts)), EvalData(load_config(opts=opts))
    assert pd.input_size == jd.input_size == (96, 96) and len(pd) == len(jd)
    shapes = set()
    for want, got in zip(jd.batches(2, 2), pd.batches(2, 2)):
        assert got['file_name'] == want['file_name'] and got['count'] == want['count']
        for key in ('image', 'shape'):
            np.testing.assert_array_equal(got[key], want[key])
        for key in ('bboxes', 'difficult'):
            for a, b in zip(got[key], want[key]):
                np.testing.assert_array_equal(a, b)
        shapes.add(got['image'].shape[1:3])
    if name == 'visdrone':
        want_shapes = {(-(-round(h * 1.25) // 32) * 32, -(-round(w * 1.25) // 32) * 32)
                       for w, h in TINY_VISDRONE}
        assert shapes == want_shapes
    else:
        assert shapes == {(96, 96)}


@pytest.mark.parametrize('name', ['coco', 'visdrone'])
def test_train_chain_matches_jax(name, visdrone, coco):
    """The getters' whole train chain (VisDrone's 416 crop, flips, colour
    jitter, letterbox; COCO's standard chain; mosaic and mixup at 0.5) over
    every train image, seeds 0-3: with JAX's partner path drawn from
    np.random as the port's is, each sample is equal."""
    train, test = _lists(name, visdrone, coco)
    cfg = load_config(opts=_dataset_opts(name, train, test, 'augment.color_p', '0.8',
                                         'augment.vflip_p', '0.5', 'augment.mosaic_p', '0.5',
                                         'augment.mixup_p', '0.5', 'augment.device', 'off'))
    paths = sorted(set(_paths(train)))
    classes = list(cfg.dataset.classes)
    jg = JAX_GETTERS[name](mode='train', classes=classes).set_train_augment(
        cfg.augment, (96, 96), lambda: paths[np.random.randint(0, len(paths))])
    pg = samples.sample_getter(name, mode='train', classes=classes).set_train_augment(
        cfg.augment, (96, 96), lambda rng: paths[rng.randint(0, len(paths))])
    n_boxes = 0
    for s in SEEDS:
        for path in paths:
            np.random.seed(s)
            want = jg(path)
            got = pg(path, np.random.RandomState(s))
            _same(got, want)
            n_boxes += len(got[1])
    assert n_boxes > 0


def test_coco_device_corpus_is_absolute(coco):
    """With augment.device the COCO getter only letterboxes, and the boxes a
    sample carries (those the device corpus holds) are absolute pixels,
    JAX's bit for bit."""
    opts = _dataset_opts('coco', coco['train'], coco['val'], 'augment.device', 'on')
    jd, pd = JaxTrainData(jax_load_config(opts=opts)), TrainData(load_config(opts=opts))
    for i in range(pd.length):
        got = pd.build_sample(i, (96, 96), None)
        _same(got, jd.build_sample(i, (96, 96)))
        real = got[1][:, 2] > got[1][:, 0]
        assert real.any() and got[1][real, :4].max() > 2.0


def test_visdrone_pipeline(tmp_path):
    """tests/test_drivers.py::test_visdrone_pipeline in the port: labels in
    range, a train sample at 64 px (uint8, padded GT), and the eval batch
    of a 96x128 image at 128x160."""
    from test_drivers import _write_visdrone_fixture
    txt = _write_visdrone_fixture(str(tmp_path))
    cfg = load_config(opts=['dataset.name', 'visdrone', 'dataset.train_txt_file', txt,
                            'dataset.eval_txt_file', txt, 'dataset.classes',
                            '[%s]' % ', '.join(VISDRONE_CLASSES), 'model.max_gt_boxes', '16',
                            'train.batch_size', '3', 'train.input_sizes', '[64]',
                            'eval.batch_size', '1'])
    getter = samples.VisDroneSampleGetter(mode='eval', classes=VISDRONE_CLASSES)
    bbs, diffs = getter.label(txt.replace('list.txt', 'images/v0.jpg'))
    assert len(bbs) and (bbs[:, 4] < 10).all() and (bbs[:, 4] >= 0).all()
    assert set(np.unique(diffs)) <= {0, 1}
    img, gt = TrainData(cfg).get(0)
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8 and gt.shape == (16, 6)
    batch = EvalData(cfg).batch(0)
    assert batch['image'].shape == (1, 128, 160, 3) and batch['count'] == 1


def test_visdrone_recover_matches_forward_pipeline():
    """ratio_pad_affine inverts ResizeRatio + PadNearestDivisor at JAX's
    sizes and at VisDrone's four (tests/test_drivers.py's check)."""
    sizes = [(96, 128), (794, 1333), (540, 960), (767, 1365)] + \
        [(h, w) for w, h in chip_smoke.VISDRONE_SIZES]
    for h, w in sizes:
        img = np.zeros((h, w, 3), np.uint8)
        boxes = np.array([[10.0, 12.0, 60.0, 70.0, 0]], np.float32)
        chain = aug.Compose([aug.ResizeRatio(1.25), aug.PadNearestDivisor()])
        out_img, out_boxes = chain(img, boxes.copy(), None)
        pred = torch.zeros(1, 1, 15)
        pred[0, 0, :4] = torch.from_numpy(out_boxes[0, :4])
        pred[0, 0, 4] = 1.0
        rec = recover_bboxes(pred, torch.tensor(out_img.shape[:2], dtype=torch.float32),
                             torch.tensor([[h, w]], dtype=torch.float32),
                             affine=ratio_pad_affine)
        np.testing.assert_allclose(rec[0, 0, :4].numpy(), boxes[0, :4], atol=0.8,
                                   err_msg=f'{h}x{w}')


def test_nonsquare_decode_matches_jax():
    """VisDrone's eval grids are not square: three heads of H != W (16x20,
    8x10, 4x5 and a transposed set) through decode_heads into one preds
    tensor, each against JAX's decode and its Pallas kernel in interpret
    mode (rtol = atol = 1e-5, test_torch_decode's box tolerance)."""
    b, a, nc = 1, 3, 10
    rng = np.random.RandomState(11)
    for heads in ([(16, 20, 8), (8, 10, 16), (4, 5, 32)], [(20, 12, 8), (10, 6, 16), (5, 3, 32)]):
        raws = [(rng.randn(b, h, w, a * (5 + nc)) * 2).astype(np.float32) for h, w, _ in heads]
        out = decode_heads([torch.from_numpy(r) for r in raws], nc, [s for *_, s in heads],
                           [0.0] * 3)
        views = head_views(out, [r.shape for r in raws])
        for view, raw, (h, w, s) in zip(views, raws, heads):
            ref = np.asarray(jax_decode(jnp.asarray(raw), nc, s))
            pallas = np.asarray(decode_pallas(jnp.asarray(raw), nc, s, interpret=True))
            assert view.shape == ref.shape == (b, h, w, a, 5 + nc)
            assert_decode_close(pallas, ref, raw, nc, s)
            assert_decode_close(view.numpy(), ref, raw, nc, s)
            # the centre of cell (y, x) is (x + 0.5, y + 0.5) * stride
            d = view.numpy()[0, h - 1, 0, 0]
            ex = np.exp(raw.reshape(b, h, w, a, 5 + nc)[0, h - 1, 0, 0, :4])
            np.testing.assert_allclose(d[:4], np.array([0.5 - ex[0], h - 0.5 - ex[1],
                                                        0.5 + ex[2], h - 0.5 + ex[3]]) * s,
                                       rtol=1e-5, atol=1e-4)


# -------------------------------------------------------- the list scripts

def test_voc_txt_matches_jax(tmp_path, monkeypatch):
    """voc_txt on a tiny VOCdevkit: the same files, byte for byte, as JAX's
    script writes for the same layout."""
    import sys
    from pqdet_tpu.data.scripts import voc_txt as jax_voc_txt
    for name in ('jax', 'port'):
        for year, image_set in voc_txt.SETS:
            d = tmp_path / name / f'VOCdevkit/VOC{year}/ImageSets/Main'
            d.mkdir(parents=True, exist_ok=True)
            (d / f'{image_set}.txt').write_text(f'{year}_{image_set}_a\n{year}_{image_set}_b\n')
    monkeypatch.setattr(sys, 'argv', ['voc_txt', '--root', str(tmp_path / 'jax')])
    jax_voc_txt.main()
    voc_txt.main(['--root', str(tmp_path / 'port')])
    files = sorted(f for f in os.listdir(tmp_path / 'jax') if f.endswith('.txt'))
    assert files == sorted(f for f in os.listdir(tmp_path / 'port') if f.endswith('.txt'))
    assert len(files) == 7
    for f in files:
        want = (tmp_path / 'jax' / f).read_text().replace('/jax/', '/port/')
        assert (tmp_path / 'port' / f).read_text() == want
    assert (tmp_path / 'port' / 'train.txt').read_text().count('\n') == 8


def test_visdrone_txt_matches_jax(visdrone, tmp_path, monkeypatch):
    """visdrone_txt --seed 0 gives JAX's lists (PIL reads JAX's sizes, the
    port parses the JPEG headers): the same lines, repeats included."""
    import shutil
    import sys
    from pqdet_tpu.data.scripts import visdrone_txt as jax_visdrone_txt
    root = tmp_path / 'vd'
    shutil.copytree(visdrone, root, ignore=shutil.ignore_patterns('*.txt'))
    for s in chip_smoke.VISDRONE_SETS:
        shutil.copytree(os.path.join(visdrone, s, 'annotations'), root / s / 'annotations',
                        dirs_exist_ok=True)
    monkeypatch.setattr(sys, 'argv', ['visdrone_txt', '--root', str(root), '--seed', '0'])
    jax_visdrone_txt.main()
    want = {f: (root / f).read_text() for f in ('trainval.txt', 'test.txt')}
    visdrone_txt.main(['--root', str(root), '--seed', '0'])
    for f, text in want.items():
        assert (root / f).read_text() == text
    lines = want['trainval.txt'].split()
    assert len(set(lines)) == 2 * len(TINY_VISDRONE) < len(lines)
    for p in lines:
        assert visdrone_txt.jpeg_size(p) == cv2.imread(p).shape[1::-1]


# ------------------------------------------------------------ the playground

@pytest.mark.parametrize('name', ['voc', 'coco', 'visdrone'])
def test_playground_matches_jax(name, voc, visdrone, coco, tmp_path):
    """cli.playground's views of one image, bit for bit against JAX's
    playground with the global np.random seeded alike, and the CLI writes
    their grid."""
    if name == 'voc':
        img, opts = _paths(voc)[0], ['dataset.classes', '[cat, dog, bird]']
    else:
        train, test = _lists(name, visdrone, coco)
        img, opts = _paths(train)[0], _dataset_opts(name, train, test)[:6]
    opts += ['augment.mixup_p', '0.5', 'augment.color_p', '0.5']
    np.random.seed(5)
    want = jax_playground(jax_load_config(opts=opts), img, n=4)
    got = augmented_samples(load_config(opts=opts), img, n=4, seed=5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    from pqdet_tpu_torch.cli import playground
    out = str(tmp_path / f'{name}.jpg')
    g = playground.main(['--img', img, '--n', '4', '--seed', '5', '--out', out, *opts])
    np.testing.assert_array_equal(g, grid(got))
    assert cv2.imread(out).shape == g.shape == (416 + 4, 4 * (416 + 4), 3)


# ------------------------------------------------- the shipped yamls, CLIs

@pytest.mark.parametrize('name', ['coco', 'visdrone'])
def test_shipped_yaml_trains_and_serves(name, visdrone, coco, tmp_path, capsys):
    """yamls/<name>.yaml as shipped (its model, regnetx-600m-fpn, and its
    classes) with the small fixture's data through cli.train on the CPU:
    one epoch evaluated (VisDrone at batch 1 in per-image sizes), then
    cli.bench eval on its checkpoint prints the trainer's AP."""
    from pqdet_tpu_torch.cli import bench, train
    tr, te = _lists(name, visdrone, coco)
    yaml_path = os.path.join(os.path.dirname(__file__), '..', 'yamls', f'{name}.yaml')
    with open(tmp_path / 'train4.txt', 'w') as fw:
        fw.write('\n'.join(_paths(tr)[:4]))
    small = ['dataset.train_txt_file', str(tmp_path / 'train4.txt'),
             'dataset.eval_txt_file', te, 'weight.dir', str(tmp_path),
             'train.batch_size', '2', 'train.input_sizes', '[64]', 'train.max_epochs', '1',
             'eval.after', '0', 'eval.input_size', '64', 'system.num_workers', '2',
             'model.max_gt_boxes', '32']
    if name == 'coco':
        small += ['eval.batch_size', '2']
    train.main(['--yaml', yaml_path, '--device', 'cpu', *small])
    out = capsys.readouterr().out
    assert 'mAPs' in out and 'regnetx' in out
    exp = load_config(yaml_path).experiment_name
    ckpts = sorted(os.listdir(tmp_path / exp))
    assert len(ckpts) == 1 and ckpts[0].startswith('model-0-')
    ap = float(ckpts[0][len('model-0-'):-len('.ckpt')])
    bench.main(['eval', '--yaml', yaml_path, '--device', 'cpu', '--weight',
                str(tmp_path / exp / ckpts[0]), *small])
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith('AP ')][-1]
    assert round(float(line.split()[1]), 4) == ap
