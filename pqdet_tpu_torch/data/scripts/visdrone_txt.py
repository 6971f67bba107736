"""Write the VisDrone image lists with area-proportional repeats (the port of
``pqdet_tpu/data/scripts/visdrone_txt.py``).

    python -m pqdet_tpu_torch.data.scripts.visdrone_txt [--root .] [--seed N]

``trainval.txt`` lists each train and val image (``VisDrone2019-DET-train``
and ``-val`` under the root, ``images/*.jpg``) area / smallest area times,
the fractional part of a repeat resolved by a Bernoulli draw from
``np.random.RandomState(seed)``; ``test.txt`` lists the test images once.
The files are taken in sorted order and the draws made in that order, so
one seed on one directory gives one list on any filesystem. The JAX
script takes ``glob`` order, which is the directory's listing order and
differs between filesystems (ext4 hashes names with a per-filesystem
seed); on a directory whose listing is sorted the two lists are equal.
Image sizes are read from the JPEG headers (``jpeg_size``, no decode).
"""

import argparse
import glob
import os
import struct

import numpy as np

SETS = ['VisDrone2019-DET-train', 'VisDrone2019-DET-val', 'VisDrone2019-DET-test']
# start-of-frame markers carry the size; C4 (DHT), C8 (JPG) and CC (DAC) do not
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def jpeg_size(path: str):
    """(width, height) of a JPEG file from its start-of-frame header."""
    with open(path, 'rb') as f:
        if f.read(2) != b'\xff\xd8':
            raise ValueError(f'not a JPEG file: {path}')
        while True:
            b = f.read(1)
            while b and b != b'\xff':
                b = f.read(1)
            while b == b'\xff':
                b = f.read(1)
            if not b:
                raise ValueError(f'no start-of-frame marker in {path}')
            marker = b[0]
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                continue                        # markers without a length
            (length,) = struct.unpack('>H', f.read(2))
            if marker in _SOF:
                _, h, w = struct.unpack('>BHH', f.read(5))
                return w, h
            f.seek(length - 2, os.SEEK_CUR)


def repeat_count(ratio: float, rng: np.random.RandomState) -> int:
    frac = ratio % 1
    if frac == 0:
        return int(ratio)
    return int(np.floor(ratio) + rng.binomial(1, frac))


def write_lists(root: str, seed=None):
    """Write trainval.txt and test.txt under ``root``; returns the number of
    train and val images and of test images."""
    rng = np.random.RandomState(seed)
    root = os.path.abspath(root)
    trainval = []
    for s in SETS[:2]:
        trainval.extend(sorted(glob.glob(os.path.join(root, s, 'images/*.jpg'))))
    test = sorted(glob.glob(os.path.join(root, SETS[2], 'images/*.jpg')))
    areas = {}
    for p in trainval:
        w, h = jpeg_size(p)
        areas[p] = w * h
    min_area = min(set(areas.values()))
    with open(os.path.join(root, 'trainval.txt'), 'w') as fw:
        for p, area in areas.items():
            for _ in range(repeat_count(area / min_area, rng)):
                fw.write(os.path.abspath(p) + '\n')
    with open(os.path.join(root, 'test.txt'), 'w') as fw:
        for p in test:
            fw.write(os.path.abspath(p) + '\n')
    return len(trainval), len(test)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root', default=os.getcwd())
    parser.add_argument('--seed', type=int, default=None)
    args = parser.parse_args(argv)
    n_trainval, n_test = write_lists(args.root, args.seed)
    print(f'{n_trainval} train/val images, {n_test} test images')


if __name__ == '__main__':
    main()
