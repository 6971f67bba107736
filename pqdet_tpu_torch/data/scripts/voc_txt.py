"""Write the VOC image lists (the port of ``pqdet_tpu/data/scripts/voc_txt.py``).

    python -m pqdet_tpu_torch.data.scripts.voc_txt [--root .]

Reads ``VOCdevkit/VOC{2007,2012}/ImageSets/Main/<set>.txt`` under the root
and writes ``<year>_<set>.txt`` for each set, ``train.txt`` (2007 and 2012
train and val) and ``train.all.txt`` (those and 2007 test), one absolute
image path a line.
"""

import argparse
import os

SETS = [('2012', 'train'), ('2012', 'val'), ('2007', 'train'), ('2007', 'val'),
        ('2007', 'test')]


def write_lists(root: str):
    root = os.path.abspath(root)
    written = {}
    for year, image_set in SETS:
        with open(os.path.join(root, f'VOCdevkit/VOC{year}/ImageSets/Main/{image_set}.txt')) as fr:
            ids = fr.read().split()
        out = os.path.join(root, f'{year}_{image_set}.txt')
        with open(out, 'w') as fw:
            for image_id in ids:
                fw.write(f'{root}/VOCdevkit/VOC{year}/JPEGImages/{image_id}.jpg\n')
        written[(year, image_set)] = out

    def concat(paths, out):
        with open(out, 'w') as fw:
            for p in paths:
                with open(p) as fr:
                    fw.write(fr.read())

    trainval = [written[k] for k in [('2007', 'train'), ('2007', 'val'), ('2012', 'train'),
                                     ('2012', 'val')]]
    concat(trainval, os.path.join(root, 'train.txt'))
    concat(trainval + [written[('2007', 'test')]], os.path.join(root, 'train.all.txt'))
    return root


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root', default=os.getcwd(), help='directory containing VOCdevkit')
    args = parser.parse_args(argv)
    root = write_lists(args.root)
    print('wrote train.txt / train.all.txt / per-set lists under', root)


if __name__ == '__main__':
    main()
