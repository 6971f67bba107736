"""Faults planted in the program, underneath the harness, for the check's
controls and tests: each is a context manager that patches one of the
port's functions while it is open.

- ``serve_half_batch``: NMS keeps nothing for the second half of each batch;
- ``serve_altered``: the best detection of each batch's first image comes
  back with the next class;
- ``train_half_batch``: the step walks the first half of its batch only,
  the loss the mean over that half;
- ``train_unchanged``: the optimizer returns the params it was given;
- ``train_flipped``: the optimizer moves each param by its update's
  opposite (a sign error in the update).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def serve_half_batch():
    import pqdet_tpu_torch.evaluation.predict as P

    def make(nms):
        def half(*args, **kwargs):
            res = nms(*args, **kwargs)
            valid = res.valid.clone()
            valid[valid.shape[0] // 2:] = False
            return res._replace(valid=valid)
        return half
    return _patched(P, 'nms_batch', make)


def serve_altered():
    import pqdet_tpu_torch.evaluation.predict as P

    def make(nms):
        def altered(*args, **kwargs):
            res = nms(*args, **kwargs)
            classes = res.classes.clone()
            classes[0, 0] = (classes[0, 0] + 1) % int(args[0].shape[-1] - 4)
            return res._replace(classes=classes)
        return altered
    return _patched(P, 'nms_batch', make)


def train_half_batch():
    import pqdet_tpu_torch.train.step as S

    def make(inputs):
        def half(batch, *args, **kwargs):
            b = batch['image'].shape[0] // 2
            return inputs({**batch, 'image': batch['image'][:b], 'gt': batch['gt'][:b]},
                          *args, **kwargs)
        return half
    return _patched(S, '_inputs', make)


def train_unchanged():
    import pqdet_tpu_torch.train.step as S

    def make(update):
        def unchanged(self, grads, opt_state, params):
            _, new_state = update(self, grads, opt_state, params)
            return params, new_state
        return unchanged
    return _patched(S.Adam, 'update', make)


def train_flipped():
    import pqdet_tpu_torch.train.step as S

    def make(update):
        def flipped(self, grads, opt_state, params):
            new, new_state = update(self, grads, opt_state, params)
            back = [2 * p - q for p, q in zip(S.tree_leaves(params), S.tree_leaves(new))]
            return S.tree_unflatten(params, back), new_state
        return flipped
    return _patched(S.Adam, 'update', make)


FAULTS = {'serve': {'half_batch': serve_half_batch, 'altered': serve_altered},
          'train': {'half_batch': train_half_batch, 'unchanged': train_unchanged,
                    'flipped': train_flipped}}
