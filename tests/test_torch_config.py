"""The port's config against the JAX package's: every yaml of ``yamls/``
and the override lists give the same value on every field both packages
have, and keys of slices not ported yet raise naming their ROADMAP item."""

import dataclasses
from pathlib import Path

import pytest
import yaml

from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu_torch.config import LATER_KEYS, Config, load_config, merge_from_list

REPO = Path(__file__).resolve().parent.parent
YAMLS = sorted(p.name for p in (REPO / 'yamls').glob('*.yaml'))


def _leaves(cfg, prefix=''):
    """(dotted key, value) of every field of the port's config."""
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f'{prefix}{f.name}.')
        else:
            yield f'{prefix}{f.name}', v


def _jax_value(jcfg, key):
    node = jcfg
    for part in key.split('.'):
        node = node[part]
    return node


def _assert_same(cfg, jcfg):
    n = 0
    for key, v in _leaves(cfg):
        jv = _jax_value(jcfg, key)
        if isinstance(jv, tuple):
            jv = list(jv)
        assert v == jv and type(v) is type(jv), (key, v, jv)
        n += 1
    return n


def _yaml_keys(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _yaml_keys(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}'


def test_defaults_match_jax():
    """Every field of the port's Config has JAX's default (the field list
    is what the port reads)."""
    assert _assert_same(Config(), jax_load_config()) >= 50


@pytest.mark.parametrize('name', YAMLS)
def test_yaml_matches_jax(name):
    """A yaml loads into the same values as in JAX on every field both have,
    or, when it sets a key of a queued slice, raises NotImplementedError
    naming that key and its ROADMAP item."""
    path = str(REPO / 'yamls' / name)
    with open(path) as fr:
        keys = list(_yaml_keys(yaml.safe_load(fr)))
    later = [k for k in keys if k in LATER_KEYS or k.split('.')[0] in LATER_KEYS]
    if later:
        named = later[0] if later[0] in LATER_KEYS else later[0].split('.')[0]
        with pytest.raises(NotImplementedError, match=f'{named}.*ROADMAP.md queue 1'):
            load_config(path)
        return
    _assert_same(load_config(path), jax_load_config(path))


OPTS = ['dataset.train_txt_file', '/data/a.txt', 'dataset.classes', '[cat, dog, bird]',
        'train.input_sizes', '[64]', 'train.learning_rate_init', '4e-4',
        'train.max_epochs', '3', 'train.warmup_epochs', '0', 'augment.device', 'off',
        'augment.hflip_p', '1', 'eval.after', '1', 'eval.input_size', '96',
        'weight.clear_history', 'on', 'weight.resume', 'w/model-1.ckpt',
        'system.num_workers', '8', 'system.compute_dtype', 'float32',
        'experiment_name', 'exp', 'dataset.cache_images', 'yes', 'train.head_probe', 'false']


def test_merge_from_list_matches_jax():
    """A yaml then an override list (bools as on/yes/false, floats in e
    notation, ints for floats, flow lists), typed as JAX types them."""
    path = str(REPO / 'yamls' / 'shapes.yaml')
    cfg = load_config(path, OPTS)
    assert cfg.train.warmup_epochs == 0.0 and isinstance(cfg.train.warmup_epochs, float)
    assert cfg.augment.device is False and cfg.weight.clear_history is True
    assert _assert_same(cfg, jax_load_config(path, OPTS)) >= 50


@pytest.mark.parametrize('opts,error', [
    (['train.batch_size'], ValueError),
    (['train.no_such_key', '1'], KeyError),
    (['nogroup.key', '1'], KeyError),
    (['train.batch_size', 'many'], TypeError),
    (['augment.device', 'maybe'], TypeError),
    (['train.unroll_steps', '2'], NotImplementedError),
    (['system.data_devices', '2'], NotImplementedError),
    (['train.spatial', '2'], NotImplementedError),
])
def test_bad_overrides_raise(opts, error):
    with pytest.raises(error):
        merge_from_list(Config(), opts)


@pytest.mark.parametrize('key,value', [('system.loader', 'process'),
                                       ('system.device_prefetch', '2'),
                                       ('system.label_assign', 'host'),
                                       ('train.s2d_stem', '2'), ('eval.s2d_stem', '2')])
def test_ported_keys_load(key, value):
    """The loader, upload-thread and space-to-depth keys, once queued, load
    as JAX's do; only the data-parallel and unroll keys stay queued."""
    opts = [key, value]
    cfg = load_config(opts=opts)
    assert str(getattr(getattr(cfg, key.split('.')[0]), key.split('.')[1])) == value
    assert _assert_same(cfg, jax_load_config(opts=opts)) >= 50
    assert sorted(LATER_KEYS) == ['system.data_devices', 'train.spatial', 'train.unroll_steps']
