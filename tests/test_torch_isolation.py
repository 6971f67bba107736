"""pqdet_tpu_torch stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from pqdet_tpu_torch import resolve_device
from pqdet_tpu_torch.bridge import (from_jax_params, from_jax_qparams,
                                    from_jax_quant_state)
from pqdet_tpu_torch.cli import bench as cli_bench
from pqdet_tpu_torch.cli import convert as cli_convert
from pqdet_tpu_torch.cli import evolute as cli_evolute
from pqdet_tpu_torch.cli import prune as cli_prune
from pqdet_tpu_torch.cli import search as cli_search
from pqdet_tpu_torch.cli.predict import predict_image
from pqdet_tpu_torch.compress.quantized import load_quantized, save_quantized
from pqdet_tpu_torch.model.factory import build_detector
from pqdet_tpu_torch.train.checkpoint import save_checkpoint
from pqdet_tpu_torch.train.trainer import Trainer
from pqdet_tpu_torch.ops.qconv import make_scalars
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline
from pqdet_tpu_torch.exporters.export import export_stablehlo_quant, load_stablehlo
from pqdet_tpu_torch.exporters.onnx_runtime import run_model
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.nas.search import measure_latency
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.train.step import train_step_from_config
from pqdet_tpu_torch.zoo import get_cfg

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    no trace of jax or pqdet_tpu in sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import pqdet_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            pqdet_tpu_torch.__path__, 'pqdet_tpu_torch.')]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'pqdet_tpu'))
        new = {'pqdet_tpu_torch.compress.qat', 'pqdet_tpu_torch.compress.quantized',
               'pqdet_tpu_torch.ops.qconv', 'pqdet_tpu_torch.ops.labels',
               'pqdet_tpu_torch.model.loss', 'pqdet_tpu_torch.train.schedule',
               'pqdet_tpu_torch.train.step', 'pqdet_tpu_torch.utils.meters',
               'pqdet_tpu_torch.data.augment', 'pqdet_tpu_torch.data.samples',
               'pqdet_tpu_torch.data.train_data', 'pqdet_tpu_torch.data.eval_data',
               'pqdet_tpu_torch.data.scripts.synth_shapes',
               'pqdet_tpu_torch.native.matcher', 'pqdet_tpu_torch.evaluation.evaluator',
               'pqdet_tpu_torch.train.checkpoint', 'pqdet_tpu_torch.model.factory',
               'pqdet_tpu_torch.train.trainer', 'pqdet_tpu_torch.cli.train',
               'pqdet_tpu_torch.cli.predict', 'pqdet_tpu_torch.cli.convert',
               'pqdet_tpu_torch.cli.bench', 'pqdet_tpu_torch.ops.augment_device',
               'pqdet_tpu_torch.data.scripts.synth_clutter',
               'pqdet_tpu_torch.compress.prune', 'pqdet_tpu_torch.utils.profiling',
               'pqdet_tpu_torch.cli.prune', 'pqdet_tpu_torch.ops.library',
               'pqdet_tpu_torch.exporters.onnx_proto', 'pqdet_tpu_torch.exporters.onnx_export',
               'pqdet_tpu_torch.exporters.onnx_runtime', 'pqdet_tpu_torch.exporters.export',
               'pqdet_tpu_torch.exporters.torch_convert', 'pqdet_tpu_torch.cli.anchors',
               'pqdet_tpu_torch.cli.diffeval', 'pqdet_tpu_torch.utils.reference_bridge',
               'pqdet_tpu_torch.zoo.regnet', 'pqdet_tpu_torch.zoo.classifier',
               'pqdet_tpu_torch.zoo.darknet',
               'pqdet_tpu_torch.utils.debug', 'pqdet_tpu_torch.nas.space',
               'pqdet_tpu_torch.nas.detnet', 'pqdet_tpu_torch.nas.search',
               'pqdet_tpu_torch.nas.evolute', 'pqdet_tpu_torch.nas.analysis',
               'pqdet_tpu_torch.utils.draw', 'pqdet_tpu_torch.cli.search',
               'pqdet_tpu_torch.cli.evolute', 'pqdet_tpu_torch.ops.space_to_depth',
               'pqdet_tpu_torch.cli.playground', 'pqdet_tpu_torch.data.scripts.voc_txt',
               'pqdet_tpu_torch.data.scripts.visdrone_txt', 'pqdet_tpu_torch.parallel.mesh'}
        print(len(names), bad, sorted(new - set(names)))
        sys.exit(1 if bad or len(names) < 40 or not new <= set(names) else 0)
    """)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax():
    """No source line of the port, and none of chip_smoke.py, imports jax or
    pqdet_tpu, and none imports a module by a name computed at run time
    (``__import__``, ``importlib.import_module``), which the line scan
    could not read."""
    for path in [*(REPO / 'pqdet_tpu_torch').rglob('*.py'), REPO / 'chip_smoke.py']:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (['import'], ['from']) and len(words) > 1:
                top = words[1].split('.')[0]
                assert top not in ('jax', 'jaxlib', 'pqdet_tpu'), f'{path}: {line}'
            assert '__import__(' not in line and 'import_module(' not in line, \
                f'{path}: {line}'


def test_chip_smoke_library_probe_imports_nothing():
    """chip_smoke.py's probe of the host libraries (phase 1) finds them
    without importing them: in a fresh interpreter it leaves none of them,
    and no jax or flax, in sys.modules."""
    code = textwrap.dedent("""
        import sys
        import chip_smoke
        libs = chip_smoke.host_libraries()
        probed = {name for name, _ in chip_smoke.HOST_LIBRARIES}
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in
                        probed | {'jax', 'jaxlib', 'flax', 'pqdet_tpu', 'torch'})
        print(libs, loaded)
        sys.exit(1 if loaded or set(libs) != probed
                 or libs['numpy'] in ('absent', 'present') else 0)
    """)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_exporters_and_operators_import_no_jax():
    """``ops/library.py`` (which registers the kernels as operators) and the
    exporters, imported alone in a fresh interpreter, bring in neither jax
    nor pqdet_tpu."""
    code = textwrap.dedent("""
        import sys
        import pqdet_tpu_torch.ops.library
        import pqdet_tpu_torch.exporters.export, pqdet_tpu_torch.exporters.onnx_export
        import pqdet_tpu_torch.exporters.onnx_runtime, pqdet_tpu_torch.exporters.torch_convert
        import torch
        ops = [getattr(torch.ops.pqdet, n) for n in pqdet_tpu_torch.ops.library.OP_NAMES]
        bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pqdet_tpu'))
        print(bad, ops)
        sys.exit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


@pytest.mark.parametrize('entry', ['resolve_device', 'init', 'pipeline', 'bridge',
                                   'bridge_qparams', 'bridge_quant_state', 'scalars',
                                   'label_assigner', 'train_step_from_config',
                                   'build_detector', 'trainer', 'predict_image',
                                   'load_quantized', 'prune_cli', 'bench_time',
                                   'convert_onnx', 'convert_stablehlo', 'convert_darknet',
                                   'convert_partial', 'bench_time_shlo',
                                   'export_stablehlo_quant', 'load_stablehlo', 'run_model',
                                   'search_cli', 'evolute_cli', 'measure_latency'])
def test_entry_point_without_device_raises(entry, monkeypatch, tmp_path):
    """Without ``device="cpu"`` and with no card, an entry point raises
    instead of quietly running on the CPU."""
    _no_cuda(monkeypatch)
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn', width_mult=0.25))
    qpath = str(tmp_path / 'q.ckpt')
    save_quantized(qpath, net, {'layers': {}, 'act': {}}, get_cfg('mobilenetv2-fpn'))
    fp_path = str(tmp_path / 'fp.ckpt')
    if entry == 'prune_cli':
        save_checkpoint(fp_path, net.graph, *net.init(torch.Generator().manual_seed(0),
                                                      device='cpu'),
                        step=0, cfg_text=get_cfg('mobilenetv2-fpn', width_mult=0.25))
    call = {
        'resolve_device': lambda: resolve_device(),
        'init': lambda: net.init(torch.Generator().manual_seed(0)),
        'pipeline': lambda: build_predict_pipeline(net, Config()),
        'bridge': lambda: from_jax_params({}, {}, net.graph),
        'bridge_qparams': lambda: from_jax_qparams({'layers': {}, 'act': {}}, net.graph),
        'bridge_quant_state': lambda: from_jax_quant_state({'quant': {}}),
        'scalars': lambda: make_scalars(0.1, 3.0),
        'label_assigner': lambda: label_assigner_from_config(Config()),
        'train_step_from_config': lambda: train_step_from_config(net, Config(), 10),
        'build_detector': lambda: build_detector(get_cfg('mobilenetv2-fpn', width_mult=0.25)),
        'trainer': lambda: Trainer(Config()),
        'predict_image': lambda: predict_image(Config(), 'x.jpg',
                                               cfg_path='mobilenetv2-fpn'),
        'load_quantized': lambda: load_quantized(qpath),
        'prune_cli': lambda: cli_prune.main(['prune.weight', fp_path, 'prune.new_cfg',
                                             str(tmp_path / 'p.cfg'), '--skip-finetune']),
        'bench_time': lambda: cli_bench.main(['time', '--size', '64']),
        'bench_time_shlo': lambda: cli_bench.main(['time', '--shlo', str(tmp_path / 'm.pt2')]),
        'export_stablehlo_quant': lambda: export_stablehlo_quant(net, {'layers': {}, 'act': {}}),
        'load_stablehlo': lambda: load_stablehlo(b''),
        'run_model': lambda: run_model(b'', {}),
        'search_cli': lambda: cli_search.main(['--rounds', '1', '--log',
                                               str(tmp_path / 'nas.json')]),
        'evolute_cli': lambda: cli_evolute.main(['--rounds', '1', '--log',
                                                 str(tmp_path / 'evo.json')]),
        'measure_latency': lambda: measure_latency(get_cfg('mobilenetv2-fpn', width_mult=0.25)),
        **{f'convert_{mode}': (lambda mode=mode: cli_convert.main(
            [mode, '--weight', qpath, '--out', str(tmp_path / 'out')]))
           for mode in ('onnx', 'stablehlo', 'darknet', 'partial')},
    }[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


def test_entry_point_with_cpu_runs(monkeypatch):
    _no_cuda(monkeypatch)
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn', width_mult=0.25))
    params, state = net.init(torch.Generator().manual_seed(0), device='cpu')
    assert all(p['w'].device.type == 'cpu' for p in params.values())
    with torch.inference_mode():
        preds = net(params, state, torch.zeros(1, 32, 32, 3))
    assert preds.shape == (1, (4 * 4 + 2 * 2 + 1) * 3, 25)
