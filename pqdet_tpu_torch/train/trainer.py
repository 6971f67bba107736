"""The trainer: whole epochs of the training step (the port of
``pqdet_tpu/train/trainer.py``).

Per epoch: the thread loader decodes and augments the epoch plan's
batches on the host (``data/train_data.py``, one input size per batch);
each uint8 batch goes to the device (pinned, non-blocking) and through the
step of ``train_step_from_config`` (device labels, forward and loss,
backward, Adam). With ``augment.device`` the host only letterboxes and the
step augments on the device (``ops/augment_device.py``) with draws made on
the host from ``(system.seed, global_step)``, so a resumed run draws what
an uninterrupted one does. With ``dataset.device_cache`` the whole train
split is decoded and letterboxed once, at the largest input size, into one
uint8 tensor on the device; each step gathers its rows there (and resizes
them bilinearly to a smaller planned size), and with fresh partners
(``augment.fresh_partners``) also its mosaic and mixup partner rows, drawn
from ``np.random.RandomState(system.seed + 7)`` anew each epoch as the JAX
trainer draws them. Every 1/5 epoch the loss meters are flushed with one
device-to-host copy and printed, and a non-finite loss raises; past
``eval.after`` the bf16 predict pipeline and the AP evaluator score the
eval split; a checkpoint in the JAX package's format is written every
epoch, with the AP in its name when the epoch evaluated.

Resume (``weight.resume``) loads a checkpoint, starts at its step and sets
the lr schedule there, with Adam's moments fresh, as the JAX trainer does;
its epochs see the batches of an uninterrupted run (the JAX trainer starts
the epoch plan over).

QAT (``quant.switch``) trains the quant graph with the QAT step
(``train/step.py::make_qat_train_step``): the observers update in epochs
before ``quant.disable_observer_after`` and BN runs on batch statistics in
epochs before ``quant.freeze_bn_after``, the step rebuilt when either flag
flips. Each eval converts this epoch's params and observers to int8 and
scores the converted model through ``Int8Inference`` in kernel mode (the
int8 kernels and the decode kernel on the card), as the JAX trainer scores
its Pallas int8 path; checkpoints are of type ``qat``.

The host loader is ``system.loader``: a pool of threads, or of spawned
processes (``data/train_data.py::ProcessLoader``, started in ``init_all``
so that the workers' start-up overlaps the model's build); either gives
the same batches. With ``system.device_prefetch`` N a background thread
uploads the next N batches while the step runs: on the card it copies on
a side stream and the step's stream waits on each batch's event. With
``system.label_assign host`` the loader builds the label grids and the
batches carry them as ``targets``.

``run_prune`` fine-tunes a pruned checkpoint (``cli/prune.py``) and
``run_nas`` short-trains a NAS candidate (``nas/search.py``), each with the
JAX trainer's preset. ``close`` releases what a run holds on the device
(params, optimizer state, the step, the eval pipeline), the loader's
threads, the upload thread and the process pool with its shared-memory
slabs; the device corpus memo stays for the next trainer.

Data parallelism (``parallel/mesh.py``): a Trainer runs in the process
group it is started in (``cli.train`` and ``cli.prune`` launch one rank
per GPU for ``system.data_devices``, or join torchrun's group). Rank r of
W loads its slice of every global batch (``TrainData(num_hosts=W,
host_id=r)``), the params, BN and optimizer state are broadcast from rank
0 at init, and the step is the data-parallel one (sync-BN, averaged
grads, global device-augment draws). Every rank flushes the all-reduced
metrics (a non-finite loss raises on every rank at once) and rank 0 alone
prints, evaluates and writes checkpoints, the others waiting at a
barrier. A resume loads the same checkpoint on every rank. The dropout
generator is seeded per rank, where JAX draws one mask for the global
batch. With ``dataset.device_cache`` every rank holds the whole corpus on
its own device (JAX replicates it over its mesh), gathers its rows of each
global batch and, with fresh partners, all of the global batch's partner
rows, which every rank draws alike.

Spatial partitioning (``train.spatial`` N > 1): the ranks form a (data x
space) mesh (``parallel/mesh.py::make_mesh_2d``) of ``n_data x N`` ranks,
``system.data_devices`` (0: the world) being the total budget as in JAX.
The N ranks of data shard d load the same rows (``TrainData(num_hosts=
n_data, host_id=d)``; the uint8 images are small beside the activations
the bands split) and the step cuts each its band. It needs device labels
(``system.label_assign device``) and one host, excludes
``dataset.device_cache`` and ``train.unroll_steps`` > 1, and every input
size must be a multiple of the graph's total stride (as the whole-image
step needs); a size that N x the stride does not divide is walked padded
(``parallel/halo.py``). Each raises ``ValueError`` here, and so does a
world that is not the mesh (no process group included). Rank 0 evaluates
whole images without bands.

Unrolled steps (``train.unroll_steps`` K > 1): the epoch plan gives each
group of K batches one size and rounds the epoch up to whole groups
(``TrainData``); each group runs as one call of ``make_multi_step`` (a
plain loop of K steps), each sub-step with the augment draws of its own
global step, so a group equals K single steps on the same batches;
``global_step`` moves by K and the metrics flush when it crosses a
multiple of the print interval.

``shared_ap`` is the eval of a run whose every rank needs the AP (NAS
search and evolution across ranks): rank 0 evaluates and broadcasts the
AP, or the failure, to the others.
"""

from __future__ import annotations

import copy
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pqdet_tpu_torch import resolve_device
from pqdet_tpu_torch.compress.quantized import Int8Inference, convert_to_int8
from pqdet_tpu_torch.config import platform_device, resolve_model_cfg, sizes_fix
from pqdet_tpu_torch.data.eval_data import EvalData
from pqdet_tpu_torch.data.train_data import ProcessLoader, TrainData, epoch_batches
from pqdet_tpu_torch.evaluation.evaluator import Evaluator, format_ap_table
from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
from pqdet_tpu_torch.model.factory import build_detector, inference_params
from pqdet_tpu_torch.ops.augment_device import (draw_augment, fresh_partners_enabled,
                                                partner_rows_per_sample)
from pqdet_tpu_torch.parallel.mesh import (active_group, barrier, broadcast_object,
                                           broadcast_tree, make_mesh_2d, mesh_shape, rank,
                                           single_host, world)
from pqdet_tpu_torch.train.checkpoint import save_checkpoint
from pqdet_tpu_torch.train.step import (COMPUTE_DTYPES, make_multi_step, resume_schedule_step,
                                        sparse_bn_gamma_ids, stack_batches,
                                        train_step_from_config)
from pqdet_tpu_torch.utils.meters import AverageMeter, TicToc

CORE_METRICS = ('loss', 'giou_loss', 'conf_loss', 'class_loss', 'loss_per_branch')


class Trainer:

    # steps kept in flight on the card before the oldest is waited for: the
    # host stays ahead of the device while queued input batches stay bounded
    PIPELINE_DEPTH = 4
    # one corpus on each device per process, kept across trainers: drivers
    # that build a Trainer per short run upload it once
    _CACHE_MEMO = {}

    def __init__(self, config, device='cuda'):
        self.config = config
        self.device = resolve_device(platform_device(config, device))
        self.cfg_text: Optional[str] = None
        self.AP = None
        self.global_step = 0
        self.init_epoch = 0
        self._eval_run = None      # the predict pipeline, built once
        self._batches = None       # the running epoch's batch iterator
        self._proc_loader = None   # the process pool (system.loader process)
        # the data-parallel group (None at world size 1) and this rank
        self._group = active_group()
        self._world, self._rank = world(), rank()
        # spatial partitioning: the (data x space) mesh, or None
        self._spatial = None
        self._n_data, self._data_rank = self._world, self._rank

        c = config
        self._max_epochs = c.train.max_epochs
        self._eval_after = c.eval.after
        self._sparse = c.sparse.switch
        self._quant = c.quant.switch
        # the QAT phase: observers updating, BN frozen (train() sets them
        # per epoch and rebuilds the step when they flip)
        self._observing = True
        self._bn_frozen = False
        self._weights_dir = os.path.join(c.weight.dir, c.experiment_name)
        self._weight_base_name = 'model'
        self._resume = c.weight.resume
        self._backbone = c.weight.backbone
        self._clear_history = c.weight.clear_history
        self._num_workers = c.system.num_workers
        if c.system.loader not in ('thread', 'process'):
            raise ValueError(f"system.loader must be 'thread' or 'process', got "
                             f'{c.system.loader!r}')
        self._compute_dtype = COMPUTE_DTYPES[c.system.compute_dtype]
        self._augment = c.augment.device
        self._partner_rows = partner_rows_per_sample(c) if self._augment else 0
        self._device_cache = None
        self._unroll = max(int(c.train.unroll_steps), 1)
        if fresh_partners_enabled(c) and not c.dataset.device_cache:
            raise ValueError('augment.fresh_partners=on gathers partner rows from the '
                             "device corpus: set dataset.device_cache on ('auto' takes "
                             'in-batch partners without the cache)')
        if c.dataset.device_cache and (not self._augment or not single_host()
                                       or self._unroll > 1 or c.train.spatial > 1):
            raise ValueError('dataset.device_cache needs augment.device=on, a single host, '
                             'and no unroll/spatial partitioning')
        if c.train.spatial > 1:
            self._init_spatial(c)

        self.dataload_tt = TicToc()
        self.model_tt = TicToc()
        self.epoch_tt = TicToc()

    def _init_spatial(self, c):
        """Check a ``train.spatial`` config (JAX's checks, and input heights
        that the total stride divides) and join the (data x space) mesh of
        the process group."""
        n = c.train.spatial
        if not single_host():
            raise ValueError('train.spatial is single-host scoped')
        if c.system.label_assign != 'device':
            raise ValueError("train.spatial needs system.label_assign='device'")
        if self._unroll > 1:
            raise ValueError('train.spatial excludes unroll_steps > 1')
        from pqdet_tpu_torch.model.graph import Graph
        from pqdet_tpu_torch.parallel.halo import padded_height
        stride = max(x.stride for x in Graph.from_cfg(resolve_model_cfg(c)).nodes
                     if x.stride is not None)
        for h, _ in sizes_fix(c.train.input_sizes):
            padded_height(h, n, stride)
        n_data, n_space = mesh_shape(c.system.data_devices, c.train.batch_size, n,
                                     self._world)
        self._spatial = make_mesh_2d(n_data, n_space)
        self._group = self._spatial.world
        self._n_data, self._data_rank = n_data, self._spatial.d

    def _log(self, *args):
        """print on rank 0 only."""
        if self._rank == 0:
            print(*args)

    # ------------------------------------------------------------------ init

    def init_all(self):
        if self.cfg_text is None:
            self.cfg_text = resolve_model_cfg(self.config)
        self.train_data = TrainData(self.config, num_hosts=self._n_data,
                                    host_id=self._data_rank)
        self.eval_data = EvalData(self.config)
        self.steps_per_epoch = self.train_data.batches_per_epoch
        self._print_interval = max(self.steps_per_epoch // 5, 1)
        self._log(f'{self.train_data.length} images for train.')
        self._log(f'{self.eval_data.length} images for evaluate.')

        if self.config.dataset.device_cache:
            self._build_device_cache()
        elif self.config.system.loader == 'process' and self._proc_loader is None:
            self._proc_loader = ProcessLoader(self.train_data, self._num_workers,
                                              prefetch=max(self.config.system.prefetch, 2))

        self.network, params, state, info = build_detector(
            self.cfg_text, weight_path=self._resume or None,
            backbone_path=self._backbone or None,
            clear_history=self._clear_history, qat=self._quant, device=self.device)
        self.global_step = info['step']
        self.init_epoch = self.global_step // self.steps_per_epoch
        if self._resume:
            self._log(f'resumed at {self.global_step} steps from {self._resume}')
        # the data of the resumed epoch is that of an uninterrupted run: the
        # epoch plan and the per-sample augment seeds move on to init_epoch
        for _ in range(self.init_epoch):
            self.train_data.init_shuffle()

        self.step_fn, self.optimizer = self._make_step()
        self.schedule = self.optimizer.schedule
        opt_state = self.optimizer.init(params)
        if self.global_step:
            opt_state = resume_schedule_step(opt_state, self.global_step)
        for tree in (params, state, opt_state):     # replicated from rank 0
            broadcast_tree(tree, group=self._group)
        self._sparse_ids = sorted(sparse_bn_gamma_ids(self.network), key=int) \
            if self._sparse else None
        if self._sparse:
            n_all = sum(1 for n in self.network.graph.nodes if n.has_bn)
            self._log(f'sparse mode: {len(self._sparse_ids)}/{n_all} BN layers will be sparsed.')

        self.params, self.state, self.opt_state = params, state, opt_state
        self.losses = {
            'loss': AverageMeter(), 'giou_loss': AverageMeter(),
            'conf_loss': AverageMeter(), 'class_loss': AverageMeter(),
            'loss_per_branch': [AverageMeter() for _ in range(3)],
        }
        self._rng = torch.Generator(device=self.device).manual_seed(42 + self._rank)

    def _make_step(self):
        """(step, optimizer) of the config, for the QAT phase the trainer is
        in; at ``train.unroll_steps`` K > 1 the step takes a group of K
        stacked batches (``make_multi_step``)."""
        step, optimizer = train_step_from_config(
            self.network, self.config, self.steps_per_epoch, device=self.device,
            observing=self._observing, bn_frozen=self._bn_frozen, group=self._group,
            spatial=self._spatial)
        if self._unroll > 1:
            step = make_multi_step(step, self._unroll)
        return step, optimizer

    # ----------------------------------------------------------------- eval

    def make_predict_fn(self):
        """(batch dict) -> list of per-image (M, 6) numpy detections, through
        the predict pipeline (built once) on this epoch's BN-folded params;
        under QAT through the int8 model converted from this epoch's params
        and observers (a pipeline built anew each eval: the act scales move
        while the observers run)."""
        if self._quant:
            qparams = convert_to_int8(self.network, self.params, self.state)
            int8 = Int8Inference(self.network, mode='kernel')
            run = build_predict_pipeline(self.network, self.config, apply_fn=int8.apply,
                                         device=self.device)
            return make_batch_predict(run, Int8Inference.prepare(qparams, mode='kernel',
                                                                   network=self.network))
        if self._eval_run is None:
            self._eval_run = build_predict_pipeline(
                self.network, self.config, compute_dtype=self._compute_dtype,
                device=self.device)
        fused = inference_params(self.network, self.params, self.state)
        return make_batch_predict(self._eval_run, fused)

    def evaluate(self):
        evaluator = Evaluator(self.make_predict_fn(), self.eval_data, self.config)
        ap = evaluator.evaluate()
        self.AP = ap
        self._log(format_ap_table(ap, verbose=False))
        return ap


    # ------------------------------------------------------------------ save

    def save(self, epoch: int):
        name = f'{self._weight_base_name}-{epoch}.ckpt' if self.AP is None \
            else f'{self._weight_base_name}-{epoch}-{self.AP.AP:.4f}.ckpt'
        path = os.path.join(self._weights_dir, name)
        save_checkpoint(path, self.network.graph, self.params, self.state,
                        step=self.global_step, cfg_text=self.cfg_text,
                        ap=None if self.AP is None else self.AP.AP,
                        ckpt_type='qat' if self._quant else 'normal',
                        backend='int8' if self._quant else 'none')
        return path

    # ----------------------------------------------------------------- train

    def _flush_metrics(self, epoch: int, pending, final: bool = False):
        """Bring the buffered per-step metrics to the host in one copy,
        update the meters (raising on a non-finite loss, with the head
        inputs' max |act| history when the step probes them) and, unless
        ``final``, print the dashboard line."""
        if not pending:
            return
        names = tuple(pending[0].keys())
        missing = set(CORE_METRICS) - set(names)
        if missing:
            raise KeyError(f'train step metrics missing {sorted(missing)}')
        cols = [torch.stack([m[n].reshape(-1).float() for m in pending]) for n in names]
        widths = [c.shape[1] for c in cols]
        host = torch.cat(cols, dim=1).cpu().numpy()
        pending.clear()
        per = dict(zip(names, np.split(host, np.cumsum(widths)[:-1], axis=1)))
        for k in range(len(host)):
            loss_val = float(per['loss'][k, 0])
            if not np.isfinite(loss_val):
                msg = f'NaN in loss near step {self.global_step}'
                if 'head_max' in per:
                    hist = per['head_max']
                    fin = np.isfinite(hist).all(axis=1)
                    first_bad = int(np.argmax(~fin)) if (~fin).any() else -1
                    msg += (f'; head-input max|act| per scale, last finite rows '
                            f'{np.round(hist[fin][-3:], 1).tolist()}, first non-finite '
                            f'step {first_bad}/{len(hist)} of the flushed interval')
                raise RuntimeError(msg)
            for name in names:
                if name == 'loss_per_branch':
                    for i, v in enumerate(per[name][k]):
                        self.losses[name][i].update(float(v))
                elif name != 'head_max':
                    self.losses.setdefault(name, AverageMeter()).update(float(per[name][k, 0]))
        if not final:
            vals = {k: v.get_avg_reset() for k, v in self.losses.items()
                    if not isinstance(v, list)}
            branch = [b.get_avg_reset() for b in self.losses['loss_per_branch']]
            lr = float(self.schedule(self.global_step))
            self._log(f'lr: {lr:.6f}\tepoch: {epoch}/{self._max_epochs}\t'
                  f'step: {self.global_step}\t'
                  f'train_loss: {vals["loss"]:.2f}='
                  f'{branch[0]:.2f}+{branch[1]:.2f}+{branch[2]:.2f}'
                  f'(xy: {vals["giou_loss"]:.2f}, conf: {vals["conf_loss"]:.2f}, '
                  f'cls: {vals["class_loss"]:.2f})')

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor: pinned host memory and a
        non-blocking copy on the card."""
        t = torch.from_numpy(array)
        if self.device.type == 'cuda':
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _put_batch(self, batch):
        return {k: tuple(self._upload(a) for a in v) if isinstance(v, tuple)
                else self._upload(v) for k, v in batch.items()}

    # ---------------------------------------------------- the device corpus

    def _build_device_cache(self):
        """Decode and letterbox every train image once, at the largest input
        size, into one uint8 tensor on the device, uploaded in ~64 MB chunks
        (the GT rows beside it); ``cache_info`` holds its images, GiB and
        build seconds."""
        data = self.train_data
        smax = max(h for h, _ in sizes_fix(self.config.train.input_sizes))
        key = (self.config.dataset.train_txt_file, self.config.dataset.name, smax,
               data._max_gt, str(self.device))
        hit = Trainer._CACHE_MEMO.get(key)
        if hit is not None:
            self._device_cache, self.cache_info = hit, hit['info']
            self._log(f'device cache: reusing the device-resident corpus '
                  f'({hit["img"].shape[0]} images at {smax}px)')
            return
        t0 = time.perf_counter()
        n = data._num_imgs
        img = torch.empty((n, smax, smax, 3), dtype=torch.uint8, device=self.device)
        gt = np.zeros((n, data._max_gt, 6), np.float32)
        chunk = max(1, (64 << 20) // (smax * smax * 3))
        with ThreadPoolExecutor(max_workers=max(self._num_workers, 1)) as pool:
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                imgs = np.empty((hi - lo, smax, smax, 3), np.uint8)
                for j, (im, g) in enumerate(pool.map(
                        lambda i: data.build_sample(i, (smax, smax), None), range(lo, hi))):
                    imgs[j], gt[lo + j] = im, g
                img[lo:hi].copy_(torch.from_numpy(imgs))
        self.cache_info = {'images': n, 'gib': img.numel() / 2 ** 30,
                           's': time.perf_counter() - t0}
        self._device_cache = {'img': img, 'gt': torch.from_numpy(gt).to(self.device),
                              'smax': smax, 'info': self.cache_info}
        Trainer._CACHE_MEMO.clear()     # at most one resident corpus
        Trainer._CACHE_MEMO[key] = self._device_cache
        self._log(f'device cache built: {n} images at {smax}px ({self.cache_info["gib"]:.3f} '
              f'GiB on {self.device}) in {self.cache_info["s"]:.1f} s')

    def _cache_gather(self, size: int, idx: torch.Tensor) -> dict:
        """The cache rows ``idx`` at ``size``: a smaller size is resized
        bilinearly without antialias (cv2's INTER_LINEAR, which the host
        letterbox uses, does not antialias), rounded and clipped to uint8,
        and its boxes scaled, as the JAX trainer's ``jax.image.resize``
        gather does."""
        cache = self._device_cache
        imgs = cache['img'].index_select(0, idx)
        gts = cache['gt'].index_select(0, idx)
        if size != cache['smax']:
            r = size / cache['smax']
            x = F.interpolate(imgs.permute(0, 3, 1, 2).float(), size=(size, size),
                              mode='bilinear', align_corners=False, antialias=False)
            imgs = x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
            gts = torch.cat([gts[..., :4] * r, gts[..., 4:]], dim=-1)
        return {'image': imgs, 'gt': gts}

    def _cached_batches(self):
        """The epoch's device batches gathered from the device corpus: this
        rank's rows of each global batch, with ``partner_rows`` fresh
        partner rows per sample of the GLOBAL batch when the chain wants
        them (uniform corpus rows, the JAX trainer's draws; every rank draws
        and gathers them all, since the step augments the global batch)."""
        data = self.train_data
        prng = np.random.RandomState(self.config.system.seed + 7)
        for k, rows in enumerate(data.batch_indices()):
            size = int(data._sizes[k][0])
            idx = np.asarray([data._indexes[i] for i in rows], np.int64)
            batch = self._cache_gather(size, self._upload(idx))
            if self._partner_rows:
                pidx = prng.randint(0, data._num_imgs,
                                    size=self._partner_rows * len(rows) * self._n_data)
                pb = self._cache_gather(size, self._upload(pidx.astype(np.int64)))
                batch.update(partner_image=pb['image'], partner_gt=pb['gt'])
            yield batch

    def _host_batches(self):
        """The epoch's host batches from the configured loader."""
        if self._proc_loader is not None:
            return self._proc_loader.epoch()
        return epoch_batches(self.train_data, self._num_workers,
                             prefetch=self.config.system.prefetch)

    def _epoch_batches(self):
        """The epoch's batches on the device: gathered from the device
        corpus, or loaded on the host and uploaded, in the step loop or by
        the upload thread (``system.device_prefetch``)."""
        if self._device_cache is not None:
            yield from self._cached_batches()
            return
        depth = self.config.system.device_prefetch
        if depth > 0:
            yield from self._prefetched(self._host_batches(), depth)
            return
        host_batches = self._host_batches()
        try:
            for host_batch in host_batches:
                yield self._put_batch(host_batch)
        finally:
            host_batches.close()

    def _prefetched(self, host_batches, depth: int):
        """Device batches uploaded by a background thread, at most ``depth``
        ahead of the consumer. On the card the copies run on a side stream;
        each batch carries the event recorded after its copies, the
        consumer's stream waits on it and the batch's memory is marked as
        used there, so the step never reads a half-copied batch and the
        allocator never hands the memory back early. An abandoned consumer
        sets the stop event, drains the queue and joins the thread, and the
        host loader is closed."""
        q = queue.Queue(maxsize=depth)
        stop = threading.Event()
        err = []
        cuda = self.device.type == 'cuda'
        side = torch.cuda.Stream(self.device) if cuda else None

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for host_batch in host_batches:
                    if cuda:
                        with torch.cuda.stream(side):
                            batch = self._put_batch(host_batch)
                            done = torch.cuda.Event()
                            done.record(side)
                    else:
                        batch, done = self._put_batch(host_batch), None
                    if not put((batch, done)):
                        return
            except BaseException as e:      # raised again in the consumer
                err.append(e)
            finally:
                put(None)

        t = threading.Thread(target=work, daemon=True, name='device-prefetch')
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                batch, done = item
                if cuda:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(done)
                    for v in batch.values():
                        for tensor in v if isinstance(v, tuple) else (v,):
                            tensor.record_stream(stream)
                yield batch
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
            host_batches.close()
        if err:
            raise err[0]

    def _draws(self, batch: dict, step: int):
        """The device-augment draws of the global batch of global step
        ``step`` (this rank's batch is a 1/W slice of it), from
        ``np.random.default_rng((system.seed, step))``, on the device."""
        B, S = batch['image'].shape[0] * self._n_data, batch['image'].shape[1]
        partners = batch['partner_image'].shape[0] // B if 'partner_image' in batch else 0
        gen = np.random.default_rng((self.config.system.seed, step))
        return draw_augment(gen, B, S, partner_rows=partners).to(self.device)

    def _grouped_batches(self):
        """The epoch's device batches in groups of ``train.unroll_steps``
        (the plan gives a group one size), each batch with its
        device-augment draws, those of its own global step; a ragged last
        group is padded with its last batch, as the JAX trainer does
        (defensively: the plan rounds the epoch up to whole groups)."""
        group = []
        for batch in self._batches:
            if self._augment:
                batch['draws'] = self._draws(batch, self.global_step + len(group) + 1)
            group.append(batch)
            if len(group) == self._unroll:
                yield group
                group = []
        if group:
            yield group + group[-1:] * (self._unroll - len(group))

    def train_epoch(self, epoch: int):
        """One epoch of steps (of groups of ``train.unroll_steps`` steps,
        each group one call of the step); returns the host seconds spent
        waiting for batches (``data_load_s``) and in the step calls
        (``model_s``)."""
        pending = []
        in_flight = []
        k = self._unroll
        self.dataload_tt.tic()
        self._batches = self._epoch_batches()
        for group in self._grouped_batches():
            self.global_step += k
            self.dataload_tt.toc()

            self.model_tt.tic()
            if k == 1:
                self.params, self.state, self.opt_state, metrics = self.step_fn(
                    self.params, self.state, self.opt_state, group[0], self._rng)
                pending.append(metrics)
            else:
                self.params, self.state, self.opt_state, metrics = self.step_fn(
                    self.params, self.state, self.opt_state, stack_batches(group),
                    [self._rng] * k)
                pending.extend({n: v[j] for n, v in metrics.items()} for j in range(k))
            if self.device.type == 'cuda':
                done = torch.cuda.Event()
                done.record()
                in_flight.append(done)
                if len(in_flight) > self.PIPELINE_DEPTH:
                    in_flight.pop(0).synchronize()
            self.model_tt.toc()

            if self.global_step % self._print_interval < k:
                self._flush_metrics(epoch, pending)
            self.dataload_tt.tic()
        self._batches = None
        self._flush_metrics(epoch, pending, final=True)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

        self.train_data.init_shuffle()

        if self._sparse:
            gammas = np.sort(np.concatenate([
                self.params[i]['bn']['gamma'].abs().cpu().numpy() for i in self._sparse_ids]))
            idx = [round(i / 5 * len(gammas)) - 1 for i in range(1, 6)]
            self._log('sparse level: {}'.format(gammas[idx].tolist()))

        split = {'data_load_s': self.dataload_tt.sum_reset() / 1e9,
                 'model_s': self.model_tt.sum_reset() / 1e9}
        self._log('data load time: {data_load_s:.3f}s, model train time: {model_s:.3f}s'.format(
            **split))
        return split

    def train(self):
        interval = max(int(self.config.eval.interval), 1)
        for epoch in range(self.init_epoch, self._max_epochs):
            self.AP = None
            if self._quant:
                q = self.config.quant
                flags = (epoch < q.disable_observer_after, epoch >= q.freeze_bn_after)
                if flags != (self._observing, self._bn_frozen):
                    self._observing, self._bn_frozen = flags
                    self.step_fn = self._make_step()[0]
            self.epoch_tt.tic()
            self.train_epoch(epoch)
            self.epoch_tt.toc()
            self._log('{:.3f}s per epoch'.format(self.epoch_tt.sum_reset() / 1e9))

            # eval and checkpoints on rank 0; the params are the same on all
            if self._rank == 0:
                due = epoch >= self._eval_after and (epoch - self._eval_after) % interval == 0
                if due or (epoch == self._max_epochs - 1 and epoch >= self._eval_after):
                    self.evaluate()
                self.save(epoch)
            barrier(self._group)

    def run(self):
        """init_all and train; the loaders' threads and processes end with
        the run (the params stay, for the caller to read)."""
        os.makedirs(self._weights_dir, exist_ok=True)
        if self._quant:
            self._log('quantization aware training')
        self.init_all()
        try:
            self.train()
        finally:
            self._close_loaders()

    def run_prune(self, prune_weight: str):
        """Fine-tune a pruned checkpoint, the JAX trainer's preset: the
        pruned cfg (``prune.new_cfg``) resumed from ``prune_weight`` with its
        history cleared, lr x 0.2 without warm-up, ``prune.finetune_epochs``
        epochs, sparse training off, an eval after every epoch, checkpoints
        named ``pruned-<ratio in %>-model-<epoch>[-<AP>].ckpt``."""
        cfg = copy.deepcopy(self.config)
        cfg.model.cfg_path = cfg.prune.new_cfg
        cfg.train.learning_rate_init = self.config.train.learning_rate_init * 0.2
        cfg.train.warmup_epochs = 0.0
        cfg.train.max_epochs = int(cfg.prune.finetune_epochs)
        cfg.weight.backbone = ''
        cfg.weight.resume = prune_weight
        cfg.weight.clear_history = True
        cfg.eval.after = 0
        cfg.sparse.switch = False
        self.__init__(cfg, device=self.device)
        self._weight_base_name = f'pruned-{round(cfg.prune.ratio * 100)}-model'
        self.run()

    def run_nas(self, cfg_text: str) -> float:
        """Short-train a NAS candidate and return its AP, the JAX trainer's
        preset: the candidate's cfg text, warm-up 0.5 epochs, epochs 0 to
        ``eval.after``, then one eval. A non-finite loss raises ``NaN in
        loss near step N``. What the candidate held is released whatever
        happens (``close``)."""
        self.config = copy.deepcopy(self.config)
        self.config.train.warmup_epochs = 0.5
        self.cfg_text = cfg_text
        self.init_all()
        try:
            for epoch in range(0, self._eval_after + 1):
                self.train_epoch(epoch)
                if epoch >= self._eval_after:
                    return shared_ap(self)
            return 0.0
        finally:
            self.close()

    def _close_loaders(self):
        """End the running epoch's loader and upload threads and the
        process pool with its slabs."""
        batches, self._batches = self._batches, None
        if batches is not None:
            batches.close()
        loader, self._proc_loader = self._proc_loader, None
        if loader is not None:
            loader.close()

    def close(self):
        """Release what the run holds: the running epoch's loader threads
        and upload thread (an epoch left by an exception), the process pool
        and its slabs, the params, BN state, optimizer state, the step and
        the eval pipeline. The device corpus stays in ``_CACHE_MEMO`` for
        the next trainer."""
        self._close_loaders()
        self.params = self.state = self.opt_state = None
        self.step_fn = self.optimizer = None
        self._eval_run = self._device_cache = self._rng = None


def shared_ap(trainer) -> float:
    """``trainer.evaluate().AP`` on every rank of the process group: rank 0
    evaluates and broadcasts it (the params are the same on all); an eval
    that raises on rank 0 raises ``RuntimeError`` with its message on every
    rank."""
    if world() == 1:
        return trainer.evaluate().AP
    ap, err = None, None
    if rank() == 0:
        try:
            ap = float(trainer.evaluate().AP)
        except Exception as e:      # raised below, on every rank
            err = f'{type(e).__name__}: {e}'
    ap, err = broadcast_object((ap, err))
    if err is not None:
        raise RuntimeError(f"rank 0's eval failed: {err}")
    return ap
