#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pqdet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from pqdet_tpu_torch/csrc with nvcc (sm_90a), then:

1. prints the card (nvidia-smi name, power limit), torch and CUDA versions,
   the build time and ptxas's registers, shared memory and spills of each
   kernel;
2. holds the Triton decode kernel to its plain version on the card: the
   three heads of mobilenetv2-fpn at 512x512 (B=4, bf16 and f32) decoded
   by one launch into the concatenated preds, with and without exp_cap,
   and single heads with an odd H (rtol = atol = 1e-5; for a box
   coordinate relative to its operands, see decode_tolerance);
3. holds the CUDA fused inverted-residual kernel to fused_ir_reference on
   the card, at all 21 chain shapes of mobilenetv2-fpn at 512x512, B=1 and
   B=4, at EDGE_CHAINS (13x13 and 20x12 inputs, Cin 24, E 144 over a
   cluster, P 24/160/1024, a bare pair), plus raised biases for the
   zero-pad domain (tol 0.02*max(1,|r|), median below tol/4), printing
   each launch plan (pixel tile, cluster, K step, stages);
4. serves mobilenetv2-fpn (20 classes, 3 anchors, 512x512, random weights
   and BN statistics from a seed, BN folded, bf16, fused-IR table of 21
   chains) through build_predict_pipeline: 16 requests of 4 uint8
   images. The kernels' launch counts are set to 0 just before and read
   just after; each must be exactly 21 (fused IR) and 1 (decode, all
   three heads) per forward. The kernel path's preds are compared with the
   plain fused path on the card (scores 0.03, boxes 1.5 px) and with the
   cuDNN layer walk (scores 0.03, boxes 3 px), and every detection must be
   finite;
5. times, with CUDA events after warm-up, requests at B=1 and B=4 and each
   stage of a B=4 request alone (normalize, forward, recover, NMS, copy to
   the host); and as device time (calls captured in a CUDA graph), each
   kernel per forward, its plain version, and for the fused chains three
   cuDNN convs with bias and activation as the library yardstick (biases
   cast to bf16 once, outside the timing); the decode as its one launch
   and as the earlier form, a launch per head and a concatenation; per
   chain the plan, the clusters the card holds at once and the kernel's
   ptxas report; a
   torch.profiler trace of B=4 requests gives the device's busy share and
   its top kernels;
6. holds the CUDA int8 kernels to their plain versions on the card, at
   every conv shape of the int8 mobilenetv2-fpn graph at 512x512 (the 33
   pointwise shapes, the stem's im2col shape with K = 27 padded to 32, the
   13 depthwise shapes at strides 1 and 2), at QCONV_EDGE_SHAPES (M below
   a tile, ragged M, N 75, the raw K 27, split-K with a ragged M) and
   DW_EDGE_SHAPES (C 27, 75 and 20 at both strides, W not a multiple of
   the tile, a 2x2 stride-2 input), at B=1 and B=4, with f32 output and
   requantised output, with integer zero points: every output equal to
   its plain version bit for bit; each line names its plan. Fractional
   zero points (the depthwise kernel's exact-order path) are held to s8
   codes equal or 1 apart on under 0.1 % of the elements and f32 within
   1e-5 * max(1, |r|);
7. serves the int8 path: the quant graph of mobilenetv2-fpn (relu) with
   seeded weights and BN statistics, calibrated by 4 observer passes
   (prepare_qat_state + QuantCtx) on seeded uint8 images, converted by
   convert_to_int8, run by Int8Inference in kernel mode through
   build_predict_pipeline(apply_fn=...): 16 requests of 4 images. The
   launch counts are set to 0 just before and read just after; per
   forward they must be exactly 58 qconv1x1_s8 (57 pointwise + the stem),
   26 qdwconv3x3_s8 and 1 decode. The kernel path is held to apply(...,
   plain=True) node by node (the phase 6 bound) and on the preds (scores
   0.02, boxes 1 px); every detection must be finite. The int8 preds
   against the bf16 fp path on the same weights are printed, not gated;
8. times the int8 path: requests at B=1 and B=4, each stage of a B=4
   request, a profiler trace; and per B=4 forward, each int8 kernel's
   device time from CUDA graphs, its plain version's, its bound and a
   library yardstick (torch._int_mm + the epilogue as torch ops; cuDNN's
   f32 depthwise conv + the epilogue), with the plan and ptxas report;
9. the training step of the full-width mobilenetv2-fpn (seeded random
   weights, 20 classes), built by train_step_from_config from the port's
   train config (train_config): one f32 step on the card against the same
   step on the CPU, with batch statistics at 256x256 (loss and parts 1e-3,
   grads by relative L2 distance 0.5 and leaf cosine 0.9, BN state 1e-2,
   and the direction of 90 % of the moved params; the walk with batch
   statistics amplifies rounding, see tests/test_torch_train_parity.py, so
   the effective grads' and params' distances and the count of params over
   1e-2 lr apart are held within 2x those of the CPU's own step on the
   reversed batch) and with running statistics at 128x128 (loss 1e-4,
   grads 1e-3 of each element plus 1e-4 of the largest), B=2; then 30 bf16
   steps at 512x512, B=12, device labels from seeded padded GT (up to 64
   boxes an image), head_probe on, on one fixed batch under a 5-step
   warmup: every loss and head_max finite, the mean loss of the last 5
   steps below that of the first 5, BN running means moved; one step at
   320x320 and 608x608 (finite); the same step at remat 4 and 0 (loss
   within 1e-3, effective grads 5e-2 and params 5e-2 of the update by
   relative L2, BN state 1e-5; lower peak memory at remat 4); one
   forward_train without targets at B=2 under grad, whose preds' sum
   backpropagates to finite grads. The four kernels' launch counts stay 0
   through all of it, and each wrapper raises on a CUDA tensor that
   requires grad;
10. the training timings: ms per step p50 and p90 (CUDA events, after the
   5 warm-up steps), images/s, peak memory at remat 0 and 4, the step by
   stage (labels, forward and loss, backward, optimizer) and a profiled
   step (device idle share, top kernels, host launches);
11. the trainer entry point: synth_shapes writes 128 images (sides
   307-715 px, 96 train, 32 eval) into a temporary directory;
   Trainer(cfg).run() trains mobilenetv2-fpn (3 classes, full width) from
   yamls/shapes.yaml (batch 16, sizes 416-512, lr 4e-4, bf16, the host
   augment chain) for 3 epochs, evaluating AP after epochs 1 and 2. Gates:
   every step loss finite; the mean loss of epoch 2 below epoch 0's; each
   AP finite in [0, 1]; 0 kernel launches in every epoch's steps and one
   decode_heads launch per eval batch (counts set to 0 before each epoch
   and each evaluation); three checkpoints, named with the AP where the
   epoch evaluated; the last one loads the trainer's params and BN state
   bit for bit; a second trainer resumed from the epoch-1 checkpoint
   starts at step 12 with the lr of schedule(12) and Adam's count 0, and
   trains epoch 2 with finite losses on the first run's epoch-2 plan; the
   trainer's eval (bf16, the decode kernel) gives at least 0.99 of the
   detections of the same pipeline with the plain decode on the same
   params (box, score and class to 1e-3), and the evaluator scores the
   eval split's own boxes at AP 1; the predict CLI on an eval image exits
   0 with finite detections. A timed run then trains 2 epochs of 300 more
   images at phase 10's B=12 and 512x512 (25 steps an epoch, metrics
   flushed every 5). Prints seconds, the trainer's data-load and model
   split and images/s per epoch, those of the timed run's epoch 1 against
   phase 10's bare step, the first step at each input size, each
   evaluation's seconds and the phase's seconds;
12. the QAT arc: Trainer(cfg).run() of yamls/shapes_quant.yaml (full-width
   mobilenetv2-fpn, 3 classes, B=16, 512x512, lr 5e-5) resumed from phase
   11's last checkpoint into the quant graph on phase 11's corpus, 3
   epochs: epoch 0 observes with BN on batch statistics, epoch 1 freezes
   the observers, epoch 2 BN as well, and the converted int8 model is
   evaluated after every epoch (Int8Inference kernel mode). Gates: finite
   losses; 0 kernel launches in the QAT steps and, per eval forward, 58
   qconv1x1_s8, 26 qdwconv3x3_s8 and 1 decode_heads (counts set to 0
   before each epoch and each evaluation); all 98 observers initialised
   with a real range after epoch 0, unchanged bit for bit across epoch 1
   (while BN moves), and they and the BN statistics unchanged bit for bit
   across epoch 2; three qat checkpoints; the trainer's int8 eval against
   the same qparams through the plain versions (at least 30 of 32 images
   identical and 0.999 of the plain detections found; the edges' zero
   points printed); the convert CLI (quantize) on the last checkpoint
   gives the qparams the trainer converted in memory bit for bit, and
   convert_to_int8 on the card equals the CPU's bit for bit (the BN fold,
   wq, w_scale, b, the edges' scales and zero points; torch's f32 ops of
   the fold printed op by op); the bench CLI (eval) on that file prints
   the trainer's last AP exactly; the card's f32 QAT walk against the
   CPU's node by node, with BN and observers frozen at 128x128 and with
   batch statistics and observers updating at 256x256: each node from the
   CPU walk's inputs to it, its codes, output or loss, new observer and BN
   statistics, and every grad of its VJP within the QAT_NODE_* bounds,
   and the whole walk's loss parts (and new observers) within 2x a drift
   of the same step with its sums in another order (its grads printed:
   a moved code moves codes downstream, so the whole walk's grads drift).
   Prints each epoch's and eval's seconds, the CLIs' seconds, and
   the bf16 QAT step at B=12, 512x512 with observers on and off (ms p50
   and p90, peak memory, a profiled step's launches and idle share)
   beside phase 10's fp step;
13. device augmentation and the device corpus: (a) ``device_augment`` on
   the card against the port's CPU run with the same draws, B=16 at
   512x512, every stage on (flips, zoom-crop, colour jitter, mosaic,
   mixup), in-batch and with 4B fresh partner rows, each with TF32 allowed
   for matmuls and not, under ``torch.cuda.set_sync_debug_mode('error')``
   (no device-to-host sync, the draws' upload included): boxes within
   1e-4, images bit for bit without the warp (crop_p 0) and within one
   level on at most 1e-3 of the pixels with it (the share printed);
   (b) ``cli.train`` on yamls/shapes.yaml as shipped (``augment.device
   on``; data and weight paths, 3 epochs and eval.after 1 overridden) on
   phase 11's corpus; (c) ``cli.train`` on yamls/clutter.yaml as shipped
   (the device corpus, fresh partners, mosaic and mixup 0.5) on 320
   synth_clutter images at 512 (281 train), printing the corpus's GiB and
   build seconds and the first batch's partner rows, which must be JAX's
   ``RandomState(system.seed + 7)`` draw; (d) one QAT epoch of
   yamls/shapes_quant.yaml with ``augment.device on`` from (b)'s last
   checkpoint. Gates of (b)-(d): finite losses, params moved, 0 kernel
   launches in the steps, one decode_heads launch per eval batch; each
   epoch's seconds and images/s against phase 11's host-augment epochs;
   phase 11's timed run again with the device chain, from the loader and
   from the device corpus (images/s against the bare step's and the host
   chain's). (e) the bf16 step at B=12, 512x512 without device augment and with the
   shapes.yaml and clutter.yaml chains (ms p50/p90, a profiled step), and
   each chain alone (ms a call, device busy, launches);
14. the slimming-prune arc: (a) phase 11's last checkpoint pruned at 0.3
   (``compress/prune.py``); every fused chain of the pruned graph (19
   where the unpruned has 21, E of 8 mod 16 flagged) and every int8 conv
   shape at B=4, 512x512 against the plain versions with phase 3's
   tolerance and bit for bit (phase 6's check); (b) a seeded full-width
   mobilenetv2-fpn with one in three channels of each prunable conv dead
   (gamma = beta = 0, the depthwise convs reading them with mean and beta
   0 there), served in bf16 through the kernels before and after pruning
   at 0.1: preds within scores 0.03 and boxes 3 px, each forward launching
   its graph's chains and one decode; (c) the arc through the port's CLIs
   in this process on phase 11's corpus from its last checkpoint, at
   512x512: ``cli.train`` sparse for 1 epoch, ``cli.prune`` (ratio 0.3, its
   test through the fused-IR kernel, 2 fine-tune epochs), ``cli.train``
   QAT on the pruned cfg for 2 epochs, ``cli.convert quantize``, ``cli.bench
   eval`` in kernel mode and with ``--int8-exact``, ``bench summary``,
   ``time`` (bf16 with a trace, f32) and ``benchmark``. Gates: the raw
   ``-pruned.ckpt`` beside the sparse checkpoint and out of discovery,
   ``pruned-30-model-<e>-<AP>.ckpt`` from the fine-tune, checkpoint types
   qat then quant, the trainers' gates of phase 13 with the launches per
   eval forward counted from the pruned graph, and the kernel mode's
   detections against ``--int8-exact``'s (phase 12's bounds); (d) phase
   11's checkpoint against (a)'s pruned model: bf16 and int8 requests at
   B=4 in turns, each forward on the device alone (CUDA graph), each
   kernel's device ms per forward at the pruned shapes with its plain
   version, library yardstick and bound, MACs and params, the arc's images/s
   and CLI seconds, and the phase's seconds;
15. the exporters (``phase15_exporters``, in the same temporary directory),
   at B=1 and B=4, 512x512, from phase 4's seeded fp weights and phase 7's
   calibrated int8 model: (a) the fp ``torch.export`` program
   (``export_stablehlo``) with and without NMS and (b) the int8 programs
   (``export_stablehlo_quant``) in ``'int'`` and ``'kernel'`` mode, each
   saved, loaded here and in a fresh process that imports only
   pqdet_tpu_torch (``load_artifacts``), and held to its eager path bit
   for bit: the plain f32 walk (and ``nms_batch``), ``Int8Inference(mode=
   'int').apply(plain=True)``, ``Int8Inference(mode='kernel')``. The fp and
   ``'int'`` graphs must hold no operator of the port's namespace and
   launch no kernel; the ``'kernel'`` graph must hold 58 ``qconv1x1_s8``,
   26 ``qdwconv3x3_s8`` and 1 ``decode_heads`` operators and launch them
   each call (counted here and in the fresh process; the calls here count
   in the kernels line); (c) ``cli.convert onnx`` of the two weights saved
   as checkpoints, run by ``onnx_runtime.run_model`` on the card: fp within
   1e-4 (rtol = atol) of the eager f32 walk, quant within
   tests/test_onnx.py's medians of the ``'int'`` mode; (d) ``cli.convert
   darknet``, read back by ``load_weights_darknet`` into other weights on
   the card, every array bit for bit, and ``cli.convert partial``; (e)
   export, load (here and fresh) and ONNX seconds, file sizes, and
   ``bench time --shlo`` of each artifact beside its eager path (the same
   CUDA-event timer);
16. the RegNet zoo and grouped convs (``phase16_regnet``, in the same
   temporary directory), at 512x512, B=4: (a) every int8 conv shape of the
   int8 graphs of regnetx-600m-fpn and regnety-400m-fpn (the densified
   grouped 3x3s as im2col patches into qconv1x1_s8 at K = 9 * Cin up to
   4752, the SE squeeze and excite 1x1s at M = B) and the depthwise shapes
   of regnetx-600m-yolo against the plain versions bit for bit (phase 6's
   check), and its 9 fused chains (Cin to 1024, E 512) at B=1 and 4 with
   phase 3's tolerance; (b) regnetx-600m-fpn, regnety-400m-fpn and
   regnetx-600m-yolo with seeded weights (gain REGNET_GAIN) served in bf16
   (grouped convs densified, the fused-IR table) and in int8 (4 observer
   passes, convert_to_int8, Int8Inference kernel mode with
   ``prepare(network=)``), 8 requests of B=4 each: launches per forward
   equal to the graph's count (int8: one qconv1x1_s8 per conv that is not
   depthwise, one qdwconv3x3_s8 per depthwise conv, 1 decode; bf16: the
   chains and 1 decode), node by node against ``plain=True`` (bf16: every
   node before the first chain bit for bit, preds within phase 4's bounds;
   int8: phase 7's bounds), finite detections; (c) the regnetx-600m-fpn
   train step on grouped cuDNN convs: phase 9's f32 card-against-CPU
   parity, then 10 bf16 steps at B=12 on one batch (finite, loss falling,
   BN moved, no kernel launched); (d) one epoch of ``cli.train`` on phase
   11's corpus from a copy of yamls/shapes.yaml with ``model.cfg_path:
   regnetx-600m-fpn`` at 512 only, evaluated (phase 13's trainer gates),
   its checkpoint in the JAX package's layout loaded back strictly; (e)
   request p50/p90 of each model in bf16 and int8, the forward on the
   device alone (CUDA graph) in bf16 densified, bf16 with grouped cuDNN
   convs and int8, each kernel's device ms per forward at the RegNet
   shapes, MACs grouped against densified, and (c)'s step p50 and peak
   memory;
17. learning, NAS search and evolution (``phase17_nas_evolution``, in the
   same temporary directory): (a) both tasks of tests/test_learning.py
   through the port's Trainer at the test's sizes (24 squares at 96 px, 14
   f32 epochs: AP50 > 0.5; 12 sparse epochs, a 30 % prune and 6 fine-tune
   epochs: AP50 > 0.4) with phase 13's trainer gates; (b) the three
   candidates of ``generate_candidates(3, seed=0)`` (candidate 1's head
   has group width 1: 12 fused chains, E 32, 112 and 144) and
   mobilenetv2-fpn at 352x352 (grids 44/22/11) and the candidates at
   512x512: every fused chain against fused_ir_reference (phase 3's
   tolerance), the decode against its plain version with exp_cap 40, each
   model served in bf16 with seeded weights (4 requests of B=4, launches
   per forward from the graph, node by node against plain=True as phase
   16 (b)), and the chains' device ms; (c) ``cli.search`` in process on
   yamls/nas_clutter.yaml and phase 13's clutter corpus, 3 candidates of
   seed 0 with every candidate's B=1 latency measured on the card: the
   log's records with JAX's keys, completed APs in [0, 1], every diverged
   record a NaN loss (any other error fails the phase), at least one
   completed, device memory back within 64 MiB after each candidate apart
   from the corpus memo, the launches (the latency forwards and the evals,
   one decode each); (d) ``cli.evolute`` in process on
   yamls/evolute_clutter.yaml (mobilenetv2-fpn, the device corpus and
   device augmentation), 2 rounds: both recorded with distinct hypers and
   fitness in [0, 1], the same memory gate, one decode per eval batch (the
   trainer's eval runs the layer walk, as JAX's does, so no fused chain);
18. the space-to-depth stem, the rest of the host data and the playground
   (``phase18_s2d_host_data``, in the same temporary directory): (a) phase
   4's model and weights served with ``eval.s2d_stem 2`` through
   make_batch_predict, 8 requests at B=1 and B=4: 21 fused_ir_conv + 1
   decode_heads per forward, the walk node by node against plain=True,
   the preds against s2d_stem 0's (phase 4's bounds), the chains and the
   decode at the path's shapes (phases 3 and 2's checks), the folded stem
   against the stem in f32 (1e-5), request p50/p90, the forward on the
   device alone and the stem's device ms with and without the fold; (b)
   the train step with ``train.s2d_stem 2``: card against CPU at 128x128
   (phase 9's check), the grad of the original stem kernel against
   s2d_stem 0's (rtol 1e-4, atol 1e-6), 10 bf16 steps of each at B=12,
   512x512 in turns; (c) VisDrone as shipped: a seeded VisDrone2019-DET
   corpus at 2000x1500, 1920x1080, 1360x765 and 960x540 (20-300 boxes an
   image, categories 0-11), ``visdrone_txt --seed 0``, one ``cli.train``
   epoch of yamls/visdrone.yaml (regnetx-600m-fpn, batch 30, 256 GT boxes,
   the eval at batch 1 in per-image sizes: one decode_heads launch an
   image), the decode against its plain version at each eval shape, the
   trained model's int8 route (observers, convert_to_int8, Int8Inference
   kernel mode) at each eval image, B=1, conv by conv against plain=True,
   and the decode's and qconv1x1_s8's device ms at those shapes; (d) COCO
   as shipped: a seeded 80-class darknet-txt corpus, one ``cli.train``
   epoch of yamls/coco.yaml (batch 32, the eval at 512, batch 32) and one
   with ``augment.device on`` from the device corpus; (e) phase 11's corpus
   with yamls/shapes.yaml: the host label grids against the device
   assigner's, the process loader's first batches against the thread
   loader's bit for bit, one epoch each of host labels, the process loader
   and both with ``device_prefetch 2`` (whose batches, as its steps read
   them, equal the synchronous epoch's), no worker or /dev/shm slab left
   after close; (f) ``cli.playground`` grids of a VOC, a COCO and a
   VisDrone image into OUTPUT_DIR.

Each phase draws from its own generator, seeded from SEED and the phase
number. It prints one JSON line of kernels, then the nvidia-smi line, and
ends with {"ok": true, "device": {...}}. Any failure exits non-zero before
that line. TF32 is off for cuDNN and matmul throughout, so f32 comparisons
are f32.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
INT8_OP_PER_S = 1979e12        # H100 SXM dense int8 tensor cores
SEED = 0
N_REQUESTS = 16
BATCH = 4
SIZE = 512
N_CALIB = 4


def phase_gen(phase: int):
    """The generator of one phase, seeded from SEED and the phase number, so
    that what a phase draws does not depend on what the phases before it
    drew."""
    import torch
    return torch.Generator().manual_seed(1000 * SEED + phase)


def request_maker(gen, dev, size=None):
    """batch(b): a request of b seeded uint8 images at ``size`` (SIZE) and
    original shapes of 200-900 px, drawn from ``gen``."""
    import torch
    size = size or SIZE

    def batch(b):
        img = torch.randint(0, 256, (b, size, size, 3), generator=gen, dtype=torch.uint8)
        hw = torch.randint(200, 900, (b, 2), generator=gen)
        return {'image': img.to(dev), 'shape': hw.to(dev), 'count': b}
    return batch


# modules the JAX package reads on the trainer's path, and matplotlib, which
# its utils/draw.py plots with: import name, the distributions that may
# carry it
HOST_LIBRARIES = (('cv2', ('opencv-python', 'opencv-python-headless', 'opencv-contrib-python',
                           'opencv-contrib-python-headless')),
                  ('PIL', ('Pillow',)), ('yaml', ('PyYAML',)), ('msgpack', ('msgpack',)),
                  ('numpy', ('numpy',)), ('torchvision', ('torchvision',)),
                  ('matplotlib', ('matplotlib',)))


def host_libraries() -> dict:
    """{import name: distribution version, 'present' or 'absent'} for
    HOST_LIBRARIES, found without importing any of them."""
    import importlib.metadata
    import importlib.util
    libs = {}
    for name, dists in HOST_LIBRARIES:
        libs[name] = 'absent' if importlib.util.find_spec(name) is None else 'present'
        for dist in dists if libs[name] == 'present' else ():
            try:
                libs[name] = importlib.metadata.version(dist)
                break
            except importlib.metadata.PackageNotFoundError:
                pass
    return libs


def smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """ms per call of ``fn``, CUDA events around ``iters`` calls after
    ``warmup``: what a caller waits, host launch costs included."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, replays=5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no host
    launch cost is in it (a small kernel's launch takes longer than its
    run)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def chain_shapes(net, size):
    """(a, b, c, H, Cin, E, P, acts) of each fused chain at input ``size``."""
    from pqdet_tpu_torch.ops.fused_ir import find_fused_triples
    nodes = {n.index: n for n in net.graph.nodes}
    out = []
    for a, b, c in find_fused_triples(net.graph):
        nb, nc = nodes[b], nodes[c]
        cin = nodes[a].in_channels if a is not None else nb.in_channels
        act_e = nodes[a].attrs['activation'] if a is not None else 'linear'
        out.append((a, b, c, size // nb.stride, cin, nb.in_channels,
                    nc.out_channels, (act_e, nb.attrs['activation'],
                                      nc.attrs['activation'])))
    return out


def chain_inputs(gen, n, h, cin, e, p, expand, dev, bias_shift=0.0, w=None):
    import torch

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    x = r(n, h, h if w is None else w, cin).to(dev, torch.bfloat16).contiguous()
    we = r(cin, e, scale=0.2).to(dev, torch.bfloat16) if expand else None
    be = (r(e, scale=0.1) + bias_shift).to(dev) if expand else None
    wdw = r(9, e, scale=0.2).to(dev, torch.bfloat16)
    bdw = (r(e, scale=0.1) + bias_shift).to(dev)
    wp = r(e, p, scale=0.2).to(dev, torch.bfloat16)
    bp = r(p, scale=0.1).to(dev)
    return x, we, be, wdw, bdw, wp, bp


# fused-IR shapes beyond the model's 21 chains: ragged pixel tiles (13x13,
# 20x12), Cin 24 at a 32-deep K step, E 144 cut over a cluster of 5, P
# 24/160/1024, a bare pair; (h, w, cin, e, p, expand, acts)
EDGE_CHAINS = [
    (13, 13, 24, 144, 24, True, ('relu6', 'relu6', 'linear')),
    (13, 13, 32, 144, 160, True, ('leaky', 'relu', 'linear')),
    (20, 12, 24, 144, 1024, True, ('relu', 'logistic', 'relu6')),
    (20, 12, 128, 128, 160, False, ('linear', 'relu6', 'leaky')),
]


def fused_parity(gen, dev, checks, label):
    """The fused-IR kernel against ``fused_ir_reference`` on the card at each
    of ``checks`` ((label, n, h, w, cin, e, p, expand, acts, bias shift)),
    to 0.02 * max(1, |ref|) with the median error under a quarter of it;
    prints each plan and flags E = 8 (mod 16), a half-filled last
    16-channel block. Raises on a disagreement; returns the largest
    error."""
    import torch
    from pqdet_tpu_torch.ops.fused_ir import fused_ir_conv, fused_ir_reference, plan_fused_ir
    worst, failures = 0.0, []
    for name, n, h, w, cin, e, p, expand, acts, shift in checks:
        args = chain_inputs(gen, n, h, cin, e, p, expand, dev, shift, w=w)
        kw = dict(act_e=acts[0], act_dw=acts[1], act_p=acts[2])
        got = fused_ir_conv(*args, **kw).float()
        ref = fused_ir_reference(*args, **kw).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        tol = 0.02 * max(1.0, ref.abs().max().item())
        ok = bool(torch.isfinite(got).all()) and err.max().item() <= tol \
            and err.median().item() < tol / 4
        worst = max(worst, err.max().item())
        pl = plan_fused_ir(n, h, w, cin, e, p, expand)
        odd = ' (E = 8 mod 16)' if e % 16 == 8 else ''
        print(f'{label}: fused chain {name} N={n} H={h} W={w} Cin={cin} E={e}{odd} P={p} '
              f'{"/".join(acts)} bias+{shift} plan tile {pl.th}x{pl.tw} cluster {pl.cluster} '
              f'es {pl.es} ck {pl.ck} stages {pl.stages} reduce {pl.reduce}: max |err| '
              f'{err.max().item():.4g} median {err.median().item():.3g} tol {tol:.3g} '
              f'{"ok" if ok else "FAIL"}')
        if not ok:
            failures.append((name, n, h, w, e, shift))
    if failures:
        raise AssertionError(f'{label}: fused IR kernel disagrees on {failures}')
    return worst


def fused_chain_times(gen, dev, chains, ptx, tag, label):
    """Each fused chain of ``chains`` (``chain_shapes``) at B=BATCH as device
    time from CUDA graphs: the kernel, its plain version and three cuDNN
    convs with bias and activation (the library yardstick), with its bound
    and plan; prints them and the sums per forward and returns the sums
    ({'ms', 'plain_ms', 'bound_ms', 'library_ms', 'call_ms',
    'library_call_ms', 'bound_by'})."""
    import torch
    import torch.nn.functional as F
    from pqdet_tpu_torch.ops._build import load_library
    from pqdet_tpu_torch.ops.fused_ir import (_apply_act, fused_ir_conv, fused_ir_reference,
                                              max_active_clusters, plan_fused_ir)
    fir = dict.fromkeys(('ms', 'plain_ms', 'bound_ms', 'library_ms', 'call_ms',
                         'library_call_ms'), 0.0)
    byte_ms_sum = flop_ms_sum = 0.0
    for a, b, c, h, cin, e, p, acts in chains:
        expand = a is not None
        args = chain_inputs(gen, BATCH, h, cin, e, p, expand, dev)
        x, we, be, wdw, bdw, wp, bp = args
        kw = dict(act_e=acts[0], act_dw=acts[1], act_p=acts[2])
        w_e = we.t().reshape(e, cin, 1, 1).contiguous() if expand else None
        w_dw = wdw.t().reshape(e, 1, 3, 3).contiguous()
        w_p = wp.t().reshape(p, e, 1, 1).contiguous()
        # the biases are cast once, outside the timed calls: the yardstick
        # is three convs with bias and activation, no casts
        be16 = be.to(torch.bfloat16) if expand else None
        bdw16, bp16 = bdw.to(torch.bfloat16), bp.to(torch.bfloat16)
        xc = x.permute(0, 3, 1, 2)                         # channels_last view

        def cudnn_chain():
            y = xc
            if expand:
                y = _apply_act(acts[0], F.conv2d(y, w_e, be16))
            y = _apply_act(acts[1], F.conv2d(y, w_dw, bdw16, 1, 1, 1, e))
            return _apply_act(acts[2], F.conv2d(y, w_p, bp16))

        k_ms = device_ms(lambda: fused_ir_conv(*args, **kw))
        call_ms = cuda_ms(lambda: fused_ir_conv(*args, **kw))
        p_ms = device_ms(lambda: fused_ir_reference(*args, **kw))
        l_ms = device_ms(cudnn_chain)
        l_call_ms = cuda_ms(cudnn_chain)
        by_ms, fl_ms = fused_bound_ms(BATCH, h, cin, e, p, expand)
        fir['ms'] += k_ms
        fir['plain_ms'] += p_ms
        fir['library_ms'] += l_ms
        fir['call_ms'] += call_ms
        fir['library_call_ms'] += l_call_ms
        fir['bound_ms'] += max(by_ms, fl_ms)
        byte_ms_sum += by_ms
        flop_ms_sum += fl_ms
        pl = plan_fused_ir(BATCH, h, h, cin, e, p, expand)
        clusters = max_active_clusters(load_library('fused_ir'), h, h, cin, e, p, expand, pl)
        odd = ' (E = 8 mod 16)' if e % 16 == 8 else ''
        print(f'{label}: {tag} fused chain {a},{b},{c} B={BATCH} H=W={h} Cin={cin} '
              f'E={e}{odd} P={p}: kernel {k_ms:.4f} ms ({call_ms:.4f} ms a call with its '
              f'launch), plain {p_ms:.4f} ms, cuDNN x3 {l_ms:.4f} ms ({l_call_ms:.4f} '
              f'ms a call with its launches), bound {max(by_ms, fl_ms):.5f} ms '
              f'({"operations" if fl_ms > by_ms else "bytes"}); plan tile {pl.th}x{pl.tw} '
              f'cluster {pl.cluster} es {pl.es} ps {pl.ps} pn {pl.pn} ck {pl.ck} stages '
              f'{pl.stages} smem {pl.smem} B, {pl.tiles * pl.cluster * BATCH} CTAs, '
              f'{clusters} clusters resident at once (cudaOccupancyMaxActiveClusters); '
              f'ptxas {ptx.get(f"fused_ir_kernel<{pl.ck}>", "not reported")}')
    fir['bound_by'] = 'operations' if flop_ms_sum > byte_ms_sum else 'bytes'
    print(f'{label}: {tag} fused IR per B={BATCH} forward ({len(chains)} launches): kernel '
          f'{fir["ms"]:.4f} ms, plain {fir["plain_ms"]:.4f} ms, cuDNN x3 '
          f'{fir["library_ms"]:.4f} ms, bound {fir["bound_ms"]:.5f} ms ({fir["bound_by"]}); '
          f'calls with their launches: kernel {fir["call_ms"]:.4f} ms, cuDNN x3 '
          f'{fir["library_call_ms"]:.4f} ms')
    return fir


def ptxas_report(log: str) -> dict:
    """{kernel: 'R registers, S B static smem, spills'} from nvcc's
    -Xptxas=-v output (kernel names demangled to name<template int>)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            for k in ('fused_ir_kernel', 'qconv1x1_kernel', 'qdw3x3_kernel'):
                if k in name:
                    t = re.findall(r'Li(\d+)E', name[name.index(k):])
                    name = f'{k}<{",".join(t)}>' if t else k
            out[name] = {}
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m and name:
            out[name]['spill'] = int(m.group(1)) + int(m.group(2))
        m = re.search(r'Used (\d+) registers(?:.*?(\d+) bytes smem)?', line)
        if m and name:
            out[name]['regs'] = int(m.group(1))
            out[name]['smem'] = int(m.group(2) or 0)
    return {k: f"{v.get('regs', '?')} registers, {v.get('smem', 0)} B static smem, "
               f"{v.get('spill', 0)} B spilled" for k, v in out.items()}


def decode_tolerance(raw, nc, stride, exp_cap, rtol=1e-5, atol=1e-5):
    """Per-element tolerance of a (B, H, W, A, 5+C) decode of ``raw``:
    rtol/atol 1e-5 on the scores; a box (centre -/+ exp(d)) * stride
    cancels where exp(d) ~ centre, so there rtol is taken relative to the
    operands, stride * (centre + exp(d))."""
    import torch
    b, h, w, _ = raw.shape
    r = raw.float().reshape(b, h, w, -1, 5 + nc)
    d = r[..., :4].clamp(max=exp_cap) if exp_cap else r[..., :4]
    cy, cx = torch.meshgrid(torch.arange(h, device=raw.device) + 0.5,
                            torch.arange(w, device=raw.device) + 0.5, indexing='ij')
    centre = torch.stack([cx, cy, cx, cy], -1)[:, :, None, :]
    box = atol + rtol * stride * (centre + torch.exp(d))
    score = atol + rtol * torch.sigmoid(r[..., 4:]).abs()
    return torch.cat([box, score], -1)


def fused_bound_ms(n, h, cin, e, p, expand):
    pix = n * h * h
    flops = 2 * pix * ((cin * e if expand else 0) + 9 * e + e * p)
    nbytes = pix * (cin + p) * 2 + ((cin * e * 2 + e * 4) if expand else 0) \
        + 9 * e * 2 + e * 4 + e * p * 2 + p * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3


def seed_bn(params, state, gen, dev, gain=2.0):
    """Gain 2 on every conv weight and BN statistics as a trained model has
    them. The init's fan-in bound shrinks each layer's output by about
    1/sqrt(3), which fades the activations over the depth and leaves every
    score near 0.25; with the gain they keep their scale. At init the BN
    statistics fold into zero biases, and the kernels' bias paths would go
    untested. (The RegNets' residual stages grow under a gain of 2 until
    exp overflows in the decode; phase 16 takes REGNET_GAIN.)"""
    import torch
    for k, p in params.items():
        p['w'] = p['w'] * gain
        if 'bn' in p:
            c = p['w'].shape[0]
            u = lambda: (0.8 + 0.4 * torch.rand(c, generator=gen)).to(dev)  # noqa: E731
            p['bn'] = {'gamma': u(), 'beta': (0.1 * torch.randn(c, generator=gen)).to(dev)}
            state[k] = {'mean': (0.1 * torch.randn(c, generator=gen)).to(dev), 'var': u()}


def request_times(predicts, batch, b, tag, label, n=20):
    """p50 and p90 ms of each of ``predicts`` ({name: predict}) on requests
    of ``b`` images, CUDA events around each, after two warm-up requests
    each; several models take turns, the order reversed every round.
    Prints them and returns {name: (p50, p90)}."""
    import torch
    reqs = [batch(b) for _ in range(5)]
    for fn in predicts.values():
        for r in reqs[:2]:
            fn(r)
    times = {name: [] for name in predicts}
    names = list(predicts)
    for i in range(n):
        for name in (names if i % 2 == 0 else names[::-1]):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            predicts[name](reqs[i % len(reqs)])
            e.record()
            e.synchronize()
            times[name].append(s.elapsed_time(e))
    out = {}
    for name, ts in times.items():
        ts.sort()
        p50, p90 = statistics.median(ts), ts[int(0.9 * (len(ts) - 1))]
        out[name] = (p50, p90)
        print(f'{label}: {tag} {name + " " if name else ""}request B={b}: p50 {p50:.3f} ms, '
              f'p90 {p90:.3f} ms, {b * 1000.0 / p50:.1f} images/s ({n} requests'
              f'{", in turns" if len(names) > 1 else ""})')
    return out


def stage_split(fwd, xb, rb, dev, ev, tag, label):
    """Each stage of one B=4 request alone (CUDA events) and the forward on
    the device alone (CUDA graph); prints them."""
    import torch
    from pqdet_tpu_torch.ops.postprocess import nms_batch, recover_bboxes
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    with torch.inference_mode():
        preds = fwd(xb)
        in_size = torch.tensor([SIZE, SIZE], dtype=torch.float32, device=dev)
        hw = rb['shape'].float()
        rec = recover_bboxes(preds, in_size, hw)
        res = nms_batch(rec, ev.score_threshold, ev.iou_threshold, ev.max_detections,
                        ev.pool_factor, ev.nms_method, ev.nms_sigma)
        stages = {
            'normalize': lambda: device_normalize(rb['image']),
            'forward': lambda: fwd(xb),
            'recover': lambda: recover_bboxes(preds, in_size, hw),
            'nms': lambda: nms_batch(rec, ev.score_threshold, ev.iou_threshold,
                                     ev.max_detections, ev.pool_factor,
                                     ev.nms_method, ev.nms_sigma),
            'to_host': lambda: [t.cpu().numpy() for t in res],
        }
        split = {name: cuda_ms(fn, iters=10) for name, fn in stages.items()}
        fwd_device = device_ms(stages['forward'], iters=3, replays=3)
    print(f'{label}: {tag} B={BATCH} request by stage, each alone: '
          + ', '.join(f'{k} {v:.3f} ms' for k, v in split.items())
          + f'; forward on the device alone (CUDA graph) {fwd_device:.3f} ms')


def profile_calls(call, tag, label, what):
    """torch.profiler over 3 calls of ``call``: wall, device busy, idle share
    and the top kernels per call (``what`` names a call in the lines)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    kern_ev = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy_ms = sum(ev.self_device_time_total for ev in kern_ev) / 1e3 / 3
    if busy_ms > 0:
        print(f'{label}: {tag} profiled {what}: wall {wall_ms:.3f} ms, '
              f'device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}')
        for ev in sorted(kern_ev, key=lambda e: -e.self_device_time_total)[:8]:
            print(f'  {ev.self_device_time_total / 1e3 / 3:9.4f} ms/{what.split()[0]} '
                  f'{ev.count // 3:4d} launches  {ev.key[:90]}')
    else:
        print(f'{label}: {tag} profiler saw no device time: busy share not measured')
    # the host side: what a call spends its CPU time on
    host_ev = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CPU]
    n_launch = sum(ev.count for ev in host_ev
                   if ev.key in ('cudaLaunchKernel', 'cudaLaunchKernelExC')) // 3
    print(f'{label}: {tag} host per {what.split()[0]}: {n_launch} kernel launches; top ops '
          'by self CPU ms: ' + ', '.join(
              f'{ev.key} {ev.self_cpu_time_total / 1e3 / 3:.3f} ({ev.count // 3})'
              for ev in sorted(host_ev, key=lambda e: -e.self_cpu_time_total)[:6]))


def out_sides(graph, size):
    """{node index: side of its output map} at input ``size``: size over the
    node's cumulative stride, or, below a global avgpool (stride None: the
    SE squeeze and excite 1x1s), the pooled side."""
    sides, prev = {}, size
    for n in graph.nodes:
        if n.stride is not None:
            prev = size // n.stride
        elif n.out_size is not None:
            prev = n.out_size[0]
        sides[n.index] = prev
    return sides


def int8_conv_shapes(net, size):
    """{(kind, n_h, n_w, cin, cout, stride, act, requant): count} over the
    convs of the int8 graph at input ``size`` (a side, or (h, w)), as each
    kernel sees them:
    'pw' and 'dw' take the conv's input (H, W, C), a strided 'pw' its every
    stride-th pixel; 'stem' is the dense 3x3
    as its im2col patches (H/stride, W/stride, im2col_depth(Cin)) into the
    1x1 kernel (9*Cin taps and zero columns up to a multiple of 16).
    ``requant``: the output edge is quantised (it feeds no yolo head)."""
    from pqdet_tpu_torch.compress.quantized import im2col_depth
    feeders = {n.index - 1 for n in net.graph.nodes if n.kind == 'yolo'}
    size_h, size_w = (size, size) if isinstance(size, int) else size
    sides_h, sides_w = out_sides(net.graph, size_h), out_sides(net.graph, size_w)
    shapes = {}
    for n in net.graph.nodes:
        if n.kind != 'convolutional':
            continue
        a = n.attrs
        h, w = (sides_h[n.index - 1], sides_w[n.index - 1]) if n.index else (size_h, size_w)
        rq = n.index not in feeders
        st = a['stride']
        if a['size'] == 1:       # strided: the kernel takes every stride-th pixel
            key = ('pw', -(-h // st), -(-w // st), n.in_channels, a['filters'], 1,
                   a['activation'], rq)
        elif a['groups'] == n.in_channels == a['filters']:
            key = ('dw', h, w, n.in_channels, n.in_channels, st, a['activation'], rq)
        else:
            key = ('stem', h // st, w // st, im2col_depth(n.in_channels), a['filters'], 1,
                   a['activation'], rq)
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def int8_inputs(gen, kind, n, h, w, cin, cout, dev):
    """Seeded recentred s8 input, int8 weights, per-channel scale and bias,
    and an integer zero point in [1, 254]."""
    import torch
    x = torch.randint(-128, 128, (n, h, w, cin), generator=gen, dtype=torch.int8)
    wshape = (3, 3, cin) if kind == 'dw' else (cin, cout)
    wq = torch.randint(-127, 128, wshape, generator=gen, dtype=torch.int8)
    w_scale = torch.rand(cout, generator=gen) * 0.01 + 0.001
    b = torch.randn(cout, generator=gen) * 0.5
    colsum = wq.to(torch.int32).sum(0).to(torch.int32) if kind != 'dw' else None
    x_zp = float(torch.randint(1, 255, (), generator=gen))
    to = lambda t: None if t is None else t.to(dev).contiguous()  # noqa: E731
    return to(x), to(wq), to(w_scale), to(b), to(colsum), 0.02, x_zp


def edge_of(y):
    """(scale, zp) of a uint8 edge spanning ``y``, as act_qparams makes it."""
    mn, mx = min(y.min().item(), 0.0), max(y.max().item(), 0.0)
    scale = max((mx - mn) / 255.0, 1e-8)
    return scale, float(min(max(round(-mn / scale), 0), 255))


def int8_bound_ms(kind, n, h, w, cin, cout, stride, requant):
    """(bytes ms, operations ms): each input read once, each output written
    once, over 3.35 TB/s; int8 operations over 1979 TOP/s."""
    out_b = 1 if requant else 4
    if kind == 'dw':
        ho, wo = h // stride, w // stride
        nbytes = n * h * w * cin + 9 * cin + 8 * cin + 16 + n * ho * wo * cin * out_b
        ops = 18 * n * ho * wo * cin
    else:
        m = n * h * w
        nbytes = m * cin + cin * cout + 12 * cout + 16 + m * cout * out_b
        ops = 2 * m * cin * cout
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OP_PER_S * 1e3


# depthwise shapes beyond the graph's, whose C are all multiples of 16:
# C 27 and 75 (one channel a thread, byte copies), C 20 (4-byte copies and
# stores, a partly masked channel slice), W not a multiple of the tile, a
# 2x2 stride-2 input (one output pixel)
DW_EDGE_SHAPES = ([('dw', 64, 64, c, c, s, 'relu', False) for c in (27, 75, 20) for s in (1, 2)]
                  + [('dw', 20, 36, 32, 32, 1, 'relu6', False),
                     ('dw', 20, 36, 96, 96, 2, 'linear', False),
                     ('dw', 2, 2, 20, 20, 2, 'relu', False)])
# the depthwise kernel's exact-order path runs only at a fractional zero
# point (act_qparams rounds them): (shape, zero point offset)
DW_FRACTIONAL_ZP = [(('dw', 64, 64, 96, 96, 2, 'relu', True), 0.37),
                    (('dw', 20, 36, 32, 32, 1, 'relu', True), 0.37),
                    (('dw', 64, 64, 27, 27, 1, 'relu', True), 0.37)]
# pointwise shapes beyond the graph's: M below one tile, M not a multiple of
# the tile with N 75, the stem's raw K 27 (rows not 16-byte aligned: the
# byte path), K 24 in a 32-deep step, split-K with a ragged M
QCONV_EDGE_SHAPES = [
    ('pw', 3, 5, 64, 96, 1, 'relu', True),
    ('pw', 9, 9, 160, 75, 1, 'linear', False),
    ('stem', 64, 64, 27, 32, 1, 'relu', True),
    ('pw', 16, 16, 24, 144, 1, 'relu6', True),
    ('pw', 7, 11, 1280, 512, 1, 'leaky', True),
]


def phase6_int8_parity(gen, dev, shapes, batches=(1, BATCH), edges=True, label='phase 6'):
    """Each int8 kernel against its plain version at every shape of
    ``shapes``, and with ``edges`` at ``QCONV_EDGE_SHAPES`` and
    ``DW_EDGE_SHAPES``, at each of ``batches``, f32 then requantised output,
    every output bit for bit; then (``edges``) the depthwise kernel at
    ``DW_FRACTIONAL_ZP``, to the s8/f32 bound. Widths of 8 (mod 16), the
    8-byte copy paths, are flagged. Returns the largest error of each
    kernel: |f32 err| or s8 code difference."""
    import torch
    from pqdet_tpu_torch.ops.qconv import (make_scalars, plan_qconv1x1, plan_qdwconv3x3,
                                           qconv1x1_reference, qconv1x1_s8,
                                           qdwconv3x3_reference, qdwconv3x3_s8)
    worst = {'qconv1x1_s8': 0.0, 'qdwconv3x3_s8': 0.0}
    failures = []
    n_exact = n_checks = 0
    extra = QCONV_EDGE_SHAPES + DW_EDGE_SHAPES if edges else []
    cases = [(k, n, 0.0) for k in sorted(shapes) + extra for n in batches]
    cases += [(k, BATCH, f) for k, f in DW_FRACTIONAL_ZP] if edges else []
    for (kind, h, w, cin, cout, stride, act, _), n, frac in cases:
        x, wq, ws, b, cs, x_scale, x_zp = int8_inputs(gen, kind, n, h, w, cin, cout, dev)
        x_zp += frac
        if kind == 'dw':
            name = 'qdwconv3x3_s8'
            kern = lambda sc, rq: qdwconv3x3_s8(  # noqa: E731
                x, wq, ws, b, act=act, stride=stride, scalars=sc, requant=rq)
            ref = lambda sc, rq: qdwconv3x3_reference(  # noqa: E731
                x, wq, ws, b, act=act, stride=stride, scalars=sc, requant=rq)
        else:
            name = 'qconv1x1_s8'
            kern = lambda sc, rq: qconv1x1_s8(  # noqa: E731
                x, wq, ws, b, cs, act=act, scalars=sc, requant=rq)
            ref = lambda sc, rq: qconv1x1_reference(  # noqa: E731
                x, wq, ws, b, cs, act=act, scalars=sc, requant=rq)
        sc = make_scalars(x_scale, x_zp, device=dev)
        got, want = kern(sc, False), ref(sc, False)
        torch.cuda.synchronize()
        err = (got - want).abs()
        f32_ok = bool(torch.isfinite(got).all()) and bool(
            (err <= 1e-5 * want.abs().clamp_min(1.0)).all())
        o_scale, o_zp = edge_of(want)
        sc = make_scalars(x_scale, x_zp, o_scale, o_zp, device=dev)
        q, qref = kern(sc, True), ref(sc, True)
        torch.cuda.synchronize()
        d = (q.to(torch.int32) - qref.to(torch.int32)).abs()
        n_diff = int((d > 0).sum())
        s8_ok = d.max().item() <= 1 and n_diff < 1e-3 * d.numel()
        worst[name] = max(worst[name], err.max().item(), float(d.max().item()))
        exact = int(err.max().item() == 0) + int(n_diff == 0)
        if not frac:
            n_checks += 2
            n_exact += exact
        # integer zero points: bit for bit; fractional: the bound
        ok = f32_ok and s8_ok and (frac or exact == 2)
        if kind == 'dw':
            pl = plan_qdwconv3x3(n, h, w, cin, stride)
            plan = f' plan th={pl.th} tw={pl.tw} cs={pl.cs} cw={pl.cw} grid={pl.grid}'
        else:
            plan = f' plan {tuple(plan_qconv1x1(n * h * w, cin, cout))[:6]}'
        odd = ' (8 mod 16)' if cin % 16 == 8 or cout % 16 == 8 else ''
        print(f'{label}: {name} {kind} N={n} H={h} W={w} Cin={cin} Cout={cout}{odd} '
              f's={stride} {act} x_zp={x_zp:.2f}{plan}: f32 max |err| '
              f'{err.max().item():.3g}, s8 {n_diff} of {d.numel()} codes differ (max '
              f'{d.max().item()}) {"ok" if ok else "FAIL"}')
        if not ok:
            failures.append((name, kind, n, h, cin, cout, stride))
    if failures:
        raise AssertionError(f'{label}: int8 kernels disagree with their plain versions on '
                             f'{failures}')
    print(f'{label}: {n_exact} of {n_checks} outputs at integer zero points equal to their '
          f'plain version bit for bit; largest error {worst}')
    return worst


def calibrate_int8(qnet, params, state, batch):
    """The quant graph ``qnet``'s observers added to (params, state)
    (``prepare_qat_state``) and run over N_CALIB seeded requests of
    B=BATCH from ``batch``, then ``convert_to_int8``: returns (params,
    state, qparams)."""
    import torch
    from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
    from pqdet_tpu_torch.compress.quantized import convert_to_int8
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    params, state = prepare_qat_state(qnet, params, state)
    with torch.inference_mode():
        for _ in range(N_CALIB):
            ctx = QuantCtx(state['quant'], observing=True)
            qnet(params, state, device_normalize(batch(BATCH)['image']), quant_ctx=ctx)
            state = {**state, 'quant': ctx.new_obs}
        return params, state, convert_to_int8(qnet, params, state)


def phase7_int8_path(gen, dev, cfg, batch, tag, qnet, shapes):
    """Calibrate, convert and serve the int8 quant graph ``qnet`` through the
    kernel path; check launches, node-by-node parity with the plain path,
    preds and detections. Returns (inf, qprep, predict, launches, qparams)."""
    import torch
    from pqdet_tpu_torch.compress.quantized import Int8Inference
    from pqdet_tpu_torch.evaluation.predict import (build_predict_pipeline,
                                                    make_batch_predict)
    from pqdet_tpu_torch.model.network import cast_params, fuse_params
    from pqdet_tpu_torch.ops.decode_kernel import decode_heads
    from pqdet_tpu_torch.ops.fused_ir import prepare_fused_ir
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.ops.qconv import qconv1x1_s8, qdwconv3x3_s8

    n_pw = sum(c for k, c in shapes.items() if k[0] in ('pw', 'stem'))
    n_dw = sum(c for k, c in shapes.items() if k[0] == 'dw')
    params, state = qnet.init(gen, device=dev)
    seed_bn(params, state, gen, dev)
    t0 = time.perf_counter()
    params, state, qparams = calibrate_int8(qnet, params, state, batch)
    inf = Int8Inference(qnet, mode='kernel')
    qprep = Int8Inference.prepare(qparams)
    zps = sorted({zp for _, zp in qparams['act'].values()})
    print(f'phase 7: calibrated {len(qparams["act"])} edges with {N_CALIB} observer '
          f'passes of B={BATCH} and converted in {time.perf_counter() - t0:.2f} s; '
          f'zero points {zps[:6]}{"..." if len(zps) > 6 else ""}')

    run = build_predict_pipeline(qnet, cfg, apply_fn=lambda p, images: inf.apply(p, images),
                                 device=dev)
    predict = make_batch_predict(run, qprep)
    requests = [batch(BATCH) for _ in range(N_REQUESTS)]
    predict(requests[0])                      # warm-up
    torch.cuda.synchronize()
    qconv1x1_s8.launches = qdwconv3x3_s8.launches = decode_heads.launches = 0
    dets = [predict(r) for r in requests]
    torch.cuda.synchronize()
    launches = {'qconv1x1_s8': qconv1x1_s8.launches,
                'qdwconv3x3_s8': qdwconv3x3_s8.launches, 'decode': decode_heads.launches}
    want = {'qconv1x1_s8': n_pw * N_REQUESTS, 'qdwconv3x3_s8': n_dw * N_REQUESTS,
            'decode': N_REQUESTS}
    print(f'phase 7: served {N_REQUESTS} int8 requests of {BATCH} images at {SIZE}x{SIZE}; '
          f'launches {launches} (want {want}: {n_pw} + {n_dw} + 1 per forward)')
    if (n_pw, n_dw) != (58, 26) or launches != want:
        raise AssertionError(f'int8 kernel launches {launches} != {want}')
    nc = qnet.num_classes
    n_det = 0
    for r in dets:
        for d in r:
            n_det += len(d)
            if d.shape[1] != 6 or not bool(torch.isfinite(torch.from_numpy(d)).all()):
                raise AssertionError('an int8 detection is not finite or has the wrong shape')
            if len(d) and not ((d[:, 5] >= 0) & (d[:, 5] < nc)).all():
                raise AssertionError('an int8 detection has a class outside the model')
    print(f'phase 7: {n_det} int8 detections, all finite')

    # node by node: the kernel path against the plain versions on the card
    with torch.inference_mode():
        x = device_normalize(requests[0]['image'])
    kern, plain, bad, n_exact, n_nodes = int8_node_parity(inf, qprep, qparams, qnet, x)
    print(f'phase 7: kernel path vs plain path on the card, {n_nodes} nodes: '
          f'{n_exact} equal bit for bit, {len(bad)} outside the bound {bad}')
    rows = sum((SIZE // y.attrs['stride']) ** 2 * 3 for y in qnet.graph.yolo_nodes)
    if tuple(kern.shape) != (BATCH, rows, 5 + nc) or not bool(torch.isfinite(kern).all()):
        raise AssertionError(f'int8 preds {tuple(kern.shape)} not finite (B, {rows}, {5 + nc})')
    ds = (kern[..., 4:] - plain[..., 4:]).abs().max().item()
    db = (kern[..., :4] - plain[..., :4]).abs().max().item()
    print(f'phase 7: int8 kernel path vs plain path: scores max |d| {ds:.4g} (<= 0.02), '
          f'boxes max |d| {db:.4g} px (<= 1)')
    if bad or not (ds <= 0.02 and db <= 1.0):
        raise AssertionError('the int8 kernel path disagrees with its plain versions')

    # a conv that neither kernel takes raises on the card: at 63x63 the
    # stride-2 stem meets odd H and W
    odd = device_normalize(requests[0]['image'][:, :63, :63].contiguous())
    try:
        with torch.inference_mode():
            inf.apply(qprep, odd)
    except ValueError as e:
        if 'fits neither int8 kernel' not in str(e):
            raise
        print(f'phase 7: a 63x63 input raises as it should: {e}')
    else:
        raise AssertionError('the int8 kernel path ran a conv that neither kernel takes')

    # printed only: int8 against the bf16 fp path of the same weights
    fused = fuse_params(qnet, params, state)
    with torch.inference_mode():
        fp = qnet(cast_params(fused, torch.bfloat16), {}, x, compute_dtype=torch.bfloat16,
                  fused_ir=prepare_fused_ir(qnet, fused))
    print(f'phase 7: int8 vs bf16 fp path, same weights (not gated): median |d| '
          f'scores {(kern[..., 4:] - fp[..., 4:]).abs().median().item():.4g}, boxes '
          f'{(kern[..., :4] - fp[..., :4]).abs().median().item():.4g} px; max |d| scores '
          f'{(kern[..., 4:] - fp[..., 4:]).abs().max().item():.4g}')
    return inf, qprep, predict, launches, qparams


def phase8_int8_timings(gen, dev, cfg, batch, tag, shapes, inf, qprep, predict, ptx):
    """Int8 request times, stage split and profile; per B=4 forward each int8
    kernel's device time, plain time, library time and bound. Returns
    {kernel name: {'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by'}}."""
    import torch
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    for b in (1, BATCH):
        request_times({'': predict}, batch, b, tag, 'phase 8')
    rb = batch(BATCH)
    with torch.inference_mode():
        xb = device_normalize(rb['image'])
    stage_split(lambda x: inf.apply(qprep, x), xb, rb, dev, cfg.eval, tag, 'phase 8')
    rp = batch(BATCH)
    profile_calls(lambda: predict(rp), tag, 'phase 8', f'request B={BATCH}')
    return int8_kernel_times(gen, dev, shapes, ptx, tag, 'phase 8')


def int8_kernel_times(gen, dev, shapes, ptx, tag, label, batch=BATCH):
    """Per forward of ``batch`` images at ``shapes`` (``int8_conv_shapes``), each int8
    kernel's device time from CUDA graphs, its plain version's, a library
    yardstick (torch._int_mm + the epilogue as torch ops; cuDNN's f32
    depthwise conv + the epilogue) and its bound, with the plan and ptxas
    report. Returns {kernel name: {'ms', 'plain_ms', 'library_ms',
    'bound_ms', 'bound_by'}}."""
    import torch
    import torch.nn.functional as F
    from pqdet_tpu_torch.ops.qconv import (_epilogue, make_scalars, plan_qconv1x1,
                                           plan_qdwconv3x3, qconv1x1_reference, qconv1x1_s8,
                                           qdwconv3x3_reference, qdwconv3x3_s8)
    tot = {k: dict.fromkeys(('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bytes_ms',
                             'ops_ms'), 0.0) for k in ('qconv1x1_s8', 'qdwconv3x3_s8')}
    for (kind, h, w, cin, cout, stride, act, rq), count in sorted(shapes.items()):
        x, wq, ws, b, cs, x_scale, x_zp = int8_inputs(gen, kind, batch, h, w, cin, cout, dev)
        sc = make_scalars(x_scale, x_zp, 0.05 if rq else None, 3.0 if rq else None, dev)
        s = sc.reshape(-1)
        if kind == 'dw':
            name = 'qdwconv3x3_s8'
            kern = lambda: qdwconv3x3_s8(x, wq, ws, b, act=act, stride=stride,  # noqa: E731
                                         scalars=sc, requant=rq)
            plain = lambda: qdwconv3x3_reference(x, wq, ws, b, act=act,  # noqa: E731
                                                 stride=stride, scalars=sc, requant=rq)
            wk = wq.float().permute(2, 0, 1).reshape(cin, 1, 3, 3).contiguous()
            x_off = s[1] - 128.0
            zero = torch.zeros((), device=dev)

            def library():
                xf = (x.float() - x_off).permute(0, 3, 1, 2)      # channels_last view
                acc = F.conv2d(xf, wk, None, stride, 1, 1, cin).permute(0, 2, 3, 1)
                return _epilogue(acc, s, ws, b, zero, act, rq)
        else:
            name = 'qconv1x1_s8'
            kern = lambda: qconv1x1_s8(x, wq, ws, b, cs, act=act, scalars=sc,  # noqa: E731
                                       requant=rq)
            plain = lambda: qconv1x1_reference(x, wq, ws, b, cs, act=act,  # noqa: E731
                                               scalars=sc, requant=rq)
            # cuBLASLt s8 x s8 -> s32 through torch._int_mm: M, K and N
            # padded with zeros to multiples of 32 (it refuses N 104 at K 48
            # and M under 17, the SE 1x1s' M = B), outside the timing
            m = batch * h * w
            mp, kp, np_ = (-(-v // 32) * 32 for v in (m, cin, cout))
            a2 = F.pad(x.reshape(-1, cin), (0, kp - cin, 0, mp - m)).contiguous()
            b2 = F.pad(wq, (0, np_ - cout, 0, kp - cin)).t().contiguous().t()
            csf = cs.float()

            def library():
                acc = torch._int_mm(a2, b2)[:m, :cout]
                return _epilogue(acc.float(), s, ws, b, csf, act, rq)
        k_ms = device_ms(kern)
        p_ms = device_ms(plain, iters=5, replays=2)
        l_ms = device_ms(library)
        by_ms, op_ms = int8_bound_ms(kind, batch, h, w, cin, cout, stride, rq)
        t = tot[name]
        t['ms'] += count * k_ms
        t['plain_ms'] += count * p_ms
        t['library_ms'] += count * l_ms
        t['bound_ms'] += count * max(by_ms, op_ms)
        t['bytes_ms'] += count * by_ms
        t['ops_ms'] += count * op_ms
        if kind == 'dw':
            pl = plan_qdwconv3x3(batch, h, w, cin, stride)
            how = (f'plan th={pl.th} tw={pl.tw} cs={pl.cs} cw={pl.cw} smem={pl.smem} B, '
                   f'{pl.grid} CTAs, one a tile; ptxas '
                   f'{ptx.get(f"qdw3x3_kernel<4,{stride}>", "not reported")}')
        else:
            pl = plan_qconv1x1(batch * h * w, cin, cout)
            how = (f'plan bm={pl.bm} bn={pl.bn} bk={pl.bk} split={pl.split} kpr={pl.kpr} '
                   f'stages={pl.stages} smem={pl.smem} B; ptxas '
                   f'{ptx.get(f"qconv1x1_kernel<{pl.bk}>", "not reported")}')
        print(f'{label}: {tag} {name} {kind} x{count} B={batch} H={h} W={w} Cin={cin} '
              f'Cout={cout} s={stride} {"s8" if rq else "f32"} out: kernel {k_ms:.4f} ms, '
              f'plain {p_ms:.4f} ms, library {l_ms:.4f} ms, bound '
              f'{max(by_ms, op_ms):.5f} ms ({"operations" if op_ms > by_ms else "bytes"}); '
              f'{how}')
    for name, t in tot.items():
        t['bound_by'] = 'operations' if t.pop('ops_ms') > t.pop('bytes_ms') else 'bytes'
        if not t['ms']:
            continue                    # no shape of this kernel in ``shapes``
        print(f'{label}: {tag} {name} per B={batch} forward: kernel {t["ms"]:.4f} ms, '
              f'plain {t["plain_ms"]:.4f} ms, library {t["library_ms"]:.4f} ms, bound '
              f'{t["bound_ms"]:.5f} ms ({t["bound_by"]})')
    return tot


# training (phases 9-10): full-width mobilenetv2-fpn on the port's train
# config (train_config: batch, GT pad, compute dtype, head probe and input
# sizes are its defaults); the run's depth is set here
TRAIN_SIZE = 512
TRAIN_STEPS = 30
TRAIN_WARMUP = 5
REMAT = 4
PARITY_SIZE = 256              # phase 9's card-against-CPU f32 step
PARITY_RUNNING_SIZE = 128      # ... and its running-statistics check
PARITY_BATCH = 2
PARITY_LR = 1e-3


def train_config():
    """The config phases 9-10 train with: the port's defaults (batch 12, GT
    padded to 64 boxes, bf16 compute, head_probe on, input sizes 320 to
    608, no weight decay, clip or sparse-L1) with an lr that warms up to
    1e-3 over TRAIN_WARMUP steps and anneals to 1e-5 by TRAIN_STEPS, for
    ``train_step_from_config`` with ``steps_per_epoch=TRAIN_WARMUP``."""
    from pqdet_tpu_torch.config import Config
    cfg = Config()
    t = cfg.train
    t.learning_rate_init, t.learning_rate_end = 1e-3, 1e-5
    t.warmup_epochs, t.max_epochs = 1.0, TRAIN_STEPS // TRAIN_WARMUP
    return cfg


def train_batch(gen, b, size, dev, max_gt, classes=20):
    """b seeded uint8 images at ``size`` and their padded GT boxes (B,
    max_gt, 6): 1 to max_gt boxes an image, 8 px to size/2 a side, centres
    in the image, ``classes`` classes, mixup weights in [0.5, 1]."""
    import torch
    img = torch.randint(0, 256, (b, size, size, 3), generator=gen, dtype=torch.uint8)
    gt = torch.zeros(b, max_gt, 6)
    for i in range(b):
        n = int(torch.randint(1, max_gt + 1, (), generator=gen))
        c = torch.rand(n, 2, generator=gen) * size
        wh = 8 + torch.rand(n, 2, generator=gen) * (size / 2 - 8)
        gt[i, :n, :2] = (c - wh / 2).clamp(0, size)
        gt[i, :n, 2:4] = (c + wh / 2).clamp(0, size)
        gt[i, :n, 4] = torch.randint(0, classes, (n,), generator=gen).float()
        gt[i, :n, 5] = 0.5 + 0.5 * torch.rand(n, generator=gen)
    return {'image': img.to(dev), 'gt': gt.to(dev)}


def kernel_launches():
    from pqdet_tpu_torch.ops.decode_kernel import decode_heads
    from pqdet_tpu_torch.ops.fused_ir import fused_ir_conv
    from pqdet_tpu_torch.ops.qconv import qconv1x1_s8, qdwconv3x3_s8
    return {f.__name__: f.launches
            for f in (decode_heads, fused_ir_conv, qconv1x1_s8, qdwconv3x3_s8)}


def reset_kernel_launches():
    from pqdet_tpu_torch.ops.decode_kernel import decode_heads
    from pqdet_tpu_torch.ops.fused_ir import fused_ir_conv
    from pqdet_tpu_torch.ops.qconv import qconv1x1_s8, qdwconv3x3_s8
    for f in (decode_heads, fused_ir_conv, qconv1x1_s8, qdwconv3x3_s8):
        f.launches = 0


def grad_step_parts(net, params, state, batch, dev, cfg, train, s2d_stem=0):
    """Loss parts, grads, new BN state, and the params and effective grads
    (after sparse-L1, clip and L2: the new first moment / 0.1) of one update
    of the port's step pieces on ``dev`` (f32): sparse-L1 0.01, a clip of 1
    (binding at init), weight decay 1e-4, lr PARITY_LR. ``train``: batch
    statistics in BN, else running statistics (no update then); ``s2d_stem``
    as the walk takes it."""
    import torch
    from pqdet_tpu_torch.model.network import to_device
    from pqdet_tpu_torch.ops.labels import label_assigner_from_config
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.train.step import (add_sparse_l1, make_optimizer,
                                            sparse_bn_gamma_ids, value_and_grad)
    p, s, b = to_device(params, dev), to_device(state, dev), to_device(batch, dev)
    labels = label_assigner_from_config(cfg, device=dev)

    def loss_fn(p_, s_, b_, rng=None):
        image = device_normalize(b_['image'])
        losses, new_state = net.forward_train(p_, s_, image, train=train, s2d_stem=s2d_stem,
                                              targets=labels(b_['gt'], image.shape[1:3]))
        return losses['loss'][0], (losses, new_state)
    (_, (losses, new_state)), grads = value_and_grad(loss_fn, p, s, b)
    out = {'parts': torch.stack([losses[k][0] for k in
                                 ('loss', 'giou_loss', 'conf_loss', 'class_loss')]),
           'grads': grads, 'state': new_state}
    if train:
        opt = make_optimizer(lambda k: PARITY_LR, weight_decay=1e-4, grad_clip=1.0)
        g = add_sparse_l1(grads, p, sparse_bn_gamma_ids(net), 0.01)
        out['params'], o = opt.update(g, opt.init(p), p)
        out['grad_eff'] = o['mu'] / (1 - opt.b1)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    return to_device(out, torch.device('cpu'))


PARITY_CASES = ((False, PARITY_RUNNING_SIZE), (True, PARITY_SIZE))


def phase9_parity(net, params, state, gen, dev, cfg, label='phase 9', cases=None, s2d_stem=0):
    """Phase 9.1: one f32 step on the card against the same step on the CPU
    (the CPU path is what the tests hold to JAX), at PARITY_SIZE with batch
    statistics in BN, and the loss and grads at PARITY_RUNNING_SIZE with
    running statistics, where the walk is well conditioned and the bounds
    are tight. With batch statistics the walk amplifies rounding
    (tests/test_torch_train_parity.py), so the grads and params are held to
    a yardstick: the CPU step on the batch with its images reversed (the
    same function, its sums in another order). Prints the largest relative
    error of each quantity and its bound; raises outside one. ``cases``:
    (batch statistics, size) pairs, PARITY_CASES by default; ``s2d_stem``
    as the walk takes it."""
    import torch
    from pqdet_tpu_torch.train.step import tree_leaves
    cpu = torch.device('cpu')
    fails = []

    def check(name, err, bound):
        ok = err <= bound
        print(f'{label}: card vs CPU f32 step B={PARITY_BATCH} {size}x{size}: '
              f'{name} {err:.4g} (bound {bound:g}) {"ok" if ok else "FAIL"}')
        if not ok:
            fails.append(name)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    for train, size in cases or PARITY_CASES:
        batch = train_batch(gen, PARITY_BATCH, size, cpu, cfg.model.max_gt_boxes)
        t0 = time.perf_counter()
        card = grad_step_parts(net, params, state, batch, dev, cfg, train, s2d_stem)
        t1 = time.perf_counter()
        host = grad_step_parts(net, params, state, batch, cpu, cfg, train, s2d_stem)
        t2 = time.perf_counter()
        mode = 'batch-statistics BN' if train else 'running-statistics BN'
        print(f'{label}: {mode}: card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s (with labels)')
        a, b = card['parts'], host['parts']
        parts = ((a - b).abs() / b.abs()).max().item()
        ga, gb = tree_leaves(card['grads']), tree_leaves(host['grads'])
        leaf = max(rel(x, y) for x, y in zip(ga, gb))
        if not train:
            # well conditioned: held tightly
            top = max(y.abs().max().item() for y in gb)
            gerr = max(((x - y).abs() - 1e-3 * y.abs()).max().item() for x, y in zip(ga, gb))
            check(f'{mode} loss and parts, max rel err', parts, 1e-4)
            check(f'{mode} grads, max |d| - 1e-3 |g| over the largest |g|',
                  max(gerr, 0.0) / top, 1e-4)
            print(f'{label}: {mode} grads, largest per-leaf max|d| / max|g|: {leaf:.4g}')
            continue
        # batch statistics: the yardstick is the CPU step on the reversed batch
        t0 = time.perf_counter()
        own = grad_step_parts(net, params, state, {k: v.flip(0) for k, v in batch.items()},
                              cpu, cfg, train, s2d_stem)
        print(f'{label}: {mode}: CPU on the reversed batch {time.perf_counter() - t0:.2f} s')
        check(f'{mode} loss and parts, max rel err', parts, 1e-3)
        g, h = torch.cat([x.reshape(-1) for x in ga]), torch.cat([y.reshape(-1) for y in gb])
        check(f'{mode} grads, relative L2 distance', ((g - h).norm() / h.norm()).item(), 0.5)
        ea, eb, eo = card['grad_eff'], host['grad_eff'], own['grad_eff']
        yard = ((eo - eb).norm() / eb.norm()).item()
        check(f'{mode} effective grads, relative L2 distance over the CPU\'s own on the '
              f'reversed batch ({yard:.4g})', ((ea - eb).norm() / eb.norm()).item() / yard, 2.0)
        top = max(y.norm().item() for y in gb)
        cos = min(((x * y).sum() / (x.norm() * y.norm())).item()
                  for x, y in zip(ga, gb) if y.norm() > 1e-3 * top)
        check(f'{mode} grads, 1 - smallest leaf cosine (leaves over 1e-3 of the largest '
              'norm)', 1 - cos, 0.1)
        print(f'{label}: {mode} grads, largest per-leaf max|d| / max|g|: {leaf:.4g} '
              '(not gated)')
        sa, sb = tree_leaves(card['state']), tree_leaves(host['state'])
        check(f'{mode} new BN state, max |d| / max(1, |s|)',
              max(((x - y).abs() / y.abs().clamp_min(1.0)).max().item()
                  for x, y in zip(sa, sb)), 1e-2)
        start = torch.cat([x.reshape(-1) for x in tree_leaves(params)])
        pa = torch.cat([x.reshape(-1) for x in tree_leaves(card['params'])])
        pb = torch.cat([x.reshape(-1) for x in tree_leaves(host['params'])])
        po = torch.cat([x.reshape(-1) for x in tree_leaves(own['params'])])
        yard = (po - pb).norm().item()
        check(f'{mode} updated params, L2 distance over the CPU\'s own on the reversed batch '
              f'({yard:.4g})', (pa - pb).norm().item() / yard, 2.0)
        far, far_own = [int(((x - pb).abs() > 1e-2 * PARITY_LR).sum()) for x in (pa, po)]
        check(f'{mode} updated params, count over 1e-2 lr apart over the CPU\'s own on the '
              f'reversed batch ({far_own} of {pb.numel()})', far / max(far_own, 1), 2.0)
        moved = (pb - start).abs() > 0.5 * PARITY_LR
        same = (torch.sign(pa - start) == torch.sign(pb - start))[moved].float().mean().item()
        check(f'{mode} updated params, share moved the other way (of those the CPU moved '
              'by over lr/2)', 1 - same, 0.1)
    if fails:
        raise AssertionError(f'the card step disagrees with the CPU step: {fails}')


def check_grad_guard(dev):
    """Each kernel wrapper, given a tensor on ``dev`` that requires grad
    while grad mode is on, raises before it launches."""
    import torch
    from pqdet_tpu_torch.ops.decode_kernel import decode_heads
    from pqdet_tpu_torch.ops.fused_ir import fused_ir_conv
    from pqdet_tpu_torch.ops.qconv import qconv1x1_s8, qdwconv3x3_s8
    f = dict(device=dev)
    g = dict(device=dev, requires_grad=True)
    sc = torch.zeros(1, 4, **f)
    guarded = {
        'decode_heads': lambda: decode_heads([torch.zeros(1, 2, 2, 75, **g)], 20, [8], [0.0]),
        'fused_ir_conv': lambda: fused_ir_conv(
            torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16, **g), None, None,
            torch.zeros(9, 8, dtype=torch.bfloat16, **f), torch.zeros(8, **f),
            torch.zeros(8, 8, dtype=torch.bfloat16, **f), torch.zeros(8, **f),
            act_e='linear'),
        'qconv1x1_s8': lambda: qconv1x1_s8(
            torch.zeros(1, 2, 2, 16, dtype=torch.int8, **f),
            torch.zeros(16, 8, dtype=torch.int8, **f), torch.ones(8, **g), torch.zeros(8, **f),
            torch.zeros(8, dtype=torch.int32, **f), act='relu', scalars=sc, requant=False),
        'qdwconv3x3_s8': lambda: qdwconv3x3_s8(
            torch.zeros(1, 4, 4, 16, dtype=torch.int8, **f),
            torch.zeros(3, 3, 16, dtype=torch.int8, **f), torch.ones(16, **f),
            torch.zeros(16, **g), act='relu', stride=1, scalars=sc, requant=False),
    }
    for name, call in guarded.items():
        try:
            call()
        except RuntimeError as e:
            if 'no backward' not in str(e):
                raise
            print(f'phase 9: {name} on a {dev.type} tensor that requires grad raises: {e}')
        else:
            raise AssertionError(f'{name} took a {dev.type} tensor that requires grad')
    if any(kernel_launches().values()):
        raise AssertionError('a refused call launched its kernel')


def phase9_training(dev, tag):
    """Phase 9: card-against-CPU parity, then the full-width step of
    ``train_config``: TRAIN_STEPS steps on one fixed batch, the ends of its
    input sizes, remat, and no hand-written kernel launched. Returns what
    phase 10 prints."""
    import copy
    import torch
    from pqdet_tpu_torch.model.network import DetectionNetwork, to_device
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.train.step import train_step_from_config, tree_leaves, tree_unflatten
    from pqdet_tpu_torch.zoo import get_cfg

    gen = phase_gen(9)
    cfg = train_config()
    batch_size, max_gt = cfg.train.batch_size, cfg.model.max_gt_boxes
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'))
    params, state = net.init(gen, device='cpu')
    n_params = sum(t.numel() for t in tree_leaves(params))
    reset_kernel_launches()
    phase9_parity(net, params, state, gen, dev, cfg)

    # the full-width step on one fixed batch
    step, opt = train_step_from_config(net, cfg, TRAIN_WARMUP, device=dev)
    sched = opt.schedule
    p, s = to_device(params, dev), to_device(state, dev)
    o = opt.init(p)
    tb = train_batch(gen, batch_size, TRAIN_SIZE, dev, max_gt)
    n_gt = int((tb['gt'][..., 2] > tb['gt'][..., 0]).sum())
    losses, heads, ms = [], [], []
    for k in range(TRAIN_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p, s, o, m = step(p, s, o, tb)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(m['loss']))
        heads.append(m['head_max'].tolist())
        if k in (0, 1, TRAIN_WARMUP, TRAIN_STEPS - 1) or not math.isfinite(losses[-1]):
            print(f'phase 9: step {k} lr {sched(k):.3g}: loss {losses[-1]:.4f} (giou '
                  f'{float(m["giou_loss"]):.4f}, conf {float(m["conf_loss"]):.4f}, class '
                  f'{float(m["class_loss"]):.4f}), head_max {[round(h, 3) for h in heads[-1]]}, '
                  f'{ms[-1]:.2f} ms')
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    moved = max((s[k]['mean'] - state[k]['mean'].to(dev)).abs().max().item() for k in s)
    print(f'phase 9: {TRAIN_STEPS} {cfg.system.compute_dtype} steps of mobilenetv2-fpn '
          f'({n_params} params) at {TRAIN_SIZE}x{TRAIN_SIZE}, B={batch_size}, {n_gt} GT boxes: '
          f'mean loss of steps 1-5 {first:.4f}, of the last 5 {last:.4f}; BN running means '
          f'moved by up to {moved:.4g}')
    if not all(math.isfinite(x) for x in losses + [h for hs in heads for h in hs]):
        raise AssertionError('a training loss or head_max is not finite')
    if not last < first or not moved > 0:
        raise AssertionError('the loss did not fall on the fixed batch, or BN did not move')

    for size in (min(cfg.train.input_sizes), max(cfg.train.input_sizes)):
        _, _, _, m = step(p, s, o, train_batch(gen, batch_size, size, dev, max_gt))
        loss = float(m['loss'])
        print(f'phase 9: one step at {size}x{size}, B={batch_size}: loss {loss:.4f}')
        if not math.isfinite(loss):
            raise AssertionError(f'the step at {size}x{size} is not finite')

    # remat: the same step as REMAT checkpointed segments (head_probe off:
    # its taps do not combine with remat)
    peak, res = {}, {}
    for r in (0, REMAT):
        rcfg = copy.deepcopy(cfg)
        rcfg.train.remat, rcfg.train.head_probe = r, False
        rstep, _ = train_step_from_config(net, rcfg, TRAIN_WARMUP, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        res[r] = rstep(p, s, o, tb)
        peak[r] = torch.cuda.max_memory_allocated(dev)

    def flat(tree):
        return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])

    (p0, s0, o0, m0), (p4, s4, o4, m4) = res[0], res[REMAT]
    d_loss = abs(float(m4['loss']) - float(m0['loss'])) / abs(float(m0['loss']))
    # this step's effective grads, 0.1x: the new first moment less 0.9x the old
    g0, g4 = o0['mu'] - opt.b1 * o['mu'], o4['mu'] - opt.b1 * o['mu']
    d_grad = ((g4 - g0).norm() / g0.norm()).item()
    upd = flat(p0) - flat(p)
    d_par = ((flat(p4) - flat(p0)).norm() / upd.norm()).item()
    d_state = max(((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
                  for a, b in zip(tree_leaves(s4), tree_leaves(s0)))
    print(f'phase 9: remat {REMAT} against remat 0, one step on the fixed batch: loss '
          f'{float(m4["loss"]):.6f} vs {float(m0["loss"]):.6f}, rel {d_loss:.3g} (bound 1e-3); '
          f'effective grads relative L2 {d_grad:.3g} (bound 5e-2); params, L2 distance over the '
          f'update\'s L2 {d_par:.3g} (bound 5e-2); new BN state max |d| / max(1, |s|) '
          f'{d_state:.3g} (bound 1e-5); peak memory {peak[REMAT] / 2**30:.3f} GiB vs '
          f'{peak[0] / 2**30:.3f} GiB')
    if not (d_loss <= 1e-3 and d_grad <= 5e-2 and d_par <= 5e-2 and d_state <= 1e-5
            and peak[REMAT] < peak[0]):
        raise AssertionError('remat changed the step or did not lower the peak memory')

    # the training entry without targets returns the decoded preds through
    # the plain decode: differentiable on the card, and no kernel launched
    req = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
    preds, _ = net.forward_train(tree_unflatten(p, req), s,
                                 device_normalize(tb['image'][:2]), compute_dtype=torch.bfloat16)
    grads = torch.autograd.grad(preds.sum(), req, allow_unused=True)
    n_grad = sum(1 for g in grads if g is not None and bool(g.abs().sum() > 0))
    finite = all(bool(torch.isfinite(g).all()) for g in grads if g is not None)
    print(f'phase 9: forward_train without targets, B=2 {TRAIN_SIZE}x{TRAIN_SIZE}: preds '
          f'{tuple(preds.shape)}, the grad of their sum reaches {n_grad} of {len(req)} leaves, '
          f'all finite: {finite}')
    if not (finite and n_grad > 0 and preds.requires_grad):
        raise AssertionError('forward_train without targets did not backpropagate')

    launches = kernel_launches()
    print(f'phase 9: hand-written kernel launches over every training step above and the '
          f'walk without targets: {launches} (want all 0)')
    if any(launches.values()):
        raise AssertionError(f'a training step launched a hand-written kernel: {launches}')
    check_grad_guard(dev)
    return {'ms': ms, 'peak': peak, 'step': step, 'opt': opt, 'p': p, 's': s, 'o': o,
            'tb': tb, 'net': net, 'cfg': cfg}


def phase10_training_timings(run, tag):
    """Phase 10: ms per step p50/p90 and images/s after warm-up, peak memory
    with and without remat, the step's time by stage, one profiled step."""
    import torch
    from pqdet_tpu_torch.ops.labels import label_assigner_from_config
    from pqdet_tpu_torch.train.step import (COMPUTE_DTYPES, make_loss_fn, tree_leaves,
                                            tree_unflatten)
    cfg = run['cfg']
    batch_size, dtype = cfg.train.batch_size, cfg.system.compute_dtype
    ms = sorted(run['ms'][TRAIN_WARMUP:])
    p50, p90 = statistics.median(ms), ms[int(0.9 * (len(ms) - 1))]
    print(f'phase 10: {tag} train step mobilenetv2-fpn {TRAIN_SIZE}x{TRAIN_SIZE} '
          f'B={batch_size} {dtype} ({len(ms)} steps after {TRAIN_WARMUP} of warm-up, CUDA '
          f'events, synchronised each step): p50 {p50:.3f} ms, p90 {p90:.3f} ms, '
          f'{batch_size * 1000.0 / p50:.2f} images/s')
    for r, b in sorted(run['peak'].items()):
        print(f'phase 10: {tag} peak memory of one step, remat {r}: '
              f'{b / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)')

    net, p, s, o, tb, opt = (run[k] for k in ('net', 'p', 's', 'o', 'tb', 'opt'))
    labels = label_assigner_from_config(cfg, device=tb['gt'].device)
    loss_fn = make_loss_fn(net, compute_dtype=COMPUTE_DTYPES[dtype], label_fn=labels)
    leaves = tree_leaves(p)

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        targets = labels(tb['gt'], (TRAIN_SIZE, TRAIN_SIZE))
        ev[1].record()
        req = [t.detach().requires_grad_(True) for t in leaves]
        loss, _ = loss_fn(tree_unflatten(p, req), s, {'image': tb['image'], 'targets': targets})
        ev[2].record()
        grads = torch.autograd.grad(loss, req)
        ev[3].record()
        opt.update(tree_unflatten(p, list(grads)), o, p)
        ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    splits = [staged() for _ in range(6)][1:]
    names = ('labels', 'forward and loss', 'backward', 'optimizer')
    med = [statistics.median(x[i] for x in splits) for i in range(4)]
    print(f'phase 10: {tag} step by stage (CUDA events between the stages of one step, '
          'median of 5): ' + ', '.join(f'{n} {v:.3f} ms' for n, v in zip(names, med))
          + f'; sum {sum(med):.3f} ms')
    step = run['step']
    profile_calls(lambda: step(p, s, o, tb), tag, 'phase 10', f'step B={batch_size}')
    return {'p50': p50, 'p90': p90, 'stages': dict(zip(names, med))}


# the trainer (phase 11): yamls/shapes.yaml on a corpus of the port's
# synthetic shapes, written by synth_shapes at a seed
CORPUS_IMAGES = 128
CORPUS_SIZE = 512
CORPUS_HOLDOUT = 0.25
TRAINER_EPOCHS = 3
# the timed run: a corpus of TIMING_IMAGES train images through 2 epochs at
# phase 10's B=12 and 512x512, so an epoch has 25 steps and flushes its
# metrics every 5 as a real epoch does (the run above flushes every step)
TIMING_IMAGES = 300
TIMING_BATCH = 12
# the trainer's eval (bf16, the decode kernel) against the same pipeline
# with the plain decode: the share of the plain detections that it gives
# too (same box, score and class to EVAL_AGREEMENT_ATOL). The decode kernel
# is 6e-8 off its plain version, so only near-ties at the NMS pool's cutoff
# or between overlapping boxes may part them
EVAL_AGREEMENT = 0.99
EVAL_AGREEMENT_ATOL = 1e-3


def phase11_trainer(dev, tag, bare_ips, tmp):
    """Phase 11: ``Trainer(cfg).run()`` on the card for TRAINER_EPOCHS epochs
    of full-width mobilenetv2-fpn from ``yamls/shapes.yaml`` (batch 16,
    sizes 416-512, lr 4e-4, host augment chain) on a synth_shapes corpus;
    then loading the last checkpoint, resuming from the epoch-1 checkpoint,
    the trainer's eval against the same pipeline with the plain decode and
    the evaluator against the eval split's own boxes, the predict CLI on an
    eval image, and a timed run of 25-step epochs at B=12, 512x512.
    ``bare_ips``: phase 10's images/s of the bare step (B=12, 512x512);
    ``tmp``: the directory of the corpus and checkpoints, which phase 12
    reads on. Raises on any failed gate; returns the corpus directory and
    the last checkpoint of the main run."""
    import re
    import numpy as np
    import torch
    from pqdet_tpu_torch.config import load_config
    from pqdet_tpu_torch.data.scripts.synth_shapes import generate
    from pqdet_tpu_torch.evaluation.evaluator import Evaluator
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    from pqdet_tpu_torch.model.factory import inference_params
    from pqdet_tpu_torch.train.checkpoint import load_weights_into
    from pqdet_tpu_torch.train.step import tree_leaves
    from pqdet_tpu_torch.train.trainer import Trainer
    from pqdet_tpu_torch.utils.codec import load_checkpoint

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))

    class ProbedTrainer(Trainer):
        """The trainer with probes: per-step losses (read after each epoch),
        the first step at each input size timed between synchronisations,
        kernel launches and seconds of each epoch and each evaluation."""

        def init_all(self):
            super().init_all()
            self.probe = {'loss': {}, 'first_step_s': {}, 'epochs': {}, 'evals': {},
                          'plans': {}}
            step = self.step_fn

            def probed(params, state, opt_state, batch, rng=None):
                size = tuple(batch['image'].shape[1:3])
                first = size not in self.probe['first_step_s']
                if first:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                out = step(params, state, opt_state, batch, rng)
                if first:
                    torch.cuda.synchronize()
                    self.probe['first_step_s'][size] = time.perf_counter() - t0
                self.probe['loss'].setdefault(self._epoch, []).append(out[3]['loss'])
                return out
            self.step_fn = probed

        def train_epoch(self, epoch):
            self._epoch = epoch
            d = self.train_data
            self.probe['plans'][epoch] = (d._epoch, list(d._indexes), list(d._sizes))
            reset_kernel_launches()
            t0 = time.perf_counter()
            split = super().train_epoch(epoch)
            self.probe['epochs'][epoch] = {'s': time.perf_counter() - t0,
                                           'launches': kernel_launches(),
                                           'steps': self.steps_per_epoch, **split}
            self.probe['loss'][epoch] = [float(x) for x in self.probe['loss'][epoch]]
            return split

        def evaluate(self):
            reset_kernel_launches()
            t0 = time.perf_counter()
            ap = super().evaluate()
            self.probe['evals'][self._epoch] = {'s': time.perf_counter() - t0, 'AP': ap.AP,
                                                'launches': kernel_launches(),
                                                'batches': len(self.eval_data)}
            return ap

    root = os.path.join(tmp, 'shapes')
    t0 = time.perf_counter()
    generate(root, n=CORPUS_IMAGES, size=CORPUS_SIZE, seed=SEED, holdout=CORPUS_HOLDOUT,
             vary_aspect=True)
    print(f'phase 11: wrote {CORPUS_IMAGES} synth_shapes images at {CORPUS_SIZE} '
          f'(sides {CORPUS_SIZE * 6 // 10}-{CORPUS_SIZE * 14 // 10 - 1} px), holdout '
          f'{CORPUS_HOLDOUT}, in {time.perf_counter() - t0:.2f} s')
    workers = str(os.cpu_count() or 1)

    def config(*extra):
        return load_config(os.path.join(here, 'yamls', 'shapes.yaml'), [
            'dataset.train_txt_file', os.path.join(root, 'train.txt'),
            'dataset.eval_txt_file', os.path.join(root, 'test.txt'),
            'augment.device', 'off', 'train.max_epochs', str(TRAINER_EPOCHS),
            'eval.after', '1', 'weight.dir', os.path.join(tmp, 'weights'),
            'system.num_workers', workers, *extra])
    cfg = config()
    t = cfg.train
    print(f'phase 11: yamls/shapes.yaml with overrides: batch {t.batch_size}, input sizes '
          f'{t.input_sizes}, lr {t.learning_rate_init}, {cfg.system.compute_dtype}, mixup '
          f'{cfg.augment.mixup_p}, crop {cfg.augment.crop_p}, hflip {cfg.augment.hflip_p}, '
          f'{t.max_epochs} epochs, eval after epoch {cfg.eval.after}, {workers} loader '
          f'threads')

    trainer = ProbedTrainer(cfg)
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    pr, b = trainer.probe, cfg.train.batch_size
    fails = []

    def gate(ok, what):
        print(f'phase 11: {what}: {"ok" if ok else "FAIL"}')
        if not ok:
            fails.append(what)

    print(f'phase 11: Trainer.run() {run_s:.2f} s, {trainer.steps_per_epoch} steps an epoch')
    for e, ep in sorted(pr['epochs'].items()):
        ips = ep['steps'] * b / ep['s']
        print(f'phase 11: {tag} epoch {e}: {ep["s"]:.3f} s, data load {ep["data_load_s"]:.3f} '
              f's, model {ep["model_s"]:.3f} s, {ips:.2f} images/s; losses '
              f'{[round(x, 3) for x in pr["loss"][e]]}; kernel launches {ep["launches"]}')
    for size, sec in pr['first_step_s'].items():
        print(f'phase 11: {tag} first step at {size[0]}x{size[1]}, B={b}: {sec:.3f} s')
    steady = [ep['steps'] * b / ep['s'] for e, ep in pr['epochs'].items() if e > 0]
    print(f'phase 11: {tag} trainer images/s (epochs 1-{TRAINER_EPOCHS - 1}, B={b}, sizes '
          f'{cfg.train.input_sizes}, metrics flushed every {trainer._print_interval} '
          f'steps): {statistics.mean(steady):.2f}; the bare step of '
          f'phase 10 (B=12, 512x512, one fixed batch): {bare_ips:.2f}')
    for e, ev in sorted(pr['evals'].items()):
        print(f'phase 11: {tag} eval after epoch {e}: {ev["s"]:.3f} s, {ev["batches"]} '
              f'batches, AP {ev["AP"]:.6f}, kernel launches {ev["launches"]}')

    losses = [x for e in pr['loss'] for x in pr['loss'][e]]
    gate(all(math.isfinite(x) for x in losses), f'all {len(losses)} step losses finite')
    first, last = statistics.mean(pr['loss'][0]), statistics.mean(pr['loss'][2])
    gate(last < first, f'mean loss of epoch 2 {last:.4f} below epoch 0 {first:.4f} '
         f'(ratio {last / first:.4f})')
    gate(sorted(pr['evals']) == [1, 2] and all(
        math.isfinite(ev['AP']) and 0.0 <= ev['AP'] <= 1.0 for ev in pr['evals'].values()),
         f'AP evaluated after epochs {sorted(pr["evals"])}, finite, in [0, 1]')
    gate(all(not any(ep['launches'].values()) for ep in pr['epochs'].values()),
         'hand-written kernel launches during training steps: 0')
    gate(all(ev['launches'] == {**dict.fromkeys(ev['launches'], 0),
                                'decode_heads': ev['batches']}
             for ev in pr['evals'].values()),
         'one decode_heads launch per eval batch, no other kernel')

    wdir = os.path.join(tmp, 'weights', cfg.experiment_name)
    names = sorted(os.listdir(wdir))
    want = ['model-0.ckpt'] + [f'model-{e}-{pr["evals"][e]["AP"]:.4f}.ckpt'
                               for e in sorted(pr['evals'])]
    gate(names == sorted(want), f'checkpoints {names} (want {sorted(want)})')
    last_ckpt = load_checkpoint(os.path.join(wdir, want[-1]))
    lp, ls = load_weights_into(trainer.network.graph, trainer.params, trainer.state,
                               last_ckpt)
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(lp) + tree_leaves(ls),
        tree_leaves(trainer.params) + tree_leaves(trainer.state)))
    gate(same and last_ckpt['step'] == trainer.global_step,
         f'the last checkpoint (step {last_ckpt["step"]}) loads the trainer\'s params and BN '
         'state bit for bit')

    # the trainer's eval on the card, held to the same pipeline with the
    # plain decode on the same params, and the evaluator to the eval
    # split's own boxes
    net, dtype = trainer.network, trainer._compute_dtype
    plain_predict = make_batch_predict(build_predict_pipeline(
        net, cfg, compute_dtype=dtype, device=dev,
        apply_fn=lambda p, im: net(p, {}, im, compute_dtype=dtype, plain=True)),
        inference_params(net, trainer.params, trainer.state))
    kernel_predict = trainer.make_predict_fn()
    same, n_img, n_det, n_found, launches = 0, 0, 0, 0, {'kernel': {}, 'plain': {}}
    for batch in trainer.eval_data.batches(cfg.system.num_workers, cfg.system.prefetch):
        outs = {}
        for name, fn in (('kernel', kernel_predict), ('plain', plain_predict)):
            reset_kernel_launches()
            with torch.inference_mode():
                outs[name] = fn(batch)
            for k, v in kernel_launches().items():
                launches[name][k] = launches[name].get(k, 0) + v
        for i in range(batch['count']):
            kd, pd = outs['kernel'][i], outs['plain'][i]
            near = np.abs(pd[:, None, :] - kd[None, :, :]).max(-1) <= EVAL_AGREEMENT_ATOL
            same += kd.shape == pd.shape and bool(near.diagonal().all())
            n_img, n_det, n_found = n_img + 1, n_det + len(pd), n_found + near.any(1).sum()
    share = n_found / max(n_det, 1)
    print(f'phase 11: {tag} the trainer\'s eval (decode kernel) against the plain decode '
          f'on its params: {n_found}/{n_det} plain detections found (share {share:.6f}), '
          f'{same}/{n_img} images with the same detections in the same order, to '
          f'{EVAL_AGREEMENT_ATOL}; launches {launches}')
    n_eval = len(trainer.eval_data)
    gate(n_det > 0 and share >= EVAL_AGREEMENT
         and launches['kernel'] == {**dict.fromkeys(launches['kernel'], 0),
                                    'decode_heads': n_eval}
         and not any(launches['plain'].values()),
         f'the trainer\'s eval gives {share:.6f} >= {EVAL_AGREEMENT} of the plain decode\'s '
         f'detections, with {n_eval} decode_heads launches (plain 0)')

    def gt_as_detections(batch):
        return [np.concatenate([bb[:, :4], np.ones((len(bb), 1), np.float32), bb[:, 4:5]], 1)
                for bb in batch['bboxes'][:batch['count']]]
    oracle = Evaluator(gt_as_detections, trainer.eval_data, cfg).evaluate()
    gate(abs(oracle.AP - 1.0) <= 1e-12,
         f'the evaluator scores the eval split\'s own boxes at AP {oracle.AP:.12f} (want 1)')

    # resume from the epoch-1 checkpoint into a second run dir
    resumed = ProbedTrainer(config('weight.resume', os.path.join(wdir, want[1]),
                                   'experiment_name', 'shapes_resumed'))
    resumed.init_all()
    lr = resumed.schedule(resumed.opt_state['schedule_count'])
    gate(resumed.global_step == 2 * trainer.steps_per_epoch
         and resumed.opt_state['schedule_count'] == resumed.global_step
         and resumed.opt_state['count'] == 0
         and lr == trainer.schedule(resumed.global_step),
         f'resumed at global_step {resumed.global_step}, epoch {resumed.init_epoch}, '
         f'schedule count {resumed.opt_state["schedule_count"]}, Adam count '
         f'{resumed.opt_state["count"]}, next lr {lr:.6g} = schedule({resumed.global_step})')
    resumed.train()
    rl = resumed.probe['loss'].get(2, [])
    gate(len(rl) == trainer.steps_per_epoch and all(math.isfinite(x) for x in rl),
         f'the resumed run\'s epoch 2: losses {[round(x, 3) for x in rl]}')
    gate(resumed.probe['plans'].get(2) == pr['plans'][2],
         'the resumed run\'s epoch 2 plan (augment epoch, indices, sizes) is the first '
         f'run\'s; first step loss {rl[:1]} against the first run\'s '
         f'{pr["loss"][2][:1]} on the same params and batch')

    img = open(os.path.join(root, 'test.txt')).read().split()[0]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, '-m', 'pqdet_tpu_torch.cli.predict', '--img', img,
                          '--weight', os.path.join(wdir, want[-1]), '--yaml',
                          os.path.join(here, 'yamls', 'shapes.yaml'), '--output',
                          os.path.join(tmp, 'mark.jpg')],
                         cwd=here, capture_output=True, text=True, timeout=300)
    boxes = re.findall(r'box=\(([^)]*)\) score=(\S+)', res.stdout)
    vals = [float(v) for bx, sc in boxes for v in bx.split(',') + [sc]]
    head = res.stdout.strip().splitlines()[:4]
    print(f'phase 11: predict CLI on {os.path.basename(img)}: exit {res.returncode}, '
          f'{time.perf_counter() - t0:.2f} s; {head}')
    if res.returncode != 0:
        print(res.stderr[-3000:])
    gate(res.returncode == 0 and f'{len(boxes)} detections' in res.stdout
         and all(math.isfinite(v) for v in vals),
         f'predict exits 0 with {len(boxes)} finite detections')

    # the timed run: 25-step epochs at B=12, 512x512
    root2 = os.path.join(tmp, 'shapes_timing')
    t0 = time.perf_counter()
    generate(root2, n=TIMING_IMAGES, size=CORPUS_SIZE, seed=SEED + 1, holdout=0.0,
             vary_aspect=True)
    gen_s = time.perf_counter() - t0
    timed = ProbedTrainer(config(
        'dataset.train_txt_file', os.path.join(root2, 'train.txt'),
        'train.batch_size', str(TIMING_BATCH), 'train.input_sizes', f'[{CORPUS_SIZE}]',
        'train.max_epochs', '2', 'eval.after', '2', 'experiment_name', 'shapes_timing'))
    timed.run()
    torch.cuda.synchronize()
    ep = timed.probe['epochs'][1]
    tl = [x for e in timed.probe['loss'] for x in timed.probe['loss'][e]]
    ips = ep['steps'] * TIMING_BATCH / ep['s']
    print(f'phase 11: {tag} timed run ({TIMING_IMAGES} images written in {gen_s:.2f} s, '
          f'B={TIMING_BATCH}, {CORPUS_SIZE}x{CORPUS_SIZE}, {timed.steps_per_epoch} steps '
          f'an epoch, metrics flushed every {timed._print_interval} steps): epoch 0 '
          f'{timed.probe["epochs"][0]["s"]:.3f} s; epoch 1 {ep["s"]:.3f} s, data load '
          f'{ep["data_load_s"]:.3f} s (share {ep["data_load_s"] / ep["s"]:.4f}), model '
          f'{ep["model_s"]:.3f} s, {ips:.2f} images/s against the bare step\'s '
          f'{bare_ips:.2f} (ratio {ips / bare_ips:.4f})')
    gate(timed.steps_per_epoch >= 25 and all(math.isfinite(x) for x in tl)
         and not any(ep['launches'].values()),
         f'the timed run: {len(tl)} finite step losses, 0 kernel launches')
    print(f'phase 11: {tag} phase seconds {time.perf_counter() - t_phase:.1f}')
    if fails:
        raise AssertionError(f'phase 11 gates failed: {fails}')
    return {'root': root, 'ckpt': os.path.join(wdir, want[-1]), 'workers': workers,
            'host_epochs': pr['epochs'], 'batch': b, 'bare_ips': bare_ips,
            'timed': {'train': os.path.join(root2, 'train.txt'), 'ips': ips}}


# the QAT arc (phase 12): yamls/shapes_quant.yaml resumed from phase 11's
# last fp checkpoint on its corpus; epoch 0 observes with BN on batch
# statistics, epoch 1 freezes the observers, epoch 2 BN as well
QAT_EPOCHS = 3
QAT_OBSERVE_EPOCHS = 1         # quant.disable_observer_after
QAT_BN_EPOCHS = 2              # quant.freeze_bn_after
QAT_WARMUP = 3                 # the timed QAT steps: after these ...
QAT_TIMED_STEPS = 10           # ... these, at B=TIMING_BATCH, TRAIN_SIZE, bf16
# the card's QAT step against the CPU's (f32, TF32 off, B=PARITY_BATCH),
# with BN and observers frozen (PARITY_RUNNING_SIZE) and with batch
# statistics and observers updating (PARITY_SIZE). The whole walk is chaotic
# in its rounding: a conv's sums in another order move a few fake-quant codes
# a whole step, and each moved code moves codes downstream, so its grads
# cannot be held tightly (they are printed beside a drift of the same
# function with its sums in another order: with BN frozen the card's own with
# cuDNN off, with batch statistics the CPU's own on the reversed batch, as
# phase 9 holds the fp step). The gates are node by node, as phase 7 holds
# the int8 path: each node of the walk (the input edge, each conv with its
# weight fake-quant, BN and edge fake-quant, each shortcut, route, upsample,
# and each yolo head's loss) runs on the card and on the CPU from the CPU
# walk's inputs to it, and its output, new observer and BN statistics and
# the VJP of a seeded normal cotangent (of its loss, at a head) are held to
# the CPU's:
QAT_NODE_CODES_APART = 1e-3    # share of a quantised edge's codes apart
QAT_NODE_OUT_L2 = 1e-5         # relative L2 of an output with no edge (the heads' convs)
QAT_NODE_LOSS_RTOL = 1e-5      # max relative error of a head's loss parts
QAT_NODE_STATE_ATOL = 1e-5     # max |d| / max(1, |v|) of new observers and BN statistics
QAT_NODE_GRAD_L2 = 1e-4        # relative L2 of each grad (an input's, a param's)
# the whole walk's loss parts: within QAT_DRIFT_FACTOR x the drift, at least
# QAT_WALK_PARTS_RTOL (frozen) or 1e-3 (batch statistics); its new
# observers (batch statistics) within QAT_DRIFT_FACTOR x the CPU's own, at
# least 1e-6
QAT_WALK_PARTS_RTOL = 1e-4
QAT_DRIFT_FACTOR = 2.0
# per int8 eval forward (phase 7's count)
INT8_FORWARD_LAUNCHES = {'qconv1x1_s8': 58, 'qdwconv3x3_s8': 26, 'decode_heads': 1}
INT8_EVAL_SAME_IMAGES = 30     # of the 32 eval images, identical to the plain versions'
INT8_EVAL_AGREEMENT = 0.999    # share of the plain versions' detections found


def qat_step_parts(net, params, state, batch, dev, cfg, train, observing):
    """Loss parts, grads and new state (BN statistics and observers) of the
    port's QAT loss (``make_qat_loss_fn``) on ``dev`` in f32, on the CPU."""
    import torch
    from pqdet_tpu_torch.model.network import to_device
    from pqdet_tpu_torch.ops.labels import label_assigner_from_config
    from pqdet_tpu_torch.train.step import make_qat_loss_fn, value_and_grad
    p, s, b = to_device(params, dev), to_device(state, dev), to_device(batch, dev)
    loss_fn = make_qat_loss_fn(net, observing=observing, bn_frozen=not train,
                               label_fn=label_assigner_from_config(cfg, device=dev))
    (_, (losses, new_state, _)), grads = value_and_grad(loss_fn, p, s, b)
    out = {'parts': torch.stack([losses[k][0] for k in
                                 ('loss', 'giou_loss', 'conf_loss', 'class_loss')]),
           'grads': grads, 'state': new_state}
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    return to_device(out, torch.device('cpu'))


def qat_walk_inputs(net, params, state, batch, cfg, train, observing):
    """The CPU's f32 QAT walk on ``batch``: (the inputs of every node,
    targets). {'input': the normalised images, 'x0': their fake-quantised
    form, node: its output} on the CPU."""
    import torch
    from pqdet_tpu_torch.compress.qat import QuantCtx
    from pqdet_tpu_torch.ops.labels import label_assigner_from_config
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    cpu = torch.device('cpu')
    image = device_normalize(batch['image'])
    targets = label_assigner_from_config(cfg, device=cpu)(batch['gt'], image.shape[1:3])
    outs = {'input': image}
    with torch.no_grad():
        outs['x0'] = QuantCtx(state['quant'], observing).quantize_input(image)
        net.forward_train(params, state, image, train=train,
                          quant_ctx=QuantCtx(state['quant'], observing),
                          tap=lambda i, t: outs.__setitem__(i, t.detach().clone()))
    return outs, targets


def qat_node_run(net, i, params, state, inputs, targets, dev, train, observing):
    """Node ``i`` of the f32 QAT walk ('input': the input edge) on ``dev``
    from ``inputs`` ({'x' or a ref index: CPU tensor}) with its params, BN
    state and observer: (output, {'quant' / 'bn': its new observer / BN
    statistics}, {leaf: grad}), on the CPU. A quantised edge's output is its
    uint8 codes (as f32); a yolo node's, its loss parts, and its grads are
    those of its loss; any other node's grads are the VJP of a normal
    cotangent seeded by ``i``."""
    import torch
    from pqdet_tpu_torch.compress.qat import QuantCtx, act_qparams
    from pqdet_tpu_torch.model.network import to_device
    cpu = torch.device('cpu')
    key = str(i)
    leaves = {}

    def leaf(t, name):
        if isinstance(t, dict):
            return {k: leaf(v, f'{name}/{k}') for k, v in t.items()}
        leaves[name] = t.detach().to(dev).requires_grad_(True)
        return leaves[name]

    xs = {k: leaf(v, f'input {k}') for k, v in inputs.items()}
    p = {key: leaf(params[key], 'param')} if key in params else {}
    s = to_device({k: v for k, v in state.items() if k in (key, 'quant')}, dev)
    ctx = QuantCtx(s['quant'], observing=observing)
    new = {}
    if i == 'input':
        out = ctx.quantize_input(xs['x'])
        yolo = False
    else:
        node = net.graph.nodes[i]
        yolo = node.kind == 'yolo'
        out, _, updates, losses, _ = net._walk(
            [node], p, s, xs.get('x'), {r: xs[r] for r in node.refs}, None,
            quant_ctx=ctx, targets=tuple(t.to(dev) for t in targets) if yolo else None,
            train=train)
        if key in updates:
            new['bn'] = updates[key]
    if yolo:
        parts = torch.cat(losses[0])
        shown, out, cot = parts.detach(), parts[0], None
    else:
        shown = out.detach()
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            0 if i == 'input' else i + 1)).to(dev)
    if key in s['quant']:
        obs = ctx.new_obs[key]
        if observing:
            new['quant'] = obs
        scale, zp = act_qparams(obs)        # (q - zp) * scale back to q, exactly
        shown = torch.round(shown / scale + zp)
    names = list(leaves)
    grads = torch.autograd.grad(out, [leaves[n] for n in names], cot, allow_unused=True)
    grads = {n: g for n, g in zip(names, grads) if g is not None}
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    return shown.to(cpu), to_device(new, cpu), to_device(grads, cpu)


def qat_node_parity(net, params, state, batch, dev, cfg, train, observing):
    """The QAT walk node by node (the comment above QAT_NODE_CODES_APART):
    {check: (worst reading, its node, bound)} over every node of the walk."""
    import torch
    from pqdet_tpu_torch.model.network import to_device
    cpu = torch.device('cpu')
    params, state = to_device(params, cpu), to_device(state, cpu)
    ins, targets = qat_walk_inputs(net, params, state, batch, cfg, train, observing)
    worst = {}

    def note(what, err, node, bound):
        if what not in worst or err > worst[what][0] or math.isnan(err):
            worst[what] = (err, node, bound)

    def rel_l2(a, b):
        d, n = (a - b).norm().item(), b.norm().item()
        return d / n if n > 0 else (0.0 if d == 0 else math.inf)

    def state_gap(a, b):
        return max(((x - y).abs() / y.abs().clamp_min(1.0)).max().item()
                   for k in b for x, y in [(a[k].float(), b[k].float())])

    quant = state['quant']
    for node in ['input', *net.graph.nodes]:
        i = node if node == 'input' else node.index
        if i == 'input':
            inputs = {'x': ins['input']}
        else:
            inputs = {r: ins[r] for r in node.refs}
            if node.kind != 'route':
                inputs['x'] = ins['x0'] if i == 0 else ins[i - 1]
        card = qat_node_run(net, i, params, state, inputs, targets, dev, train, observing)
        host = qat_node_run(net, i, params, state, inputs, targets, cpu, train, observing)
        (a, an, ag), (b, bn, bg) = card, host
        if str(i) in quant:
            note('quantised edge, share of codes apart', (a != b).float().mean().item(), i,
                 QAT_NODE_CODES_APART)
        elif i != 'input' and node.kind == 'yolo':
            note('head loss parts, max rel err',
                 ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item(), i, QAT_NODE_LOSS_RTOL)
        else:
            note('output with no edge, relative L2', rel_l2(a, b), i, QAT_NODE_OUT_L2)
        if set(an) != set(bn):
            note('new state entries', math.inf, i, 0.0)
        for k in bn:
            note(f'new {"observer" if k == "quant" else "BN statistics"}, max |d| / max(1, |v|)',
                 state_gap(an[k], bn[k]), i, QAT_NODE_STATE_ATOL)
        if set(ag) != set(bg):
            note('grads present', math.inf, i, 0.0)
        for n in bg:
            kind = 'input' if n.startswith('input') else 'param'
            note(f'{kind} grads, relative L2', rel_l2(ag[n], bg[n]), f'{i} ({n})',
                 QAT_NODE_GRAD_L2)
    return worst


def phase12_parity(net, params, state, gen, dev, cfg):
    """Phase 12.3: the card's QAT step against the CPU's on the same batch,
    params and observers (f32), BN and observers frozen and then batch
    statistics with observers updating: node by node (``qat_node_parity``,
    every bound printed), and the whole walk's loss parts and new observers
    within QAT_DRIFT_FACTOR x a drift of the same step with its sums in
    another order (the comment above QAT_NODE_CODES_APART); the whole
    walk's grads are printed beside their drift. Returns the failed
    checks."""
    import torch
    from pqdet_tpu_torch.train.step import tree_leaves
    cpu = torch.device('cpu')
    fails = []
    nc = len(cfg.dataset.classes)

    def check(what, err, bound, node=None):
        ok = err <= bound
        at = '' if node is None else f' at node {node}'
        print(f'phase 12: card vs CPU f32 QAT step B={PARITY_BATCH} {what} {err:.4g}{at} '
              f'(bound {bound:.4g}) {"ok" if ok else "FAIL"}')
        if not ok:
            fails.append(what)

    def flat(tree):
        return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])

    def rel(a, b):
        return ((a - b).abs() / b.abs()).max().item()

    def l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    def obs_gap(a, b):
        return max(abs(float(a[e][k]) - float(o[k])) / max(1.0, abs(float(o[k])))
                   for e, o in b.items() for k in ('min', 'max'))

    for size, train in ((PARITY_RUNNING_SIZE, False), (PARITY_SIZE, True)):
        what = (f'{size}x{size} ' + ('batch statistics, observers updating' if train else
                                    'BN and observers frozen'))
        batch = train_batch(gen, PARITY_BATCH, size, cpu, cfg.model.max_gt_boxes, nc)
        t0 = time.perf_counter()
        worst = qat_node_parity(net, params, state, batch, dev, cfg, train, train)
        print(f'phase 12: {what}: every node on the card and the CPU from the CPU\'s inputs '
              f'{time.perf_counter() - t0:.2f} s')
        for k, (err, node, bound) in worst.items():
            check(f'{what}, node by node: {k}, worst', err, bound, node)
        t0 = time.perf_counter()
        card = qat_step_parts(net, params, state, batch, dev, cfg, train, train)
        host = qat_step_parts(net, params, state, batch, cpu, cfg, train, train)
        if train:
            own = qat_step_parts(net, params, state, {k: v.flip(0) for k, v in batch.items()},
                                 cpu, cfg, True, True)
            drift, yard_of = 'the CPU\'s own on the reversed batch', host
        else:
            with torch.backends.cudnn.flags(enabled=False):
                own = qat_step_parts(net, params, state, batch, dev, cfg, False, False)
            drift, yard_of = 'the card\'s own with cuDNN off', card
        print(f'phase 12: {what}: the whole step on the card, the CPU and {drift} '
              f'{time.perf_counter() - t0:.2f} s')
        yard = rel(own['parts'], yard_of['parts'])
        check(f'{what}, whole walk: loss and parts, max rel err ({drift} {yard:.4g})',
              rel(card['parts'], host['parts']),
              max(1e-3 if train else QAT_WALK_PARTS_RTOL, QAT_DRIFT_FACTOR * yard))
        g, h, o = (flat(x['grads']) for x in (card, host, own))
        print(f'phase 12: card vs CPU f32 QAT step B={PARITY_BATCH} {what}, whole walk: grads, '
              f'relative L2 distance {l2(g, h):.4g} ({drift} {l2(o, flat(yard_of["grads"])):.4g}; '
              'not a gate: the rounding cascade, held node by node above)')
        if train:
            yard = obs_gap(own['state']['quant'], host['state']['quant'])
            check(f'{what}, whole walk: new observers, max |d| / max(1, |v|) ({drift} '
                  f'{yard:.4g})', obs_gap(card['state']['quant'], host['state']['quant']),
                  max(1e-6, QAT_DRIFT_FACTOR * yard))
    return fails


def fold_stages_apart(net, params, state, dev):
    """Where the BN fold (``layers.fold_bn_into_conv``) rounds apart on
    ``dev``: each of its ops run on ``dev`` and on the CPU from the CPU's
    inputs to it, over every conv with BN. {op: (elements, apart, of those
    the card's equal to the op in f64 rounded to f32, the CPU's equal to
    it)}; for these ops the f64 result rounded to f32 is the correctly
    rounded f32 one."""
    import torch
    from pqdet_tpu_torch.model.layers import BN_EPS
    eps = float(torch.tensor(BN_EPS, dtype=torch.float32))
    ops = [('var + eps', lambda t: t['var'] + eps, 'v'),
           ('sqrt', lambda t: torch.sqrt(t['v']), 'r'),
           ('gamma / sqrt', lambda t: t['gamma'] / t['r'], 'scale'),
           ('w * scale', lambda t: t['w'] * t['scale'][:, None, None, None], 'nw'),
           ('0 - mean', lambda t: torch.zeros_like(t['mean']) - t['mean'], 'b0'),
           ('(0 - mean) * scale', lambda t: t['b0'] * t['scale'], 'b1'),
           ('+ beta', lambda t: t['b1'] + t['beta'], 'nb')]
    counts = {name: [0, 0, 0, 0] for name, _, _ in ops}
    for node in net.graph.nodes:
        key = str(node.index)
        p = params.get(key)
        if node.kind != 'convolutional' or p is None or 'bn' not in p:
            continue
        t = {'w': p['w'].cpu(), 'gamma': p['bn']['gamma'].cpu(), 'beta': p['bn']['beta'].cpu(),
             'mean': state[key]['mean'].cpu(), 'var': state[key]['var'].cpu()}
        for name, fn, out in ops:
            host = fn(t)
            card = fn({k: v.to(dev) for k, v in t.items()}).cpu()
            exact = fn({k: v.double() for k, v in t.items()}).float()
            apart = card != host
            c = counts[name]
            c[0] += host.numel()
            c[1] += int(apart.sum())
            c[2] += int((card[apart] == exact[apart]).sum())
            c[3] += int((host[apart] == exact[apart]).sum())
            t[out] = host
    return {k: tuple(v) for k, v in counts.items()}


def phase12_timings(net, params, state, gen, dev, cfg, tag, fp):
    """Phase 12.4: the bf16 QAT step at TIMING_BATCH, TRAIN_SIZE (phase 10's
    fp step's shape) with observers on and off, BN on batch statistics:
    ms per step p50 and p90 (CUDA events, synchronised each step, after
    QAT_WARMUP steps), peak memory, kernel launches (0) and a profiled step
    (host launches, device idle share). ``fp``: phase 10's p50 and p90.
    Returns the failed checks."""
    import torch
    from pqdet_tpu_torch.ops.labels import label_assigner_from_config
    from pqdet_tpu_torch.train.step import make_optimizer, make_qat_train_step
    fails = []
    nc = len(cfg.dataset.classes)
    batch = train_batch(gen, TIMING_BATCH, TRAIN_SIZE, dev, cfg.model.max_gt_boxes, nc)
    labels = label_assigner_from_config(cfg, device=dev)
    opt = make_optimizer(lambda k: cfg.train.learning_rate_init)
    for observing in (True, False):
        step = make_qat_train_step(net, opt, observing=observing, bn_frozen=False,
                                   compute_dtype=torch.bfloat16, label_fn=labels)
        p, s, o = params, state, opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()
        ms, losses = [], []
        for _ in range(QAT_WARMUP + QAT_TIMED_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            p, s, o, m = step(p, s, o, batch)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m['loss']))
        peak = torch.cuda.max_memory_allocated()
        launches = kernel_launches()
        timed = sorted(ms[QAT_WARMUP:])
        p50, p90 = statistics.median(timed), timed[int(0.9 * (len(timed) - 1))]
        on = 'on' if observing else 'off'
        print(f'phase 12: {tag} QAT step mobilenetv2-fpn (quant graph, {nc} classes) '
              f'{TRAIN_SIZE}x{TRAIN_SIZE} B={TIMING_BATCH} bf16, observers {on}, BN on batch '
              f'statistics ({QAT_TIMED_STEPS} steps after {QAT_WARMUP} of warm-up, CUDA events, '
              f'synchronised each step): p50 {p50:.3f} ms, p90 {p90:.3f} ms, '
              f'{TIMING_BATCH * 1000.0 / p50:.2f} images/s; peak memory {peak / 2**30:.3f} GiB; '
              f'against phase 10\'s fp step p50 {fp["p50"]:.3f} ms, p90 {fp["p90"]:.3f} ms '
              f'(ratio {p50 / fp["p50"]:.3f}); losses {[round(x, 3) for x in losses]}; kernel '
              f'launches {launches}')
        if not all(math.isfinite(x) for x in losses) or any(launches.values()):
            fails.append(f'timed QAT steps, observers {on}: finite losses, 0 kernel launches')
        profile_calls(lambda: step(p, s, o, batch), tag, 'phase 12',
                      f'step QAT B={TIMING_BATCH} observers {on}')
    return fails


def eval_agreement(kernel_predict, plain_predict, eval_data, cfg):
    """Both predict functions over the eval split, batch by batch: (images
    whose detections are the same in the same order, images, the second's
    detections, those of them the first finds, to EVAL_AGREEMENT_ATOL), and
    the kernel launches of each ({'kernel': {...}, 'plain': {...}})."""
    import numpy as np
    import torch
    n_same, n_img, n_det, n_found, launches = 0, 0, 0, 0, {'kernel': {}, 'plain': {}}
    for batch in eval_data.batches(cfg.system.num_workers, cfg.system.prefetch):
        outs = {}
        for name, fn in (('kernel', kernel_predict), ('plain', plain_predict)):
            reset_kernel_launches()
            with torch.inference_mode():
                outs[name] = fn(batch)
            for k, v in kernel_launches().items():
                launches[name][k] = launches[name].get(k, 0) + v
        for i in range(batch['count']):
            kd, pd = outs['kernel'][i], outs['plain'][i]
            near = np.abs(pd[:, None, :] - kd[None, :, :]).max(-1) <= EVAL_AGREEMENT_ATOL
            n_same += kd.shape == pd.shape and bool(near.diagonal().all())
            n_img, n_det, n_found = n_img + 1, n_det + len(pd), n_found + near.any(1).sum()
    return n_same, n_img, n_det, int(n_found), launches


def phase12_qat(dev, tag, tmp, corpus, fp):
    """Phase 12: the QAT arc on the card. ``Trainer(cfg).run()`` of
    ``yamls/shapes_quant.yaml`` (full-width mobilenetv2-fpn, 3 classes, B=16,
    512x512, lr 5e-5) resumed from phase 11's last fp checkpoint on its
    corpus (``corpus``, phase 11's return value, in ``tmp``) for QAT_EPOCHS
    epochs with the observers frozen from epoch QAT_OBSERVE_EPOCHS and BN
    from QAT_BN_EPOCHS, the converted int8 model evaluated after every
    epoch; then the trainer's int8 eval against the plain versions, the
    convert and bench CLIs on its last checkpoint, the QAT step's timings
    (``fp``: phase 10's) and the card's QAT step against the CPU's.
    Raises on any failed gate."""
    import re
    from collections import Counter
    import torch
    from pqdet_tpu_torch.compress.qat import act_qparams
    from pqdet_tpu_torch.compress.quantized import (Int8Inference, convert_to_int8,
                                                    load_quantized)
    from pqdet_tpu_torch.config import load_config
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    from pqdet_tpu_torch.model.network import fuse_params, to_device
    from pqdet_tpu_torch.utils.codec import load_checkpoint
    from pqdet_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    yaml_path = os.path.join(here, 'yamls', 'shapes_quant.yaml')
    root = corpus['root']
    data = ['dataset.train_txt_file', os.path.join(root, 'train.txt'),
            'dataset.eval_txt_file', os.path.join(root, 'test.txt'),
            'system.num_workers', corpus['workers']]
    wdir_root = os.path.join(tmp, 'weights_qat')
    cfg = load_config(yaml_path, data + [
        'weight.dir', wdir_root, 'weight.resume', corpus['ckpt'],
        'train.max_epochs', str(QAT_EPOCHS), 'quant.disable_observer_after',
        str(QAT_OBSERVE_EPOCHS), 'quant.freeze_bn_after', str(QAT_BN_EPOCHS), 'eval.after', '0'])
    t, q = cfg.train, cfg.quant
    print(f'phase 12: yamls/shapes_quant.yaml with overrides: resume {corpus["ckpt"]} '
          f'(clear_history {cfg.weight.clear_history}), batch {t.batch_size}, input sizes '
          f'{t.input_sizes}, lr {t.learning_rate_init}, {cfg.system.compute_dtype}, mixup '
          f'{cfg.augment.mixup_p}, {t.max_epochs} epochs, observers until epoch '
          f'{q.disable_observer_after}, BN frozen from epoch {q.freeze_bn_after}, eval after '
          f'every epoch from {cfg.eval.after}')

    def snapshot(state):
        return {k: {kk: vv.clone() for kk, vv in v.items()} if k != 'quant' else
                {e: {kk: vv.clone() for kk, vv in o.items()} for e, o in v.items()}
                for k, v in state.items()}

    def same(a, b):
        return all(torch.equal(a[k][kk], b[k][kk]) for k in b for kk in b[k])

    class ProbedQAT(Trainer):
        """The trainer with probes: per-step losses, the phase, kernel
        launches, seconds and the state at both ends of each epoch, and
        kernel launches, seconds and AP of each evaluation."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.probe = {'loss': {}, 'epochs': {}, 'evals': {}}

        def _make_step(self):
            step, opt = super()._make_step()

            def probed(params, state, opt_state, batch, rng=None):
                out = step(params, state, opt_state, batch, rng)
                self.probe['loss'].setdefault(self._epoch, []).append(out[3]['loss'])
                return out
            return probed, opt

        def train_epoch(self, epoch):
            self._epoch = epoch
            before = snapshot(self.state)
            reset_kernel_launches()
            t0 = time.perf_counter()
            split = super().train_epoch(epoch)
            self.probe['epochs'][epoch] = {
                's': time.perf_counter() - t0, 'launches': kernel_launches(),
                'steps': self.steps_per_epoch, 'phase': (self._observing, self._bn_frozen),
                'before': before, 'after': snapshot(self.state), **split}
            self.probe['loss'][epoch] = [float(x) for x in self.probe['loss'][epoch]]
            return split

        def evaluate(self):
            reset_kernel_launches()
            t0 = time.perf_counter()
            ap = super().evaluate()
            torch.cuda.synchronize()
            self.probe['evals'][self._epoch] = {'s': time.perf_counter() - t0, 'AP': ap.AP,
                                                'launches': kernel_launches(),
                                                'batches': len(self.eval_data)}
            return ap

    trainer = ProbedQAT(cfg)
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    pr, b = trainer.probe, cfg.train.batch_size
    fails = []

    def gate(ok, what):
        print(f'phase 12: {what}: {"ok" if ok else "FAIL"}')
        if not ok:
            fails.append(what)

    print(f'phase 12: Trainer.run() (QAT) {run_s:.2f} s, {trainer.steps_per_epoch} steps an '
          'epoch')
    for e, ep in sorted(pr['epochs'].items()):
        print(f'phase 12: {tag} QAT epoch {e} (observers {"on" if ep["phase"][0] else "off"}, '
              f'BN {"frozen" if ep["phase"][1] else "on batch statistics"}): {ep["s"]:.3f} s, '
              f'data load {ep["data_load_s"]:.3f} s, model {ep["model_s"]:.3f} s, '
              f'{ep["steps"] * b / ep["s"]:.2f} images/s; losses '
              f'{[round(x, 3) for x in pr["loss"][e]]}; kernel launches {ep["launches"]}')
    for e, ev in sorted(pr['evals'].items()):
        print(f'phase 12: {tag} int8 eval after QAT epoch {e} (convert, then Int8Inference '
              f'kernel mode): {ev["s"]:.3f} s, {ev["batches"]} batches, AP {ev["AP"]:.6f}, '
              f'kernel launches {ev["launches"]}')

    losses = [x for e in pr['loss'] for x in pr['loss'][e]]
    gate(all(math.isfinite(x) for x in losses), f'all {len(losses)} QAT step losses finite')
    phases = {e: ep['phase'] for e, ep in pr['epochs'].items()}
    gate(phases == {0: (True, False), 1: (False, False), 2: (False, True)},
         f'the phases (observing, BN frozen) of the epochs: {phases}')
    gate(all(not any(ep['launches'].values()) for ep in pr['epochs'].values()),
         'hand-written kernel launches during QAT steps: 0')
    gate(sorted(pr['evals']) == list(range(QAT_EPOCHS)) and all(
        ev['launches'] == {**dict.fromkeys(ev['launches'], 0),
                           **{k: n * ev['batches'] for k, n in INT8_FORWARD_LAUNCHES.items()}}
        and math.isfinite(ev['AP']) and 0.0 <= ev['AP'] <= 1.0
        for ev in pr['evals'].values()),
         f'an int8 eval after every epoch, AP finite in [0, 1], launching per forward '
         f'{INT8_FORWARD_LAUNCHES} and no fused-IR kernel')
    obs0 = pr['epochs'][0]['after']['quant']
    ranges = [float(act_qparams(o)[0]) for o in obs0.values()]
    ready = sum(bool(o['initialized']) and float(o['max']) > float(o['min'])
                for o in obs0.values())
    gate(len(obs0) == 98 and ready == 98 and min(ranges) > 1e-6,
         f'after epoch 0: {ready} of {len(obs0)} observers initialised with max > min, '
         f'scales {min(ranges):.4g} to {max(ranges):.4g}')
    e1, e2 = pr['epochs'][1], pr['epochs'][2]
    bn1 = {k: v for k, v in e1['after'].items() if k != 'quant'}
    moved = sum(not torch.equal(bn1[k]['mean'], e1['before'][k]['mean']) for k in bn1)
    gate(same(e1['after']['quant'], e1['before']['quant']) and moved == len(bn1),
         f'across epoch 1 the observers are unchanged bit for bit, and {moved} of {len(bn1)} '
         'BN running means moved')
    gate(same(e2['after']['quant'], e2['before']['quant'])
         and same({k: v for k, v in e2['after'].items() if k != 'quant'},
                  {k: v for k, v in e2['before'].items() if k != 'quant'}),
         'across epoch 2 the observers and the BN running statistics are unchanged bit for bit')
    wdir = os.path.join(wdir_root, cfg.experiment_name)
    names = sorted(os.listdir(wdir))
    want = sorted(f'model-{e}-{pr["evals"][e]["AP"]:.4f}.ckpt' for e in range(QAT_EPOCHS))
    last = os.path.join(wdir, want[-1])
    gate(names == want and load_checkpoint(last)['type'] == 'qat',
         f'qat checkpoints {names} (want {want})')

    # the trainer's int8 eval (the kernels) against the plain versions on the
    # same qparams
    net = trainer.network
    qparams = convert_to_int8(net, trainer.params, trainer.state)
    zps = Counter(int(zp) for _, zp in qparams['act'].values())
    print(f'phase 12: zero points of the {len(qparams["act"])} edges after training: '
          f'{dict(sorted(zps.items()))}')
    # the card's conversion against the CPU's: the BN fold (its root in f64,
    # layers.fold_bn_into_conv), the weights' int8 codes and scales and the
    # edges' scales and zero points (both divide with ieee_div)
    cpu = torch.device('cpu')
    host_p, host_s = to_device(trainer.params, cpu), to_device(trainer.state, cpu)
    host_fused, host_q = fuse_params(net, host_p, host_s), convert_to_int8(net, host_p, host_s)
    card_fused = fuse_params(net, trainer.params, trainer.state)
    fold_apart = {f: sum(int((card_fused[k][f].cpu() != host_fused[k][f]).sum())
                         for k in host_fused if f in host_fused[k]) for f in ('w', 'b')}
    q_apart = {f: sum(int((qparams['layers'][k][f].cpu() != host_q['layers'][k][f]).sum())
                      for k in host_q['layers'] if f in host_q['layers'][k])
               for f in ('wq', 'w_scale', 'b')}
    print('phase 12: torch\'s f32 ops of the BN fold on the card and the CPU from the CPU\'s '
          'inputs (elements, apart, of those the card\'s correctly rounded, the CPU\'s): '
          f'{fold_stages_apart(net, host_p, host_s, dev)}')
    gate(host_q['act'] == qparams['act'] and not any(q_apart.values())
         and not any(fold_apart.values()),
         f'convert_to_int8 on the card equals the CPU\'s bit for bit: elements apart in the BN '
         f'fold {fold_apart}, in the qparams {q_apart}, and the edges\' scales and zero points '
         'equal')
    plain_inf = Int8Inference(net, mode='kernel')
    plain_predict = make_batch_predict(build_predict_pipeline(
        net, cfg, device=dev, apply_fn=lambda p, x: plain_inf.apply(p, x, plain=True)),
        Int8Inference.prepare(qparams, mode='kernel'))
    kernel_predict = trainer.make_predict_fn()
    n_same, n_img, n_det, n_found, launches = eval_agreement(
        kernel_predict, plain_predict, trainer.eval_data, cfg)
    share = n_found / max(n_det, 1)
    n_eval = len(trainer.eval_data)
    print(f'phase 12: {tag} the trainer\'s int8 eval (kernels) against the plain versions on '
          f'its qparams: {n_found}/{n_det} plain detections found (share {share:.6f}), '
          f'{n_same}/{n_img} images with the same detections in the same order, to '
          f'{EVAL_AGREEMENT_ATOL}; launches {launches}')
    gate(n_det > 0 and share >= INT8_EVAL_AGREEMENT and n_same >= INT8_EVAL_SAME_IMAGES
         and launches['kernel'] == {**dict.fromkeys(launches['kernel'], 0),
                                    **{k: n * n_eval for k, n in INT8_FORWARD_LAUNCHES.items()}}
         and not any(launches['plain'].values()),
         f'the int8 eval gives {n_same} >= {INT8_EVAL_SAME_IMAGES} images and {share:.6f} >= '
         f'{INT8_EVAL_AGREEMENT} of the plain versions\' detections')

    # the user's arc: convert quantize, then bench eval, as subprocesses
    int8_path = os.path.join(tmp, 'shapes_qat_int8.ckpt')
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, '-m', 'pqdet_tpu_torch.cli.convert', 'quantize',
                          '--weight', last, '--out', int8_path],
                         cwd=here, capture_output=True, text=True, timeout=300)
    convert_s = time.perf_counter() - t0
    print(f'phase 12: {tag} convert quantize CLI: exit {res.returncode}, {convert_s:.2f} s; '
          f'{res.stdout.strip().splitlines()[-1:]}')
    if res.returncode != 0:
        print(res.stderr[-3000:])
    ok = res.returncode == 0
    if ok:
        _, loaded = load_quantized(int8_path, device=dev)
        ok = loaded['act'] == qparams['act'] and sorted(loaded['layers']) == sorted(
            qparams['layers']) and all(
            torch.equal(v, loaded['layers'][k][kk]) for k, p in qparams['layers'].items()
            for kk, v in p.items())
    gate(ok, 'convert quantize on the last qat checkpoint gives the qparams the trainer '
         'converted in memory, bit for bit')
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, '-m', 'pqdet_tpu_torch.cli.bench', 'eval',
                          '--weight', int8_path, '--yaml', yaml_path, *data],
                         cwd=here, capture_output=True, text=True, timeout=300)
    bench_s = time.perf_counter() - t0
    found = re.findall(r'^AP (\S+)$', res.stdout, re.M)
    bench_ap = float(found[-1]) if found else float('nan')
    print(f'phase 12: {tag} bench eval CLI on the quant checkpoint: exit {res.returncode}, '
          f'{bench_s:.2f} s, AP {bench_ap!r} (the trainer\'s last int8 AP '
          f'{trainer.AP.AP!r})')
    if res.returncode != 0:
        print(res.stderr[-3000:])
    gate(res.returncode == 0 and 'mAPs' in res.stdout and bench_ap == trainer.AP.AP,
         'bench eval on the quant checkpoint prints the trainer\'s last int8 AP exactly')

    # timed before the parity, whose CPU walks would share the host's cores
    fails += phase12_timings(net, trainer.params, trainer.state, phase_gen(12), dev, cfg, tag,
                             fp)
    reset_kernel_launches()
    fails += phase12_parity(net, trainer.params, trainer.state, phase_gen(12), dev, cfg)
    gate(not any(kernel_launches().values()), 'kernel launches in the QAT walks on the card: 0')
    print(f'phase 12: {tag} phase seconds {time.perf_counter() - t_phase:.1f}')
    if fails:
        raise AssertionError(f'phase 12 gates failed: {fails}')


# device augmentation and the device corpus (phase 13)
AUG_BATCH = 16                 # (a): the chain on the card against the CPU, B and size
AUG_SIZE = 512
AUG_MAX_GT = 64                # model.max_gt_boxes of the shipped yamls
AUG_PARAMS = dict(hflip_p=0.5, vflip_p=0.5, crop_p=0.75, color_p=0.5, mosaic_p=0.5,
                  mixup_p=0.5)   # every stage on
AUG_WARP_SHARE = 1e-3          # share of pixels allowed one level apart with the warp
AUG_BOX_ATOL = 1e-4
DEVICE_EPOCHS = 3              # (b), (c): epochs of each shipped-yaml run
# (c): a synth_clutter corpus of CLUTTER_IMAGES at 512 px (holdout 0.12: 281
# train, 18 steps an epoch at B=16): written in ~15 s, where the yaml's 8k
# images would take minutes; enough for 3x the steps of phase 11's epochs
CLUTTER_IMAGES = 320
AUG_TIMING_BATCH = 12          # (e): the step at phase 10's B and size
AUG_TIMED_STEPS = 20
AUG_TIMING_CHAINS = {
    'no device augment': None,
    'shapes.yaml chain (hflip 0.5, crop 0.75, in-batch)':
        (dict(hflip_p=0.5, vflip_p=0.0, crop_p=0.75, color_p=0.0, mosaic_p=0.0,
              mixup_p=0.0), 0),
    'clutter.yaml chain (hflip 0.5, crop 0.75, mosaic 0.5, mixup 0.5, 4 fresh partners)':
        (dict(hflip_p=0.5, vflip_p=0.0, crop_p=0.75, color_p=0.0, mosaic_p=0.5,
              mixup_p=0.5), 4),
}


def phase13_chain_parity(dev, tag, gen):
    """Phase 13 (a): ``device_augment`` on the card against the port's CPU
    run on the same inputs and draws, B=16 at 512x512 with every stage on,
    in-batch and with 4B fresh partner rows; each also with crop_p 0 (no
    warp), which must be bit for bit. Each card run is under
    ``torch.cuda.set_sync_debug_mode('error')`` (the draws' upload
    included), with TF32 allowed for matmuls and not: the warp pins its
    products to full f32 itself. Returns the failed gates."""
    import numpy as np
    import torch
    from pqdet_tpu_torch.ops.augment_device import AugmentParams, device_augment, draw_augment
    B, S = AUG_BATCH, AUG_SIZE
    fails = []
    host = train_batch(gen, B, S, 'cpu', AUG_MAX_GT)
    partners = train_batch(gen, 4 * B, S, 'cpu', AUG_MAX_GT)
    host['gt'][..., 5] = (host['gt'][..., 2] > host['gt'][..., 0]).float()
    partners['gt'][..., 5] = (partners['gt'][..., 2] > partners['gt'][..., 0]).float()
    on_card = {k: v.to(dev) for k, v in host.items()}
    p_card = {k: v.to(dev) for k, v in partners.items()}
    for mode, rows in (('in-batch', 0), ('fresh', 4)):
        for crop in (AUG_PARAMS['crop_p'], 0.0):
            params = AugmentParams(**{**AUG_PARAMS, 'crop_p': crop})
            draws = draw_augment(np.random.default_rng((SEED, 13, rows, int(crop * 100))),
                                 B, S, partner_rows=rows)
            pin, pgt = (partners['image'], partners['gt']) if rows else (None, None)
            t0 = time.perf_counter()
            ref_img, ref_gt = device_augment(host['image'], host['gt'], draws, params, pin, pgt)
            cpu_s = time.perf_counter() - t0
            applied = {n: int((getattr(draws, n) < getattr(params, f'{n}_p')).sum())
                       for n in ('hflip', 'vflip', 'crop', 'color', 'mosaic', 'mixup')}
            for tf32 in (True, False):
                pin_d, pgt_d = (p_card['image'], p_card['gt']) if rows else (None, None)
                torch.cuda.synchronize()
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.cuda.set_sync_debug_mode('error')
                try:
                    img, gt = device_augment(on_card['image'], on_card['gt'], draws.to(dev),
                                             params, pin_d, pgt_d)
                finally:
                    torch.cuda.set_sync_debug_mode('default')
                    torch.backends.cuda.matmul.allow_tf32 = False
                d = (img.cpu().int() - ref_img.int()).abs()
                share = float((d > 0).float().mean())
                box_err = float((gt.cpu() - ref_gt).abs().max())
                if crop:
                    ok = int(d.max()) <= 1 and share <= AUG_WARP_SHARE
                    want = f'within 1 level on <= {AUG_WARP_SHARE} of the pixels'
                else:
                    ok = not d.any()
                    want = 'bit for bit'
                ok = ok and gt.shape == ref_gt.shape and box_err <= AUG_BOX_ATOL
                what = (f'chain {mode} B={B} {S}x{S} crop_p {crop} (TF32 for matmuls '
                        f'{"allowed" if tf32 else "off"}), no device-to-host sync: images '
                        f'{share:.3g} of the pixels apart, max |d| {int(d.max())} ({want}); '
                        f'boxes {tuple(gt.shape)} max |d| {box_err:.3g} (<= {AUG_BOX_ATOL})')
                print(f'phase 13: {tag} {what}: {"ok" if ok else "FAIL"}')
                if not ok:
                    fails.append(what)
            print(f'phase 13: {tag} chain {mode} crop_p {crop}: samples each stage took '
                  f'{applied} (base chain over {B * (1 + rows)} rows); the CPU run '
                  f'{cpu_s:.2f} s')
    return fails


def probed_trainer(Trainer, record):
    """``Trainer`` with probes into ``record``: the trainer, per-epoch step
    losses, seconds, data-load split and kernel launches, per-eval seconds,
    AP and launches, the first two gathers from the device corpus, the
    params before training, the process pool's worker pids and slab names
    (``pool``), and, where ``record`` holds a ``sums`` list, each step
    batch's checksums (the sum of each of its tensors, read on the step's
    stream)."""
    import torch
    from pqdet_tpu_torch.train.step import tree_leaves

    class Probed(Trainer):
        def init_all(self):
            record.update(trainer=self, loss={}, epochs={}, evals={}, gathers=[])
            self._epoch = -1
            super().init_all()
            record['start'] = [t.detach().clone() for t in tree_leaves(self.params)]
            loader = self._proc_loader
            record['pool'] = None if loader is None else (
                [w.pid for w in loader._pool._pool], loader.slab_names)

        def _make_step(self):
            step, opt = super()._make_step()

            def probed(params, state, opt_state, batch, rng=None):
                if 'sums' in record:
                    record['sums'].append(torch.stack([
                        t.double().sum() for k in sorted(batch) if k != 'draws'
                        for t in (batch[k] if isinstance(batch[k], tuple) else (batch[k],))]))
                out = step(params, state, opt_state, batch, rng)
                record['loss'].setdefault(self._epoch, []).append(out[3]['loss'])
                return out
            return probed, opt

        def _cache_gather(self, size, idx):
            if len(record['gathers']) < 2:
                record['gathers'].append((size, idx.tolist()))
            return super()._cache_gather(size, idx)

        def train_epoch(self, epoch):
            self._epoch = epoch
            reset_kernel_launches()
            t0 = time.perf_counter()
            split = super().train_epoch(epoch)
            record['epochs'][epoch] = {'s': time.perf_counter() - t0,
                                       'launches': kernel_launches(),
                                       'steps': self.steps_per_epoch, **split}
            record['loss'][epoch] = [float(x) for x in record['loss'][epoch]]
            return split

        def evaluate(self):
            reset_kernel_launches()
            t0 = time.perf_counter()
            ap = super().evaluate()
            record['evals'][self._epoch] = {'s': time.perf_counter() - t0, 'AP': ap.AP,
                                            'launches': kernel_launches(),
                                            'batches': len(self.eval_data)}
            return ap
    return Probed


def run_train_cli(argv, record):
    """``python -m pqdet_tpu_torch.cli.train`` in this process, its Trainer
    probed into ``record``; returns the wall seconds."""
    import torch
    import pqdet_tpu_torch.cli.train as cli_train
    import pqdet_tpu_torch.train.trainer as trainer_mod
    saved = trainer_mod.Trainer
    trainer_mod.Trainer = probed_trainer(saved, record)
    t0 = time.perf_counter()
    try:
        cli_train.main(argv)
    finally:
        trainer_mod.Trainer = saved
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def trainer_gates(record, label, tag, gate, host_ips, evals, phase='phase 13',
                  per_forward=None):
    """Print a probed run's epochs and evals; gate finite losses, moved
    params, 0 kernel launches in the steps and, per eval batch, the launches
    of ``per_forward`` (one decode and no other kernel by default).
    Returns the images/s of the epochs after the first."""
    import torch
    from pqdet_tpu_torch.train.step import tree_leaves
    trainer = record['trainer']
    b = trainer.config.train.batch_size
    for e, ep in sorted(record['epochs'].items()):
        print(f'{phase}: {tag} {label} epoch {e}: {ep["s"]:.3f} s, {ep["steps"]} steps, data '
              f'load {ep["data_load_s"]:.3f} s, model {ep["model_s"]:.3f} s, '
              f'{ep["steps"] * b / ep["s"]:.2f} images/s; losses '
              f'{[round(x, 3) for x in record["loss"][e]]}; kernel launches {ep["launches"]}')
    for e, ev in sorted(record['evals'].items()):
        print(f'{phase}: {tag} {label} eval after epoch {e}: {ev["s"]:.3f} s, {ev["batches"]} '
              f'batches, AP {ev["AP"]:.6f}, kernel launches {ev["launches"]}')
    steady = [ep['steps'] * b / ep['s'] for e, ep in record['epochs'].items()
              if e > min(record['epochs'])]
    if steady:
        print(f'{phase}: {tag} {label} images/s of the epochs after the first '
              f'{statistics.mean(steady):.2f}; phase 11\'s host-augment epochs 1-2 (same card, '
              f'this run) {host_ips:.2f}')
    losses = [x for e in record['loss'] for x in record['loss'][e]]
    gate(losses and all(math.isfinite(x) for x in losses),
         f'{label}: all {len(losses)} step losses finite')
    moved = sum(not torch.equal(a, c) for a, c in zip(record['start'],
                                                      tree_leaves(trainer.params)))
    n = len(record['start'])
    gate(moved >= 0.9 * n, f'{label}: {moved} of {n} param leaves moved')
    gate(all(not any(ep['launches'].values()) for ep in record['epochs'].values()),
         f'{label}: hand-written kernel launches in the steps: 0')
    per_forward = per_forward or {'decode_heads': 1}
    gate(sorted(record['evals']) == evals and all(
        ev['launches'] == {**dict.fromkeys(ev['launches'], 0),
                           **{k: n * ev['batches'] for k, n in per_forward.items()}}
        for ev in record['evals'].values()),
         f'{label}: evals after epochs {sorted(record["evals"])} (want {evals}), per eval '
         f'batch {per_forward} and no other kernel')
    return statistics.mean(steady) if steady else float('nan')


def phase13_step_timings(dev, tag, gen):
    """Phase 13 (e): the bf16 train step of full-width mobilenetv2-fpn at
    B=12, 512x512 without device augment and with the shapes.yaml and
    clutter.yaml chains, each step making and uploading its draws as the
    trainer does: ms p50/p90 over AUG_TIMED_STEPS steps after TRAIN_WARMUP
    (CUDA events, synchronised each step; the variants take their steps in
    turns, so a drift of the host's pace falls on each alike), a profiled
    step of each; the chain alone (ms a call, a profiled call: device busy,
    launches) and the host's ms to draw and upload one step's draws."""
    import numpy as np
    import torch
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.augment_device import augmenter_from_config, draw_augment
    from pqdet_tpu_torch.train.step import train_step_from_config
    from pqdet_tpu_torch.zoo import get_cfg
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'))
    params, state = net.init(gen, device=dev)
    seed_bn(params, state, gen, dev)
    B, S = AUG_TIMING_BATCH, TRAIN_SIZE
    base = train_batch(gen, B, S, dev, AUG_MAX_GT)
    partners = train_batch(gen, 4 * B, S, dev, AUG_MAX_GT)

    def batch_of(chain, i):
        b = dict(base)
        if chain is not None:
            rows = chain[1]
            if rows:
                b.update(partner_image=partners['image'], partner_gt=partners['gt'])
            b['draws'] = draw_augment(np.random.default_rng((SEED, 13, i)), B, S,
                                      partner_rows=rows).to(dev)
        return b

    variants = []
    for label, chain in AUG_TIMING_CHAINS.items():
        cfg = train_config()
        cfg.augment.device = chain is not None
        for k, v in (chain[0] if chain else {}).items():
            setattr(cfg.augment, k, v)
        step, opt = train_step_from_config(net, cfg, TRAIN_WARMUP, device=dev)
        variants.append((label, chain, cfg, step, opt.init(params)))
    ms = {v[0]: [] for v in variants}
    for i in range(TRAIN_WARMUP + AUG_TIMED_STEPS):
        for label, chain, _, step, o in variants:
            s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_ev.record()
            step(params, state, o, batch_of(chain, i))
            e_ev.record()
            e_ev.synchronize()
            if i >= TRAIN_WARMUP:
                ms[label].append(s_ev.elapsed_time(e_ev))
    out = {}
    for label, chain, cfg, step, o in variants:
        t = sorted(ms[label])
        p50, p90 = statistics.median(t), t[int(0.9 * (len(t) - 1))]
        out[label] = p50
        print(f'phase 13: {tag} train step B={B} {S}x{S} bf16, {label}: p50 {p50:.3f} ms, p90 '
              f'{p90:.3f} ms, {B * 1000.0 / p50:.2f} images/s ({AUG_TIMED_STEPS} steps after '
              f'{TRAIN_WARMUP}, the variants in turns)')
        profile_calls(lambda: step(params, state, o, batch_of(chain, 0)), tag, 'phase 13',
                      f'step B={B} ({label})')
        if chain is None:
            continue
        fn = augmenter_from_config(cfg)
        d = batch_of(chain, 0)
        args = (d['image'], d['gt'], d['draws'], d.get('partner_image'), d.get('partner_gt'))
        print(f'phase 13: {tag} the chain alone, {label}: {cuda_ms(lambda: fn(*args)):.3f} ms '
              'a call with its launches')
        profile_calls(lambda: fn(*args), tag, 'phase 13', f'chain B={B} ({label})')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(20):
            batch_of(chain, i)
        torch.cuda.synchronize()
        print(f'phase 13: {tag} draws of one step, {label}: '
              f'{(time.perf_counter() - t0) * 1e3 / 20:.3f} ms of host time to draw and upload')
    return out


def phase13_device_augment(dev, tag, tmp, corpus):
    """Phase 13: device augmentation and the device corpus on the card.
    (a) the chain against the CPU (``phase13_chain_parity``); (b) ``cli.train``
    on yamls/shapes.yaml as shipped (``augment.device on``; only the data
    and weight paths, the epoch count and eval.after overridden) for
    DEVICE_EPOCHS epochs on phase 11's corpus; (c) ``cli.train`` on
    yamls/clutter.yaml as shipped (the device corpus, fresh partners,
    mosaic and mixup 0.5) on a synth_clutter corpus of CLUTTER_IMAGES; (d)
    one QAT epoch of yamls/shapes_quant.yaml with ``augment.device on``
    from (b)'s last checkpoint; phase 11's timed run with the device chain,
    from the host loader and from the device corpus; (e) the step's cost
    (``phase13_step_timings``). ``corpus``: phase 11's return value, in
    ``tmp``. Raises on any failed gate."""
    import numpy as np
    from pqdet_tpu_torch.data.scripts.synth_clutter import generate
    from pqdet_tpu_torch.utils.codec import load_checkpoint

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    fails = phase13_chain_parity(dev, tag, phase_gen(13))

    def gate(ok, what):
        print(f'phase 13: {what}: {"ok" if ok else "FAIL"}')
        if not ok:
            fails.append(what)

    host = corpus['host_epochs']
    host_ips = statistics.mean(ep['steps'] * corpus['batch'] / ep['s']
                               for e, ep in host.items() if e > 0)
    wroot = os.path.join(tmp, 'weights_device')

    # (b) yamls/shapes.yaml as shipped
    root = corpus['root']
    shapes = {}
    wall = run_train_cli(['--yaml', os.path.join(here, 'yamls', 'shapes.yaml'),
                          'dataset.train_txt_file', os.path.join(root, 'train.txt'),
                          'dataset.eval_txt_file', os.path.join(root, 'test.txt'),
                          'weight.dir', wroot, 'train.max_epochs', str(DEVICE_EPOCHS),
                          'eval.after', '1'], shapes)
    cfg = shapes['trainer'].config
    print(f'phase 13: {tag} (b) cli.train yamls/shapes.yaml: {wall:.2f} s; augment.device '
          f'{cfg.augment.device}, batch {cfg.train.batch_size}, sizes {cfg.train.input_sizes}, '
          f'hflip {cfg.augment.hflip_p}, crop {cfg.augment.crop_p}, mixup '
          f'{cfg.augment.mixup_p}, mosaic {cfg.augment.mosaic_p}, device_cache '
          f'{cfg.dataset.device_cache}')
    gate(cfg.augment.device and not cfg.dataset.device_cache,
         '(b) shapes.yaml trains with augment.device on')
    trainer_gates(shapes, '(b) shapes.yaml', tag, gate, host_ips, [1, 2])
    sdir = os.path.join(wroot, cfg.experiment_name)
    shapes_ckpt = os.path.join(sdir, sorted(os.listdir(sdir))[-1])

    # (c) yamls/clutter.yaml as shipped, on a synth_clutter corpus
    croot = os.path.join(tmp, 'clutter')
    t0 = time.perf_counter()
    generate(croot, n=CLUTTER_IMAGES, size=AUG_SIZE, seed=SEED)
    print(f'phase 13: (c) wrote {CLUTTER_IMAGES} synth_clutter images at {AUG_SIZE} in '
          f'{time.perf_counter() - t0:.2f} s')
    clutter = {}
    wall = run_train_cli(['--yaml', os.path.join(here, 'yamls', 'clutter.yaml'),
                          'dataset.train_txt_file', os.path.join(croot, 'train.txt'),
                          'dataset.eval_txt_file', os.path.join(croot, 'test.txt'),
                          'weight.dir', wroot, 'train.max_epochs', str(DEVICE_EPOCHS),
                          'eval.after', '1'], clutter)
    trainer = clutter['trainer']
    cfg = trainer.config
    info = trainer.cache_info
    n_train = trainer.train_data.length
    print(f'phase 13: {tag} (c) cli.train yamls/clutter.yaml: {wall:.2f} s; augment.device '
          f'{cfg.augment.device}, device_cache {cfg.dataset.device_cache}, fresh_partners '
          f'{cfg.augment.fresh_partners} ({trainer._partner_rows} partner rows a sample), '
          f'mosaic {cfg.augment.mosaic_p}, mixup {cfg.augment.mixup_p}, batch '
          f'{cfg.train.batch_size}, sizes {cfg.train.input_sizes}; the device corpus: '
          f'{info["images"]} images, {info["gib"]:.4f} GiB, built in {info["s"]:.2f} s')
    gate(cfg.augment.device and cfg.dataset.device_cache and trainer._partner_rows == 4
         and info['images'] == n_train,
         '(c) clutter.yaml trains from the device corpus with 4 fresh partner rows a sample')
    (s0, rows0), (s1, prow) = clutter['gathers']
    want = np.random.RandomState(cfg.system.seed + 7).randint(
        0, n_train, size=4 * cfg.train.batch_size).tolist()
    print(f'phase 13: {tag} (c) first batch rows {rows0} at {s0}; partner rows {prow[:16]}... '
          f'(JAX\'s RandomState({cfg.system.seed} + 7) draw {want[:16]}...)')
    gate(prow == want and s1 == s0, '(c) the first batch\'s partner rows are JAX\'s '
         f'RandomState(system.seed + 7).randint(0, {n_train}, {len(want)})')
    trainer_gates(clutter, '(c) clutter.yaml', tag, gate, host_ips, [1, 2])

    # (d) one QAT epoch with the device chain, from (b)'s last checkpoint
    qat = {}
    wall = run_train_cli(['--yaml', os.path.join(here, 'yamls', 'shapes_quant.yaml'),
                          'dataset.train_txt_file', os.path.join(root, 'train.txt'),
                          'dataset.eval_txt_file', os.path.join(root, 'test.txt'),
                          'weight.dir', wroot, 'weight.resume', shapes_ckpt,
                          'augment.device', 'on', 'train.max_epochs', '1'], qat)
    trainer = qat['trainer']
    print(f'phase 13: {tag} (d) cli.train yamls/shapes_quant.yaml (augment.device on) from '
          f'{os.path.basename(shapes_ckpt)}: {wall:.2f} s')
    gate(trainer._quant and trainer.config.augment.device, '(d) the QAT step augments on the '
         'device')
    trainer_gates(qat, '(d) QAT', tag, gate, host_ips, [])
    qdir = os.path.join(wroot, trainer.config.experiment_name)
    ck = load_checkpoint(os.path.join(qdir, 'model-0.ckpt'))
    gate(ck['type'] == 'qat' and ck['step'] == trainer.global_step,
         f'(d) a qat checkpoint at step {ck["step"]}')

    # the timed runs of phase 11 (its 300-image corpus, B=12 at 512x512,
    # 25-step epochs) with the device chain: from the loader, which now only
    # letterboxes, and from the device corpus, which needs no loader
    timed, bare_ips = corpus['timed'], corpus['bare_ips']
    for i, (label, extra) in enumerate((('device chain, host loader', []),
                                        ('device chain, device corpus',
                                         ['dataset.device_cache', 'on']))):
        rec = {}
        run_train_cli(['--yaml', os.path.join(here, 'yamls', 'shapes.yaml'),
                       'dataset.train_txt_file', timed['train'],
                       'dataset.eval_txt_file', os.path.join(root, 'test.txt'),
                       'weight.dir', wroot, 'system.num_workers', corpus['workers'],
                       'train.batch_size', str(TIMING_BATCH), 'train.input_sizes',
                       f'[{CORPUS_SIZE}]', 'train.max_epochs', '2', 'eval.after', '2',
                       'experiment_name', f'shapes_timing_device_{i}', *extra], rec)
        ep = rec['epochs'][1]
        ips = ep['steps'] * TIMING_BATCH / ep['s']
        print(f'phase 13: {tag} timed run, {label} (B={TIMING_BATCH}, {CORPUS_SIZE}x'
              f'{CORPUS_SIZE}, {ep["steps"]} steps an epoch): epoch 0 '
              f'{rec["epochs"][0]["s"]:.3f} s; epoch 1 {ep["s"]:.3f} s, data load '
              f'{ep["data_load_s"]:.3f} s (share {ep["data_load_s"] / ep["s"]:.4f}), model '
              f'{ep["model_s"]:.3f} s, {ips:.2f} images/s: {ips / bare_ips:.4f} of the bare '
              f'step\'s {bare_ips:.2f} (phase 11\'s host chain {timed["ips"]:.2f}, '
              f'{timed["ips"] / bare_ips:.4f})')
        losses = [x for e in rec['loss'] for x in rec['loss'][e]]
        gate(all(math.isfinite(x) for x in losses)
             and not any(ep['launches'].values()),
             f'the timed run, {label}: {len(losses)} finite step losses, 0 kernel launches')

    # (e) the step's cost
    phase13_step_timings(dev, tag, phase_gen(13))
    print(f'phase 13: {tag} phase seconds {time.perf_counter() - t_phase:.1f}')
    if fails:
        raise AssertionError(f'phase 13 gates failed: {fails}')


# the slimming-prune arc (phase 14): phase 11's last checkpoint pruned and
# its kernels held at the pruned widths (a); a model whose pruned channels
# are dead served before and after pruning (b); sparse -> prune + fine-tune
# -> QAT on the pruned cfg -> convert -> bench through the port's CLIs on
# phase 11's corpus (c); pruned against unpruned timings (d)
PRUNE_RATIO = 0.3              # (a) and the arc: tools/run_ladder.py's ratio
PRESERVE_RATIO = 0.1           # (b): the threshold falls inside the dead channels
PRESERVE_DEAD = 3              # (b): one in this many channels of a prunable layer dies
PRESERVE_SCORE_TOL = 0.03      # (b): phase 4's bf16 bounds, scores ...
PRESERVE_BOX_TOL = 3.0         # ... and boxes in px (the layer walk's: two bare pairs
#                                no longer fuse, so they run as cuDNN convs)
PRUNE_SPARSE_EPOCHS = 1        # (c): sparse.ratio 0.005, as tools/run_ladder.py
PRUNE_FT_EPOCHS = 2            # (c): prune.finetune_epochs
PRUNE_QAT_EPOCHS = 2           # (c): observers until epoch 1, BN frozen from epoch 1
PRUNE_SIZE = 512               # (c): train.input_sizes and eval.input_size of the arc
PRUNE_TIMED_REQUESTS = 60      # (d): requests of each model, taken in turns


def kill_channels(graph, params, state, gen):
    """Make one in PRESERVE_DEAD channels of every conv that
    ``prune_slimming`` may thin (BN, not grouped, not a shortcut member)
    dead: gamma = beta = 0, so BN gives 0 and relu keeps it 0; a depthwise
    conv reading dead channels gets running mean and beta 0 there, so it
    gives 0 on them too. Returns the number of dead channels."""
    import torch
    keep_out = {r for n in graph.nodes if n.kind == 'shortcut' for r in (n.refs[0], n.index - 1)}
    dead, n_dead = {}, 0
    for n in graph.nodes:
        k = str(n.index)
        if n.kind == 'convolutional' and n.attrs['groups'] > 1:
            m = dead.get(n.index - 1)
            if m is not None and bool(m.any()):
                md = m.to(params[k]['w'].device)
                state[k]['mean'][md] = 0.0
                params[k]['bn']['beta'][md] = 0.0
            dead[n.index] = m
        elif n.kind == 'convolutional' and n.has_bn and n.index not in keep_out:
            c = n.attrs['filters']
            m = torch.zeros(c, dtype=torch.bool)
            m[torch.randperm(c, generator=gen)[:c // PRESERVE_DEAD]] = True
            md = m.to(params[k]['w'].device)
            params[k]['bn']['gamma'][md] = 0.0
            params[k]['bn']['beta'][md] = 0.0
            dead[n.index] = m
            n_dead += int(m.sum())
        elif n.kind == 'route':
            dead[n.index] = torch.cat([
                dead[r] if dead.get(r) is not None else
                torch.zeros(graph.nodes[r].out_channels, dtype=torch.bool) for r in n.refs])
        elif n.kind in ('upsample', 'maxpool'):
            dead[n.index] = dead.get(n.index - 1)
    return n_dead


def bf16_server(net, params, state, dev, densify_groups=True, size=None):
    """(predict, forward, fused-IR table, bf16 params) of ``net`` served in
    bf16 through the fused-IR and decode kernels, BN folded (grouped convs
    densified unless ``densify_groups`` is False), at ``size`` (SIZE)."""
    import torch
    from pqdet_tpu_torch.config import Config
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    from pqdet_tpu_torch.model.factory import inference_params
    from pqdet_tpu_torch.model.network import cast_params
    from pqdet_tpu_torch.ops.fused_ir import prepare_fused_ir
    cfg = Config()
    cfg.eval.input_size = size or SIZE
    fused = inference_params(net, params, state, densify_groups=densify_groups)
    table = prepare_fused_ir(net, fused)
    fparams = cast_params(fused, torch.bfloat16)
    run = build_predict_pipeline(net, cfg, compute_dtype=torch.bfloat16, fused_ir=table,
                                 device=dev)

    def forward(x):
        with torch.inference_mode():
            return net(fparams, {}, x, compute_dtype=torch.bfloat16, fused_ir=table)
    return make_batch_predict(run, fparams), forward, table, fparams


def int8_server(cfg_text, params, state, batch, dev):
    """(predict, forward, executor, staged qparams, qparams) of the quant
    graph of ``cfg_text`` with the fp ``params``/``state``, calibrated by
    ``calibrate_int8`` and served by ``Int8Inference`` in kernel mode at
    SIZE (grouped convs densified: ``prepare(network=)``)."""
    import torch
    from pqdet_tpu_torch.compress.quantized import Int8Inference
    from pqdet_tpu_torch.config import Config
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    from pqdet_tpu_torch.model.network import DetectionNetwork
    cfg = Config()
    cfg.eval.input_size = SIZE
    qnet = DetectionNetwork.from_cfg(cfg_text, quant=True)
    _, _, qparams = calibrate_int8(qnet, params, state, batch)
    inf = Int8Inference(qnet, mode='kernel')
    prep = Int8Inference.prepare(qparams, mode='kernel', network=qnet)
    run = build_predict_pipeline(qnet, cfg, apply_fn=inf.apply, device=dev)

    def forward(x):
        with torch.inference_mode():
            return inf.apply(prep, x)
    return make_batch_predict(run, prep), forward, inf, prep, qparams


class Tee:
    """stdout that also keeps what is written (a CLI's output, read by the
    gates)."""

    def __init__(self):
        self.parts, self.out = [], sys.stdout

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return ''.join(self.parts)


def run_cli(main, argv):
    """A CLI's ``main(argv)`` in this process: (its return value, its
    stdout, wall seconds, the kernel launches it made)."""
    import torch
    tee = Tee()
    reset_kernel_launches()
    saved, sys.stdout = sys.stdout, tee
    t0 = time.perf_counter()
    try:
        ret = main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdout = saved
    return ret, tee.text(), time.perf_counter() - t0, kernel_launches()


def newest_ckpt(wdir):
    """tools/run_ladder.py's discovery in ``wdir``: the checkpoint of the
    newest epoch, never the raw ``-pruned.ckpt`` cli.prune writes beside its
    input."""
    import glob
    paths = [p for p in glob.glob(os.path.join(wdir, '*.ckpt'))
             if not os.path.basename(p).endswith('-pruned.ckpt')]

    def key(p):
        parts = os.path.basename(p).rsplit('.', 1)[0].split('-')
        return int(parts[len(parts) - parts[::-1].index('model')])
    return max(paths, key=key)


def phase14_kernels_pruned(dev, tag, corpus):
    """(a): phase 11's last checkpoint pruned at PRUNE_RATIO; each fused
    chain and each int8 conv shape of the pruned graph at B=BATCH, SIZE,
    against the plain versions (phase 3's tolerance; the int8 kernels bit
    for bit). Returns the unpruned and pruned models and the errors."""
    from pqdet_tpu_torch.compress.prune import prune_slimming
    from pqdet_tpu_torch.model.factory import build_detector
    from pqdet_tpu_torch.model.network import DetectionNetwork
    net, params, state, info = build_detector(None, weight_path=corpus['ckpt'], device=dev)
    res = prune_slimming(net.graph, params, state, PRUNE_RATIO)
    pnet = DetectionNetwork.from_cfg(res.cfg_text)
    chains = chain_shapes(pnet, SIZE)
    qshapes = int8_conv_shapes(DetectionNetwork.from_cfg(res.cfg_text, quant=True), SIZE)
    es = [e for *_, e, _, _ in chains]
    odd = sorted({(k[3], k[4]) for k in qshapes if k[3] % 16 == 8 or k[4] % 16 == 8})
    print(f'phase 14 (a): {os.path.basename(corpus["ckpt"])} pruned at {PRUNE_RATIO}: '
          f'{res.report[0]}; {len(chains)} fused chains (the unpruned graph has '
          f'{len(chain_shapes(net, SIZE))}), E {es}, {sum(e % 16 == 8 for e in es)} of them '
          f'8 mod 16; int8 graph {sum(c for k, c in qshapes.items() if k[0] != "dw")} '
          f'pointwise (stem included) and {sum(c for k, c in qshapes.items() if k[0] == "dw")} '
          f'depthwise convs in {len(qshapes)} shapes, (Cin, Cout) of 8 mod 16: {odd}')
    gen = phase_gen(14)
    checks = [(f'{a},{b},{c}', BATCH, h, h, cin, e, p, a is not None, acts, 0.0)
              for a, b, c, h, cin, e, p, acts in chains]
    fused_err = fused_parity(gen, dev, checks, 'phase 14 (a)')
    int8_err = phase6_int8_parity(gen, dev, qshapes, batches=(BATCH,), edges=False,
                                  label='phase 14 (a)')
    return {'net': net, 'params': params, 'state': state, 'cfg': info['cfg_text'],
            'pruned': res, 'pnet': pnet, 'chains': chains, 'qshapes': qshapes,
            'fused_err': fused_err, 'int8_err': int8_err}


def phase14_preserve(dev, tag, gate):
    """(b): seeded full-width mobilenetv2-fpn with dead channels
    (``kill_channels``) served at B=BATCH, SIZE in bf16 through the fused-IR
    and decode kernels, before and after ``prune_slimming`` at
    PRESERVE_RATIO: the preds within phase 4's bf16 bounds, each forward
    launching its graph's chains and one decode."""
    import torch
    from pqdet_tpu_torch.compress.prune import prune_slimming
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.zoo import get_cfg
    gen = phase_gen(140)
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'))
    params, state = net.init(gen, device=dev)
    seed_bn(params, state, gen, dev)
    n_dead = kill_channels(net.graph, params, state, gen)
    res = prune_slimming(net.graph, params, state, PRESERVE_RATIO)
    pnet = DetectionNetwork.from_cfg(res.cfg_text)
    n_all = sum(p['bn']['gamma'].numel() for p in params.values() if 'bn' in p)
    n_left = sum(p['bn']['gamma'].numel() for p in res.params.values() if 'bn' in p)
    x = device_normalize(request_maker(gen, dev)(BATCH)['image'])
    outs, launches = {}, {}
    for name, (n, p, s) in (('unpruned', (net, params, state)),
                            ('pruned', (pnet, res.params, res.state))):
        _, forward, table, _ = bf16_server(n, p, s, dev)
        forward(x)
        torch.cuda.synchronize()
        reset_kernel_launches()
        outs[name] = forward(x)
        torch.cuda.synchronize()
        launches[name] = (kernel_launches(), len(table))
    ds = (outs['pruned'][..., 4:] - outs['unpruned'][..., 4:]).abs().max().item()
    db = (outs['pruned'][..., :4] - outs['unpruned'][..., :4]).abs().max().item()
    print(f'phase 14 (b): {n_dead} of {n_all} BN channels dead; pruned at {PRESERVE_RATIO} '
          f'(threshold 0: {res.report[0]}) to {n_left} channels; launches per forward '
          f'{launches}; pruned against unpruned, both through the kernels in bf16 at B={BATCH}, '
          f'{SIZE}x{SIZE}: scores max |d| {ds:.4g} (<= {PRESERVE_SCORE_TOL}), boxes max |d| '
          f'{db:.4g} px (<= {PRESERVE_BOX_TOL})')
    gate(bool(torch.isfinite(outs['pruned']).all()) and n_left < n_all
         and outs['pruned'].shape == outs['unpruned'].shape
         and ds <= PRESERVE_SCORE_TOL and db <= PRESERVE_BOX_TOL,
         '(b) pruning dead channels keeps the served preds within the bf16 bounds')
    gate(all(ln == {**dict.fromkeys(ln, 0), 'fused_ir_conv': nt, 'decode_heads': 1}
             for ln, nt in launches.values()),
         '(b) each forward launches its graph\'s fused chains and one decode')


# the two int8 modes conv by conv: share of codes allowed 1 apart. Both
# read 2.2e-6 as they are (the card at full width, the CPU at width 0.25);
# an int8_conv scale off by 1e-5 reads 1.8e-4 (tests/test_torch_int8.py)
INT8_MODES_APART = 1e-5


def int8_modes_agree(worst, n_diff, n_all, bad_heads):
    """The gate on ``int8_modes_conv_parity``'s reading: codes equal or 1
    apart on under ``INT8_MODES_APART`` of them, f32 head outputs within
    1e-5 * max(1, |r|)."""
    return worst <= 1 and n_diff < INT8_MODES_APART * n_all and not bad_heads


def int8_modes_conv_parity(net, qparams, x):
    """Each conv of the int8 graph run by the exact integer mode
    (``int8_conv``, ``bench eval --int8-exact``) from the kernel mode's own
    input codes, against the kernel mode's output on ``x``: the two modes
    round their epilogues differently, so the whole walks part by a
    cascade of single codes, but conv by conv they agree (``int8_modes_agree``).
    Returns (convs, the largest code difference, codes apart, codes, head
    convs outside the f32 bound)."""
    import torch
    from pqdet_tpu_torch.compress.quantized import Int8Inference, _quant, int8_conv
    from pqdet_tpu_torch.model import layers as L
    from pqdet_tpu_torch.model.graph import solve_padding
    act = qparams['act']
    inf = Int8Inference(net, mode='kernel')
    n_conv, worst, n_diff, n_all, bad_heads = 0, 0, 0, 0, []
    with torch.inference_mode():
        _, inter = inf.apply(Int8Inference.prepare(qparams, network=net), x,
                             intermediates=True)

        def codes(view, sz):            # the exact inversion of a dequantised view
            return torch.round(view / sz[0] + sz[1]).to(torch.int32)
        for node in net.graph.nodes:
            if node.kind != 'convolutional':
                continue
            key, a, p = str(node.index), node.attrs, qparams['layers'][str(node.index)]
            src = 'input' if node.index == 0 else str(node.index - 1)
            x_sz = act[src]
            xq = _quant(x, x_sz) if node.index == 0 else \
                codes(inter[src], x_sz).clamp(0, 255).to(torch.uint8)
            y = L.apply_activation(a['activation'], int8_conv(
                xq, x_sz, p['wq'], p['w_scale'], p['b'], a['stride'],
                solve_padding(a['size'], a['padding'], a['pad']), a['groups']))
            n_conv += 1
            out_edge = act.get(key)
            if out_edge is None:
                ref = inter[key]
                if not bool(((y - ref).abs() <= 1e-5 * ref.abs().clamp_min(1.0)).all()):
                    bad_heads.append(key)
                continue
            d = (_quant(y, out_edge).to(torch.int32) - codes(inter[key], out_edge)).abs()
            worst = max(worst, int(d.max()))
            n_diff, n_all = n_diff + int((d > 0).sum()), n_all + d.numel()
    return n_conv, worst, n_diff, n_all, bad_heads


def phase14_arc(dev, tag, tmp, corpus, gate):
    """(c): sparse -> prune + fine-tune -> QAT on the pruned cfg -> convert
    -> bench eval (kernel mode and --int8-exact) -> bench summary, time and
    benchmark, through the port's CLIs in this process on phase 11's corpus,
    starting from its last checkpoint. Returns the arc's launches, records
    and numbers."""
    import argparse
    import torch
    import pqdet_tpu_torch.train.trainer as trainer_mod
    from pqdet_tpu_torch.cli import bench as cli_bench
    from pqdet_tpu_torch.cli import convert as cli_convert
    from pqdet_tpu_torch.cli import prune as cli_prune
    from pqdet_tpu_torch.compress.quantized import Int8Inference, load_quantized
    from pqdet_tpu_torch.config import load_config
    from pqdet_tpu_torch.data.eval_data import EvalData
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    from pqdet_tpu_torch.model.network import DetectionNetwork, to_device
    from pqdet_tpu_torch.ops.fused_ir import find_fused_triples
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.utils.codec import load_checkpoint

    here = os.path.dirname(os.path.abspath(__file__))
    shapes_yaml = os.path.join(here, 'yamls', 'shapes.yaml')
    quant_yaml = os.path.join(here, 'yamls', 'shapes_quant.yaml')
    root, wroot = corpus['root'], os.path.join(tmp, 'weights_prune')
    data = ['dataset.train_txt_file', os.path.join(root, 'train.txt'),
            'dataset.eval_txt_file', os.path.join(root, 'test.txt'),
            'system.num_workers', corpus['workers'], 'train.input_sizes', f'[{PRUNE_SIZE}]',
            'eval.input_size', str(PRUNE_SIZE), 'weight.dir', wroot]
    devarg = ['--device', dev.type]
    total, times, recs = {}, {}, {}
    host_ips = statistics.mean(ep['steps'] * corpus['batch'] / ep['s']
                               for e, ep in corpus['host_epochs'].items() if e > 0)

    def tally(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def tally_record(rec):
        for part in ('epochs', 'evals'):
            for v in rec[part].values():
                tally(v['launches'])

    # 1. sparse training from phase 11's last checkpoint
    recs['sparse'] = {}
    times['sparse'] = run_train_cli(['--yaml', shapes_yaml] + devarg + data + [
        'experiment_name', 'shapes_sparse', 'weight.resume', corpus['ckpt'],
        'weight.clear_history', 'on', 'sparse.switch', 'on', 'sparse.ratio', '0.005',
        'train.max_epochs', str(PRUNE_SPARSE_EPOCHS), 'eval.after', '99'], recs['sparse'])
    tally_record(recs['sparse'])
    sparse_ckpt = newest_ckpt(os.path.join(wroot, 'shapes_sparse'))

    # 2. prune, test the pruned model through the fused-IR kernel, fine-tune
    new_cfg = os.path.join(tmp, 'shapes_pruned.cfg')
    recs['finetune'], tested = {}, {}
    saved_trainer, saved_test = trainer_mod.Trainer, cli_prune._test

    def probed_test(cfg, result, device):
        t0 = time.perf_counter()
        reset_kernel_launches()
        saved_test(cfg, result, device)
        torch.cuda.synchronize()
        tested.update(s=time.perf_counter() - t0, launches=kernel_launches(),
                      batches=len(EvalData(cfg)))
        tally(tested['launches'])

    trainer_mod.Trainer = probed_trainer(saved_trainer, recs['finetune'])
    cli_prune._test = probed_test
    try:
        res, out, times['prune'], _ = run_cli(cli_prune.main, ['--yaml', shapes_yaml] + devarg
                                              + data + [
            'experiment_name', 'shapes_pruned', 'prune.weight', sparse_ckpt,
            'prune.new_cfg', new_cfg, 'prune.ratio', str(PRUNE_RATIO),
            'prune.finetune_epochs', str(PRUNE_FT_EPOCHS), 'eval.fused_ir', 'on'])
    finally:
        trainer_mod.Trainer, cli_prune._test = saved_trainer, saved_test
    tally_record(recs['finetune'])
    pgraph = DetectionNetwork.from_cfg(res.cfg_text).graph
    n_chains = len(find_fused_triples(pgraph))
    raw = sparse_ckpt.rsplit('.', 1)[0] + '-pruned.ckpt'
    ft_dir = os.path.join(wroot, 'shapes_pruned')
    ft_names = sorted(os.listdir(ft_dir))
    ft_ckpt = newest_ckpt(ft_dir)
    flops = [ln for ln in out.splitlines() if ln.startswith('flops: ')]
    print(f'phase 14 (c): {tag} cli.prune {times["prune"]:.2f} s (test {tested["s"]:.2f} s, '
          f'{n_chains} chains through the fused-IR kernel, launches {tested["launches"]}); '
          f'{res.report[0]}; {flops}; fine-tune checkpoints {ft_names}')
    with open(new_cfg) as fr:
        gate(fr.read() == res.cfg_text == load_checkpoint(raw)['cfg']
             and os.path.dirname(raw) == os.path.dirname(sparse_ckpt)
             and newest_ckpt(os.path.dirname(sparse_ckpt)) == sparse_ckpt,
             f'(c) prune.new_cfg written, the raw {os.path.basename(raw)} beside the sparse '
             'checkpoint with the pruned cfg, not taken by discovery')
    evals = recs['finetune']['evals']
    want = sorted(f'pruned-{round(PRUNE_RATIO * 100)}-model-{e}-{evals[e]["AP"]:.4f}.ckpt'
                  for e in evals)
    gate(ft_names == want and os.path.basename(ft_ckpt) == want[-1]
         and load_checkpoint(ft_ckpt)['cfg'] == res.cfg_text,
         f'(c) the fine-tune\'s checkpoints {ft_names} (want {want}) embed the pruned cfg')
    gate('mAPs' in out and tested['launches'] == {
        **dict.fromkeys(tested['launches'], 0), 'fused_ir_conv': n_chains * tested['batches'],
        'decode_heads': tested['batches']},
         f'(c) the pruned model\'s test launches {n_chains} fused chains and one decode per '
         f'eval batch ({tested["batches"]} batches)')
    ft_ips = trainer_gates(recs['finetune'], '(c) fine-tune', tag, gate, host_ips,
                           list(range(PRUNE_FT_EPOCHS)),
                           phase='phase 14')

    # 3. QAT on the pruned cfg, resumed from the fine-tuned checkpoint
    qnet = DetectionNetwork.from_cfg(res.cfg_text, quant=True)
    qshapes = int8_conv_shapes(qnet, PRUNE_SIZE)
    per_forward = {'qconv1x1_s8': sum(c for k, c in qshapes.items() if k[0] != 'dw'),
                   'qdwconv3x3_s8': sum(c for k, c in qshapes.items() if k[0] == 'dw'),
                   'decode_heads': 1}
    recs['qat'] = {}
    times['qat'] = run_train_cli(['--yaml', quant_yaml] + devarg + data + [
        'experiment_name', 'shapes_pruned_qat', 'weight.resume', ft_ckpt,
        'weight.clear_history', 'on', 'model.cfg_path', new_cfg,
        'train.max_epochs', str(PRUNE_QAT_EPOCHS), 'quant.disable_observer_after', '1',
        'quant.freeze_bn_after', '1', 'eval.after', '0'], recs['qat'])
    tally_record(recs['qat'])
    qat_ips = trainer_gates(recs['qat'], '(c) QAT', tag, gate, host_ips,
                            list(range(PRUNE_QAT_EPOCHS)), phase='phase 14',
                            per_forward=per_forward)
    qat_ckpt = newest_ckpt(os.path.join(wroot, 'shapes_pruned_qat'))
    trainer = recs['qat']['trainer']
    gate(load_checkpoint(qat_ckpt)['type'] == 'qat'
         and [n.attrs for n in trainer.network.graph.nodes] == [n.attrs for n in
                                                                 qnet.graph.nodes],
         f'(c) QAT built the pruned quant graph (model.cfg_path over the embedded cfg): '
         f'{os.path.basename(qat_ckpt)} of type qat')

    # 4. convert, 5. bench eval in kernel mode and with --int8-exact
    int8_path = os.path.join(tmp, 'shapes_pruned_int8.ckpt')
    _, out, times['convert'], _ = run_cli(cli_convert.main, [
        'quantize', '--weight', qat_ckpt, '--out', int8_path] + devarg)
    gate(load_checkpoint(int8_path)['type'] == 'quant',
         f'(c) convert quantize wrote a quant checkpoint in {times["convert"]:.2f} s')
    bench = ['--weight', int8_path, '--yaml', quant_yaml] + devarg + data
    ap_k, out_k, times['bench_eval'], ln_k = run_cli(cli_bench.main, ['eval'] + bench)
    ap_x, out_x, times['bench_exact'], ln_x = run_cli(cli_bench.main,
                                                      ['eval', '--int8-exact'] + bench)
    tally(ln_k)
    tally(ln_x)
    cfg = load_config(quant_yaml, data)
    n_eval = len(EvalData(cfg))
    print(f'phase 14 (c): {tag} bench eval {times["bench_eval"]:.2f} s, AP {ap_k.AP!r}, '
          f'launches {ln_k}; --int8-exact {times["bench_exact"]:.2f} s, AP {ap_x.AP!r}, '
          f'launches {ln_x}')
    gate('mAPs' in out_k and 'mAPs' in out_x and ln_k == {
        **dict.fromkeys(ln_k, 0), **{k: n * n_eval for k, n in per_forward.items()}},
         f'(c) bench eval in kernel mode launches per eval batch {per_forward}')

    # the kernel mode against its plain versions on the quant checkpoint
    # (phase 12's gate: the same arithmetic); against --int8-exact conv by
    # conv from the same input codes (the two modes round their epilogues
    # differently, so whole walks part by a cascade of single codes), and
    # over the whole eval split, printed
    qnet_l, qparams = load_quantized(int8_path, device=dev)
    plain_inf = Int8Inference(qnet_l, mode='kernel')
    plain_predict = make_batch_predict(build_predict_pipeline(
        qnet_l, cfg, device=dev, apply_fn=lambda p, x: plain_inf.apply(p, x, plain=True)),
        Int8Inference.prepare(qparams, mode='kernel'))

    def predict(exact):
        return cli_bench.make_predict(argparse.Namespace(
            weight=int8_path, int8_exact=exact, device=dev.type), cfg)
    n_same, n_img, n_det, n_found, _ = eval_agreement(predict(False), plain_predict,
                                                      EvalData(cfg), cfg)
    share = n_found / max(n_det, 1)
    print(f'phase 14 (c): {tag} bench eval\'s kernel mode against the plain versions on the '
          f'quant checkpoint: {n_found}/{n_det} plain detections found (share {share:.6f}), '
          f'{n_same}/{n_img} images with the same detections in the same order, to '
          f'{EVAL_AGREEMENT_ATOL}')
    gate(n_det > 0 and share >= INT8_EVAL_AGREEMENT and n_same >= INT8_EVAL_SAME_IMAGES,
         f'(c) the int8 eval in kernel mode gives {n_same} >= {INT8_EVAL_SAME_IMAGES} '
         f'images and {share:.6f} >= {INT8_EVAL_AGREEMENT} of the plain versions\' detections')
    first = next(iter(EvalData(cfg).batches(cfg.system.num_workers)))
    x = device_normalize(torch.as_tensor(first['image']).to(dev))
    n_conv, worst, n_diff, n_all, bad_heads = int8_modes_conv_parity(qnet_l, qparams, x)
    print(f'phase 14 (c): {tag} --int8-exact\'s convs from the kernel mode\'s input codes '
          f'(B={x.shape[0]}): {n_conv} convs, codes apart {n_diff} of {n_all} (max {worst}), '
          f'f32 head outputs outside 1e-5 * max(1, |r|): {bad_heads}')
    gate(n_conv == per_forward['qconv1x1_s8'] + per_forward['qdwconv3x3_s8']
         and int8_modes_agree(worst, n_diff, n_all, bad_heads),
         '(c) --int8-exact agrees with the kernel mode conv by conv: codes equal or 1 apart '
         f'on under {INT8_MODES_APART} of them, the heads within 1e-5')
    # printed: --int8-exact's walk on the card against the CPU's, one image
    cpu = torch.device('cpu')
    walks = {}
    for d in (dev, cpu):
        q = {'layers': to_device(qparams['layers'], d), 'act': qparams['act']}
        with torch.inference_mode():
            walks[d.type] = Int8Inference(qnet_l, mode='int').apply(
                Int8Inference.prepare(q, mode='int'), x[:1].to(d), intermediates=True)
    (pc, ic), (ph, ih) = walks[dev.type], walks['cpu']
    apart = [k for k in ih if k in qparams['act'] and not torch.equal(
        torch.round(ic[k].cpu() / qparams['act'][k][0]), torch.round(ih[k] / qparams['act'][k][0]))]
    print(f'phase 14 (c): {tag} --int8-exact on the card against the CPU, one image (not '
          f'gated): {len(apart)} of {len(qparams["act"])} quantised edges with codes apart '
          f'(first {apart[:3]}), preds max |d| {(pc.cpu() - ph).abs().max().item():.4g}')
    n_same, n_img, n_det, n_found, _ = eval_agreement(predict(False), predict(True),
                                                      EvalData(cfg), cfg)
    print(f'phase 14 (c): {tag} the whole eval, kernel mode against --int8-exact (not gated: '
          f'a code apart cascades through the walk): {n_found}/{n_det} exact detections '
          f'found, {n_same}/{n_img} images with the same detections in the same order, to '
          f'{EVAL_AGREEMENT_ATOL}')

    # 6. bench summary, time and benchmark on the pruned checkpoint
    (macs, n_params), out, _, _ = run_cli(cli_bench.main, [
        'summary', '--cfg', new_cfg, '--size', str(PRUNE_SIZE)])
    summary = out.strip().splitlines()[-1]
    trace_dir = os.path.join(tmp, 'trace_pruned')
    fwd = {}
    for name, extra in (('bf16', ['--bf16', '--trace', trace_dir]), ('f32', [])):
        t, out, _, ln = run_cli(cli_bench.main, [
            'time', '--weight', ft_ckpt, '--bs', str(BATCH), '--size', str(PRUNE_SIZE),
            '--yaml', shapes_yaml] + devarg + extra)
        tally(ln)
        fwd[name] = (t, ln)
        print(f'phase 14 (c): {tag} bench time {name}: {out.strip().splitlines()[-1]}; '
              f'launches {ln}')
    calls = fwd['bf16'][1]['decode_heads']
    gate(calls > 0 and fwd['bf16'][1] == {**dict.fromkeys(fwd['bf16'][1], 0),
                                          'fused_ir_conv': n_chains * calls,
                                          'decode_heads': calls}
         and fwd['f32'][1] == {**dict.fromkeys(fwd['f32'][1], 0),
                               'decode_heads': fwd['f32'][1]['decode_heads']}
         and os.path.exists(os.path.join(trace_dir, 'trace.json')),
         f'(c) bench time: bf16 launches {n_chains} fused chains and one decode per forward, '
         'f32 the decode alone; --trace wrote trace.json')
    stats, out, _, ln = run_cli(cli_bench.main, ['benchmark', '--weight', ft_ckpt, '--yaml',
                                                 shapes_yaml] + devarg + data)
    tally(ln)
    print(f'phase 14 (c): {tag} bench summary: {summary}; bench benchmark (f32, ms per batch '
          f'of {cfg.eval.batch_size}): {stats}; launches {ln}')
    gate(summary.startswith('flops:') and all(math.isfinite(v) and v > 0
                                                for v in stats.values()),
         '(c) bench summary printed the MACs and params, benchmark four finite stage times')
    return {'launches': total, 'macs': macs, 'params': n_params, 'times': times,
            'ft_ips': ft_ips, 'qat_ips': qat_ips, 'recs': recs, 'fwd': fwd}


def phase14_prune(dev, tag, tmp, corpus, ptx, base):
    """Phase 14: the slimming-prune arc on the card ((a)-(d), module
    docstring); ``base``: phases 5 and 8's per-forward kernel sums of the
    unpruned graph. Raises on any failed gate; returns the kernels'
    errors at the pruned shapes and the arc's launches."""
    import torch
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.utils.profiling import count_macs_params
    t_phase = time.perf_counter()
    fails = []

    def gate(ok, what):
        print(f'phase 14: {what}: {"ok" if ok else "FAIL"}')
        if not ok:
            fails.append(what)

    a = phase14_kernels_pruned(dev, tag, corpus)
    phase14_preserve(dev, tag, gate)
    arc = phase14_arc(dev, tag, tmp, corpus, gate)

    # (d) timings: phase 11's last checkpoint unpruned against (a)'s pruned
    # model, in turns
    gen = phase_gen(141)
    batch = request_maker(gen, dev)
    res = a['pruned']
    bf = {'unpruned': bf16_server(a['net'], a['params'], a['state'], dev),
          'pruned': bf16_server(a['pnet'], res.params, res.state, dev)}
    q8 = {'unpruned': int8_server(a['cfg'], a['params'], a['state'], batch, dev),
          'pruned': int8_server(res.cfg_text, res.params, res.state, batch, dev)}
    for label, servers in (('bf16', bf), ('int8', q8)):
        request_times({f'{label} {k}': v[0] for k, v in servers.items()}, batch, BATCH, tag,
                      'phase 14 (d)', PRUNE_TIMED_REQUESTS)
    with torch.inference_mode():
        x = device_normalize(batch(BATCH)['image'])
    for label, servers in (('bf16', bf), ('int8', q8)):
        ms = {k: device_ms(lambda f=v[1]: f(x), iters=3, replays=3) for k, v in servers.items()}
        print(f'phase 14 (d): {tag} {label} forward on the device alone (CUDA graph), B={BATCH}: '
              + ', '.join(f'{k} {v:.4f} ms' for k, v in ms.items())
              + f' (pruned / unpruned {ms["pruned"] / ms["unpruned"]:.4f})')
    fir = fused_chain_times(gen, dev, a['chains'], ptx, tag, 'phase 14 (d)')
    q = int8_kernel_times(gen, dev, a['qshapes'], ptx, tag, 'phase 14 (d)')
    pruned = {'fused_ir_conv': fir, **q}
    for name, t in pruned.items():
        b = base[name]
        print(f'phase 14 (d): {tag} {name} per B={BATCH} forward, pruned (unpruned, phases 5 '
              f'and 8): kernel {t["ms"]:.4f} ({b["ms"]:.4f}) ms, plain {t["plain_ms"]:.4f} '
              f'({b["plain_ms"]:.4f}), library {t["library_ms"]:.4f} ({b["library_ms"]:.4f}), '
              f'bound {t["bound_ms"]:.5f} ({b["bound_ms"]:.5f}) ms, {t["bound_by"]}')
    m0 = count_macs_params(a['net'].graph, (SIZE, SIZE))
    m1 = count_macs_params(a['pnet'].graph, (SIZE, SIZE))
    sparse_ep = arc['recs']['sparse']['epochs']
    b16 = arc['recs']['sparse']['trainer'].config.train.batch_size
    sparse_ips = [ep['steps'] * b16 / ep['s'] for ep in sparse_ep.values()]
    print(f'phase 14 (d): {tag} MACs and params at {SIZE}x{SIZE}: (a) {m0} -> {m1}; the arc\'s '
          f'pruned cfg (bench summary) {arc["macs"]}, {arc["params"]}; images/s: the sparse '
          f'epoch (unpruned) {[round(v, 2) for v in sparse_ips]}, the pruned fine-tune\'s '
          f'epochs after the first {arc["ft_ips"]:.2f}, the pruned QAT\'s {arc["qat_ips"]:.2f}; '
          f'CLI seconds {dict((k, round(v, 2)) for k, v in arc["times"].items())}')
    print(f'phase 14: {tag} phase seconds {time.perf_counter() - t_phase:.1f}')
    if fails:
        raise AssertionError(f'phase 14 gates failed: {fails}')
    return {'fused_err': a['fused_err'], 'int8_err': a['int8_err'],
            'launches': arc['launches']}


# ------------------------------------------------------------------ phase 15

EXPORT_BATCHES = (1, BATCH)     # the CLI's default --bs, and the requests' B
NMS_ARGS = (0.1, 0.45, 256)     # export_stablehlo's defaults
ONNX_FP_TOL = 1e-4              # tests/test_onnx.py:73, rtol = atol
ONNX_BOX_MEDIAN = 1.0           # tests/test_onnx.py:112-113: px ...
ONNX_SCORE_MEDIAN = 0.05        # ... and scores
INT8_PER_FORWARD = {'qconv1x1_s8': 58, 'qdwconv3x3_s8': 26, 'decode_heads': 1}


def load_artifacts(manifest_path):
    """Phase 15's fresh process: load each artifact of the manifest with
    ``load_stablehlo``, importing pqdet_tpu_torch and nothing of the JAX
    package, run it once on its saved input, save the output, and write
    (to ``<manifest>.report``) each artifact's load and first-call seconds
    and the kernel launches of its call. TF32 is off as in this script:
    the program carries no precision flag, its runtime's applies."""
    t0 = time.perf_counter()
    import torch
    from pqdet_tpu_torch.exporters.export import load_stablehlo
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(manifest_path) as fr:
        manifest = json.load(fr)
    dev = manifest['device']
    report = {'import_s': time.perf_counter() - t0, 'artifacts': {}}
    for name, item in manifest['artifacts'].items():
        t0 = time.perf_counter()
        with open(item['artifact'], 'rb') as fr:
            fn = load_stablehlo(fr.read(), device=dev)
        load_s = time.perf_counter() - t0
        x = torch.load(item['input'], map_location=dev)
        reset_kernel_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn(x)
        if dev != 'cpu':
            torch.cuda.synchronize()
        report['artifacts'][name] = {'load_s': load_s, 'first_call_s': time.perf_counter() - t0,
                                     'launches': kernel_launches()}
        torch.save(out, item['output'])
    report['foreign'] = sorted(m for m in sys.modules
                               if m.split('.')[0] in ('jax', 'jaxlib', 'pqdet_tpu'))
    with open(manifest_path + '.report', 'w') as fw:
        json.dump(report, fw)


def same_outputs(got, want) -> bool:
    """Bit-for-bit equality of a tensor or a tuple of tensors."""
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b.to(a.device))
        for a, b in zip(got, want))


def phase15_artifacts(dev, tag, out_dir, gen, net, fused, qnet, qparams):
    """Phase 15 (a), (b), (e): each artifact exported at B=1 and B=4, loaded
    here and in a fresh process, held to its eager path bit for bit, its
    graph's operators and launches counted, and timed beside the eager
    path. Returns the kernel launches of the kernel artifacts' calls
    here."""
    import collections
    import torch
    from pqdet_tpu_torch.cli import bench as cli_bench
    from pqdet_tpu_torch.compress.quantized import Int8Inference
    from pqdet_tpu_torch.exporters.export import (export_stablehlo, export_stablehlo_quant,
                                                  load_stablehlo)
    from pqdet_tpu_torch.ops import library
    from pqdet_tpu_torch.ops.postprocess import nms_batch
    from pqdet_tpu_torch.utils.profiling import forward_latency_ms

    infs = {m: Int8Inference(qnet, mode=m) for m in ('int', 'kernel')}
    staged = {m: Int8Inference.prepare(qparams, m) for m in infs}
    # the eager path each artifact is held to
    eager = {
        'fp': lambda x: net(fused, {}, x, plain=True),
        'fp_nms': lambda x: tuple(nms_batch(net(fused, {}, x, plain=True), *NMS_ARGS))[:4],
        'int': lambda x: infs['int'].apply(staged['int'], x, plain=True),
        'kernel': lambda x: infs['kernel'].apply(staged['kernel'], x),
    }
    export = {
        'fp': lambda b: export_stablehlo(net, fused, (SIZE, SIZE), b, device=dev),
        'fp_nms': lambda b: export_stablehlo(net, fused, (SIZE, SIZE), b, True, *NMS_ARGS,
                                             device=dev),
        'int': lambda b: export_stablehlo_quant(qnet, qparams, (SIZE, SIZE), b, 'int',
                                                device=dev),
        'kernel': lambda b: export_stablehlo_quant(qnet, qparams, (SIZE, SIZE), b, 'kernel',
                                                   device=dev),
    }
    want_ops = {f'{library.NAMESPACE}.{k}.default': v for k, v in INT8_PER_FORWARD.items()}
    launches = dict.fromkeys(INT8_PER_FORWARD, 0)
    refs, items, rows = {}, {}, {}
    for b in EXPORT_BATCHES:
        x = torch.rand(b, SIZE, SIZE, 3, generator=gen).to(dev)     # normalized images
        for kind in export:
            name = f'{kind}_b{b}'
            t0 = time.perf_counter()
            blob = export[kind](b)
            export_s = time.perf_counter() - t0
            path = os.path.join(out_dir, f'{name}.pt2')
            with open(path, 'wb') as fw:
                fw.write(blob)
            t0 = time.perf_counter()
            fn = load_stablehlo(blob, device=dev)
            load_s = time.perf_counter() - t0
            ops = dict(collections.Counter(library.graph_ops(fn)))
            with torch.inference_mode():
                ref = eager[kind](x)
                torch.cuda.synchronize()
                reset_kernel_launches()
                got = fn(x)
                torch.cuda.synchronize()
                counts = kernel_launches()
            want = INT8_PER_FORWARD if kind == 'kernel' else {}
            ran = {k: v for k, v in counts.items() if v}
            ok = ops == (want_ops if kind == 'kernel' else {}) and ran == want \
                and same_outputs(got, ref)
            print(f'phase 15: {tag} {name}: exported in {export_s:.2f} s, {len(blob)} bytes, '
                  f'loaded in {load_s:.2f} s here; graph operators {ops or "none of pqdet"}; '
                  f'one call launched {ran or "no kernel"}; equal to its eager path bit '
                  f'for bit: {same_outputs(got, ref)} {"ok" if ok else "FAIL"}')
            if not ok:
                raise AssertionError(f'phase 15: the {name} artifact disagrees with its eager '
                                     'path, or holds or launches the wrong kernels')
            if kind == 'kernel':
                for k in launches:
                    launches[k] += counts[k]
            refs[name] = ref
            torch.save(x, os.path.join(out_dir, f'{name}.x'))
            items[name] = {'artifact': path, 'input': os.path.join(out_dir, f'{name}.x'),
                           'output': os.path.join(out_dir, f'{name}.y')}
            rows[name] = {'b': b, 'kind': kind, 'x': x, 'export_s': export_s,
                          'bytes': len(blob), 'path': path}

    # (a), (b) in a fresh process that imports only the port
    manifest = os.path.join(out_dir, 'manifest.json')
    with open(manifest, 'w') as fw:
        json.dump({'device': str(dev), 'artifacts': items}, fw)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, '-c', 'import chip_smoke; chip_smoke.load_artifacts('
                          f'{manifest!r})'], cwd=here, capture_output=True, text=True,
                         timeout=900)
    if run.returncode != 0:
        raise AssertionError(f'phase 15: the fresh process failed:\n{run.stdout}\n{run.stderr}')
    with open(manifest + '.report') as fr:
        report = json.load(fr)
    print(f'phase 15: {tag} fresh process: {time.perf_counter() - t0:.2f} s in all, imports '
          f'{report["import_s"]:.2f} s, modules of jax or pqdet_tpu loaded: '
          f'{report["foreign"] or "none"}')
    bad = list(report['foreign'])
    for name, r in report['artifacts'].items():
        ran = {k: v for k, v in r['launches'].items() if v}
        want = INT8_PER_FORWARD if rows[name]['kind'] == 'kernel' else {}
        equal = same_outputs(torch.load(items[name]['output'], map_location=dev), refs[name])
        rows[name]['fresh_load_s'] = r['load_s']
        print(f'phase 15: {tag} fresh process {name}: loaded in {r["load_s"]:.2f} s, first '
              f'call {r["first_call_s"]:.2f} s, launched {ran or "no kernel"}; equal to the '
              f'eager path bit for bit: {equal} {"ok" if equal and ran == want else "FAIL"}')
        if not (equal and ran == want):
            bad.append(name)
    if bad:
        raise AssertionError(f'phase 15: fresh-process artifacts disagree: {bad}')

    # (e) bench time --shlo against the eager path, the same timer
    for name, row in rows.items():
        t_art, text, _, _ = run_cli(cli_bench.main, [
            'time', '--shlo', row['path'], '--bs', str(row['b']), '--size', str(SIZE),
            '--device', str(dev)])
        x = torch.zeros_like(row['x'])
        with torch.inference_mode():
            t_eager = forward_latency_ms(lambda: eager[row['kind']](x), dev)
        print(f'phase 15: {tag} {name}: bench time --shlo mean {t_art["mean"]:.3f} ms, p50 '
              f'{t_art["p50"]:.3f}, p90 {t_art["p90"]:.3f}; eager mean {t_eager["mean"]:.3f} '
              f'ms, p50 {t_eager["p50"]:.3f}, p90 {t_eager["p90"]:.3f} (CUDA events around '
              'each call, 64 calls after 10)')
    return launches


def phase15_files(dev, tag, out_dir, gen, net, params, state, fused, qnet, qparams):
    """Phase 15 (c), (d), (e): the ONNX files through ``cli.convert onnx``
    and the port's runtime on the card, and the darknet and partial round
    trips, from phase 4's and 7's weights saved as checkpoints."""
    import numpy as np
    import torch
    from pqdet_tpu_torch.cli import convert as cli_convert
    from pqdet_tpu_torch.compress.quantized import Int8Inference, save_quantized
    from pqdet_tpu_torch.exporters.export import load_weights_darknet
    from pqdet_tpu_torch.exporters.onnx_runtime import run_model
    from pqdet_tpu_torch.train.checkpoint import save_checkpoint
    from pqdet_tpu_torch.utils.codec import load_checkpoint
    from pqdet_tpu_torch.zoo import get_cfg

    cfg_text = get_cfg('mobilenetv2-fpn')
    ckpt, qckpt = os.path.join(out_dir, 'fp.ckpt'), os.path.join(out_dir, 'int8.ckpt')
    save_checkpoint(ckpt, net.graph, params, state, step=0, cfg_text=cfg_text)
    save_quantized(qckpt, qnet, qparams, cfg_text)
    int_mode = Int8Inference(qnet, mode='int')
    int_staged = Int8Inference.prepare(qparams, 'int')
    dev_arg = ['--device', str(dev)]

    # (c) ONNX: write, run on the card, hold to the eager paths
    x = torch.rand(1, SIZE, SIZE, 3, generator=gen).to(dev)
    feeds = {'input': x.permute(0, 3, 1, 2).contiguous()}
    for kind, weight in (('fp', ckpt), ('quant', qckpt)):
        path = os.path.join(out_dir, f'{kind}.onnx')
        _, _, write_s, _ = run_cli(cli_convert.main, [
            'onnx', '--weight', weight, '--out', path, '--size', str(SIZE), *dev_arg])
        with open(path, 'rb') as fr:
            blob = fr.read()
        out, = run_model(blob, feeds, device=dev)
        run_ms = cuda_ms(lambda: run_model(blob, feeds, device=dev), iters=3, warmup=1)
        with torch.inference_mode():
            if kind == 'fp':
                ref = net(fused, {}, x, plain=True)
            else:
                ref = int_mode.apply(int_staged, x, plain=True)
        d = (out - ref).abs()
        if kind == 'fp':
            worst = (d - ONNX_FP_TOL * ref.abs()).max().item()
            ok = out.shape == ref.shape and worst <= ONNX_FP_TOL
            what = (f'max |d| {d.max().item():.4g}, max of |d| - {ONNX_FP_TOL} |r| '
                    f'{worst:.4g} (<= {ONNX_FP_TOL})')
        else:
            box, score = d[..., :4].median().item(), d[..., 4:].median().item()
            ok = out.shape == ref.shape and box < ONNX_BOX_MEDIAN and score < ONNX_SCORE_MEDIAN
            what = (f'median |d| boxes {box:.4g} px (< {ONNX_BOX_MEDIAN}), scores {score:.4g} '
                    f'(< {ONNX_SCORE_MEDIAN}); max |d| boxes {d[..., :4].max().item():.4g}, '
                    f'scores {d[..., 4:].max().item():.4g}')
        print(f'phase 15: {tag} ONNX {kind}: convert onnx {write_s:.2f} s, {len(blob)} bytes; '
              f'run_model on the card {run_ms:.2f} ms a call (B=1, {SIZE}x{SIZE}); against '
              f'the eager {"f32 walk" if kind == "fp" else "int mode"}: {what} '
              f'{"ok" if ok else "FAIL"}')
        if not ok:
            raise AssertionError(f'phase 15: the {kind} ONNX file disagrees with the port')

    # (d) darknet: write through the CLI, read back into other weights
    weights = os.path.join(out_dir, 'm.weights')
    _, _, dk_s, _ = run_cli(cli_convert.main, ['darknet', '--weight', ckpt, '--out', weights,
                                               *dev_arg])
    lp, ls = load_weights_darknet(net, weights, *net.init(torch.Generator().manual_seed(99),
                                                          device=dev))
    pairs = [(lp[k]['w'], p['w']) for k, p in params.items()]
    pairs += [(lp[k]['bn'][n], p['bn'][n]) for k, p in params.items() if 'bn' in p
              for n in ('gamma', 'beta')]
    pairs += [(lp[k]['b'], p['b']) for k, p in params.items() if 'b' in p]
    pairs += [(ls[k][n], s[n]) for k, s in state.items() for n in ('mean', 'var')]
    n_equal = sum(a.device == b.device and torch.equal(a, b) for a, b in pairs)
    print(f'phase 15: {tag} darknet: convert darknet {dk_s:.2f} s, '
          f'{os.path.getsize(weights)} bytes; load_weights_darknet on the card gives back '
          f'{n_equal} of {len(pairs)} arrays bit for bit')
    if n_equal != len(pairs):
        raise AssertionError('phase 15: the darknet round trip lost an array')

    # (d) partial: the backbone's nodes, every kept array as it was
    part = os.path.join(out_dir, 'partial.ckpt')
    _, _, part_s, _ = run_cli(cli_convert.main, ['partial', '--weight', ckpt, '--out', part,
                                                 '--layers', '40', *dev_arg])
    full, kept = load_checkpoint(ckpt), load_checkpoint(part)
    want = sorted(k for k in full['params'] if int(k) <= 40)
    same = all(np.array_equal(kept['params'][k]['w'], full['params'][k]['w']) for k in want)
    ok = sorted(kept['params']) == want and same and kept['cfg'] == cfg_text
    print(f'phase 15: {tag} partial --layers 40: {part_s:.2f} s, {len(want)} of '
          f'{len(full["params"])} weighted nodes kept, arrays equal {same} '
          f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError('phase 15: the partial checkpoint is wrong')


def phase15_exporters(dev, tag, tmp, net, params, state, qnet, qparams):
    """Phase 15: the exporters on the card ((a)-(e), module docstring).
    Returns the kernel launches of the kernel artifacts' calls."""
    from pqdet_tpu_torch.model.network import fuse_params
    out_dir = os.path.join(tmp, 'exports')
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    gen = phase_gen(15)
    fused = fuse_params(net, params, state)
    launches = phase15_artifacts(dev, tag, out_dir, gen, net, fused, qnet, qparams)
    phase15_files(dev, tag, out_dir, gen, net, params, state, fused, qnet, qparams)
    print(f'phase 15: {tag} {time.perf_counter() - t0:.1f} s; kernel artifacts launched '
          f'{launches}')
    return launches


# ------------------------------------------------------------------ phase 16

# the RegNet zoo and grouped convs (phase 16): the two FPN detectors served
# in bf16 and int8, the YOLO-neck variant for its fused chains and
# depthwise convs, the train step and one trainer epoch of REGNET_TRAINED
REGNET_FPN = ('regnetx-600m-fpn', 'regnety-400m-fpn')
REGNET_YOLO = 'regnetx-600m-yolo'
REGNET_TRAINED = 'regnetx-600m-fpn'
REGNET_GAIN = 1.5              # seed_bn's weight gain: scores 0.24-0.76 at 512, boxes finite
REGNET_REQUESTS = 8            # (b): requests of each model and mode, launches counted
REGNET_TIMED_REQUESTS = 20     # (e): requests of each model and mode, p50 and p90
REGNET_TRAIN_STEPS = 10        # (c): bf16 steps at B=12, 512x512 on one batch ...
REGNET_TRAIN_WARMUP = 3        # ... the first ones out of the step's p50


def grouped_macs(graph, size):
    """(MACs of one image at ``size`` with grouped convs, with the grouped
    convs of group width >= 2 densified), thop's convention."""
    from pqdet_tpu_torch.utils.profiling import count_macs_params
    macs, _ = count_macs_params(graph, (size, size))
    sides = out_sides(graph, size)
    extra = 0
    for n in graph.nodes:
        a = n.attrs
        if n.kind == 'convolutional' and a['groups'] > 1 \
                and n.in_channels // a['groups'] >= 2:
            cin_g = n.in_channels // a['groups']
            extra += sides[n.index] ** 2 * a['filters'] * (n.in_channels - cin_g) * a['size'] ** 2
    return macs, macs + extra


def bf16_node_parity(net, fparams, table, x, s2d_stem=0):
    """The bf16 walk through the kernels against ``plain=True`` on the same
    input, node by node (the ``tap`` of each node the walk runs): the
    nodes before the first fused chain equal bit for bit (they run the same
    cuDNN ops), the preds within phase 4's bounds. Returns (n tapped,
    n equal, n before the first chain, n of those equal, scores max |d|,
    boxes max |d|)."""
    import torch

    def tapper(store):
        return lambda i, y: store.__setitem__(i, y.clone())
    kern_t, plain_t = {}, {}
    with torch.inference_mode():
        kern = net(fparams, {}, x, compute_dtype=torch.bfloat16, fused_ir=table,
                   tap=tapper(kern_t), s2d_stem=s2d_stem)
        plain = net(fparams, {}, x, compute_dtype=torch.bfloat16, fused_ir=table, plain=True,
                    tap=tapper(plain_t), s2d_stem=s2d_stem)
    first = min(table) if table else len(net.graph.nodes)
    seen = sorted(set(kern_t) & set(plain_t))
    equal = {i for i in seen if torch.equal(kern_t[i], plain_t[i])}
    before = [i for i in seen if i < first]
    ds = (kern[..., 4:] - plain[..., 4:]).abs().max().item()
    db = (kern[..., :4] - plain[..., :4]).abs().max().item()
    return len(seen), len(equal), len(before), len(equal & set(before)), ds, db


def int8_node_parity(inf, qprep, qparams, qnet, x):
    """The int8 kernel path against ``apply(plain=True)`` on the card node by
    node: s8 edges in codes (equal or 1 apart on under 1e-3), yolo views to
    the decode tolerance, f32 head convs to 1e-5 * max(1, |r|). Returns
    (kernel preds, plain preds, nodes outside the bound, n equal bit for
    bit, n nodes)."""
    import torch
    act = qparams['act']
    nc = qnet.num_classes
    with torch.inference_mode():
        kern, ik = inf.apply(qprep, x, intermediates=True)
        plain, ip = inf.apply(qprep, x, intermediates=True, plain=True)
    nodes = {str(n.index): n for n in qnet.graph.nodes}
    bad, n_exact = [], 0
    for key, a in ik.items():
        b = ip[key]
        node = nodes[key]
        if key in act:                                 # s8 edge: in codes
            d = ((a - b).abs() / act[key][0]).round()
            ok = d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
        elif node.kind == 'yolo':
            raw = ip[str(node.index - 1)]
            ok = bool(((a - b).abs() <= decode_tolerance(raw, nc, node.attrs['stride'], 0.0))
                      .all())
        else:                                          # f32 head conv
            ok = bool(((a - b).abs() <= 1e-5 * b.abs().clamp_min(1.0)).all())
        n_exact += int(torch.equal(a, b))
        if not ok:
            bad.append(key)
    return kern, plain, bad, n_exact, len(ik)


def phase16_kernels(dev, tag, qnets):
    """(a): each int8 conv shape of the int8 graphs of REGNET_FPN and the
    depthwise shapes of REGNET_YOLO's (phase 6's check: every output bit
    for bit) and each fused chain of REGNET_YOLO (phase 3's tolerance), at
    SIZE. Returns the largest errors."""
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.zoo import get_cfg
    gen = phase_gen(16)
    shapes = {}
    for name in REGNET_FPN:
        s = int8_conv_shapes(qnets[name], SIZE)
        ks = sorted(k[3] for k in s if k[0] == 'stem')
        se = sorted((k[3], k[4]) for k in s if k[1] == 1)
        print(f'phase 16 (a): {name} int8 graph: {sum(s.values())} convs in {len(s)} shapes; '
              f'dense and densified 3x3s through im2col at K {ks}; SE 1x1s at M = B: {se}')
        for k, c in s.items():
            shapes[k] = shapes.get(k, 0) + c
    ydw = {k: c for k, c in int8_conv_shapes(qnets[REGNET_YOLO], SIZE).items() if k[0] == 'dw'}
    print(f'phase 16 (a): {REGNET_YOLO} depthwise shapes {sorted(ydw)}')
    shapes.update(ydw)
    int8_err = phase6_int8_parity(gen, dev, shapes, batches=(BATCH,), edges=False,
                                  label='phase 16 (a)')
    chains = chain_shapes(DetectionNetwork.from_cfg(get_cfg(REGNET_YOLO)), SIZE)
    checks = [(f'{a},{b},{c}', n, h, h, cin, e, p, a is not None, acts, 0.0)
              for a, b, c, h, cin, e, p, acts in chains for n in (1, BATCH)]
    fused_err = fused_parity(gen, dev, checks, 'phase 16 (a)')
    return {'int8_err': int8_err, 'fused_err': fused_err, 'chains': chains, 'qshapes': shapes}


def phase16_serving(dev, tag, gate):
    """(b): REGNET_FPN and REGNET_YOLO (seeded weights, REGNET_GAIN) served in
    bf16 (grouped convs densified, ``inference_params``' default) and in int8
    (4 observer passes, ``convert_to_int8``, ``Int8Inference(mode='kernel')``
    with ``prepare(network=)``), REGNET_REQUESTS requests of B=BATCH each
    through ``make_batch_predict``: launches per forward against the graph's
    count, node by node against ``plain=True``, finite detections. Returns
    the servers, the main path's launches and the models."""
    import torch
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.zoo import get_cfg
    gen = phase_gen(161)
    batch = request_maker(gen, dev)
    launches = dict.fromkeys(('decode_heads', 'fused_ir_conv', 'qconv1x1_s8', 'qdwconv3x3_s8'),
                             0)
    servers, models = {}, {}
    for name in REGNET_FPN + (REGNET_YOLO,):
        cfg_text = get_cfg(name)
        net = DetectionNetwork.from_cfg(cfg_text)
        qnet = DetectionNetwork.from_cfg(cfg_text, quant=True)
        params, state = net.init(gen, device=dev)
        seed_bn(params, state, gen, dev, gain=REGNET_GAIN)
        models[name] = (net, params, state, qnet)
        qs = int8_conv_shapes(qnet, SIZE)
        n_pw = sum(c for k, c in qs.items() if k[0] != 'dw')
        n_dw = sum(c for k, c in qs.items() if k[0] == 'dw')
        bf = bf16_server(net, params, state, dev)
        q8 = int8_server(cfg_text, params, state, batch, dev)
        servers[name] = {'bf16': bf, 'int8': q8}
        per = {'bf16': {'decode_heads': 1, 'fused_ir_conv': len(bf[2])},
               'int8': {'decode_heads': 1, 'qconv1x1_s8': n_pw, 'qdwconv3x3_s8': n_dw}}
        requests = [batch(BATCH) for _ in range(REGNET_REQUESTS)]
        for mode, (predict, *_) in (('bf16', bf), ('int8', q8)):
            predict(requests[0])                       # warm-up
            torch.cuda.synchronize()
            reset_kernel_launches()
            dets = [predict(r) for r in requests]
            torch.cuda.synchronize()
            got = kernel_launches()
            for k, v in got.items():
                launches[k] += v
            want = {**dict.fromkeys(got, 0),
                    **{k: n * REGNET_REQUESTS for k, n in per[mode].items()}}
            n_det = sum(len(d) for r in dets for d in r)
            finite = all(d.shape[1] == 6 and bool(torch.isfinite(torch.from_numpy(d)).all())
                         for r in dets for d in r)
            gate(got == want, f'(b) {name} {mode}: {REGNET_REQUESTS} requests of B={BATCH}, '
                 f'launches {got} (want {want}: per forward {per[mode]})')
            gate(finite and n_det > 0, f'(b) {name} {mode}: {n_det} detections, all finite')
        with torch.inference_mode():
            x = device_normalize(requests[0]['image'])
        fparams = bf[3]
        n, n_eq, n_before, n_before_eq, ds, db = bf16_node_parity(net, fparams, bf[2], x)
        gate(n_before_eq == n_before and ds <= 0.03 and db <= 1.5,
             f'(b) {name} bf16 against plain=True: {n_eq} of {n} tapped nodes equal bit for '
             f'bit, {n_before_eq} of the {n_before} before the first fused chain (want all); '
             f'preds scores max |d| {ds:.4g} (<= 0.03), boxes {db:.4g} px (<= 1.5)')
        inf, prep, qparams = q8[2], q8[3], q8[4]
        kern, plain, bad, n_exact, n_nodes = int8_node_parity(inf, prep, qparams, qnet, x)
        ds = (kern[..., 4:] - plain[..., 4:]).abs().max().item()
        db = (kern[..., :4] - plain[..., :4]).abs().max().item()
        gate(not bad and ds <= 0.02 and db <= 1.0,
             f'(b) {name} int8 against plain=True: {n_exact} of {n_nodes} nodes equal bit for '
             f'bit, outside the bound {bad}; preds scores max |d| {ds:.4g} (<= 0.02), boxes '
             f'{db:.4g} px (<= 1)')
        with torch.inference_mode():
            fp = bf[1](x)
        sc = fp[..., 4:]
        print(f'phase 16 (b): {name} bf16 scores {sc.min().item():.3g}-{sc.max().item():.3g} '
              f'(std {sc.std().item():.3g}); int8 against bf16, same weights (not gated): '
              f'median |d| scores {(kern[..., 4:] - sc).abs().median().item():.4g}, boxes '
              f'{(kern[..., :4] - fp[..., :4]).abs().median().item():.4g} px')
    return servers, launches, models


def phase16_train(dev, tag, gate):
    """(c): the REGNET_TRAINED train step of ``train_config`` (grouped cuDNN
    convs): phase 9's f32 card-against-CPU parity, then REGNET_TRAIN_STEPS
    bf16 steps at B=12, SIZE on one batch (finite, loss falling, BN moved,
    no kernel launched). Returns the step's ms and peak memory."""
    import torch
    from pqdet_tpu_torch.model.network import DetectionNetwork, to_device
    from pqdet_tpu_torch.train.step import train_step_from_config, tree_leaves
    from pqdet_tpu_torch.zoo import get_cfg
    gen = phase_gen(162)
    cfg = train_config()
    net = DetectionNetwork.from_cfg(get_cfg(REGNET_TRAINED))
    params, state = net.init(gen, device='cpu')
    n_params = sum(t.numel() for t in tree_leaves(params))
    reset_kernel_launches()
    t0 = time.perf_counter()
    phase9_parity(net, params, state, gen, dev, cfg, label='phase 16 (c)')
    print(f'phase 16 (c): card-against-CPU parity {time.perf_counter() - t0:.2f} s')
    step, opt = train_step_from_config(net, cfg, TRAIN_WARMUP, device=dev)
    p, s = to_device(params, dev), to_device(state, dev)
    o = opt.init(p)
    b = cfg.train.batch_size
    tb = train_batch(gen, b, SIZE, dev, cfg.model.max_gt_boxes)
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in range(REGNET_TRAIN_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p, s, o, m = step(p, s, o, tb)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(m['loss']))
    peak = torch.cuda.max_memory_allocated(dev)
    moved = max((s[k]['mean'] - state[k]['mean'].to(dev)).abs().max().item() for k in s)
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    gate(all(math.isfinite(x) for x in losses) and last < first and moved > 0,
         f'(c) {REGNET_TRAINED} ({n_params} params) {REGNET_TRAIN_STEPS} '
         f'{cfg.system.compute_dtype} steps at {SIZE}x{SIZE}, B={b} on one batch: losses '
         f'{[round(x, 3) for x in losses]}, mean of the last 3 below the first 3\'s, BN '
         f'running means moved by up to {moved:.4g}')
    launches = kernel_launches()
    gate(not any(launches.values()), f'(c) hand-written kernel launches in the steps: '
         f'{launches} (want all 0)')
    timed = sorted(ms[REGNET_TRAIN_WARMUP:])
    p50, p90 = statistics.median(timed), timed[int(0.9 * (len(timed) - 1))]
    print(f'phase 16 (c): {tag} train step {REGNET_TRAINED} {SIZE}x{SIZE} B={b} '
          f'{cfg.system.compute_dtype} ({len(timed)} steps after {REGNET_TRAIN_WARMUP}, CUDA '
          f'events): p50 {p50:.3f} ms, p90 {p90:.3f} ms, {b * 1000.0 / p50:.2f} images/s; the '
          f'first step {ms[0]:.1f} ms; peak memory {peak / 2**30:.3f} GiB')
    return {'p50': p50, 'p90': p90, 'peak': peak}


def phase16_trainer(dev, tag, tmp, corpus, gate):
    """(d): one epoch of ``cli.train`` on phase 11's corpus from a copy of
    yamls/shapes.yaml with ``model.cfg_path: REGNET_TRAINED``, at
    ``train.input_sizes [SIZE]`` (the yaml's 416-512: each new size pays a
    first step), evaluated after the epoch. Gates: phase 13's trainer gates
    and a checkpoint in the JAX package's layout (HWIO grouped weights, the
    zoo's cfg text) that loads back strictly."""
    import yaml
    from pqdet_tpu_torch.model.factory import build_detector
    from pqdet_tpu_torch.utils.codec import load_checkpoint
    from pqdet_tpu_torch.zoo import get_cfg
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, 'yamls', 'shapes.yaml')) as fr:
        y = yaml.safe_load(fr)
    y['model']['cfg_path'] = REGNET_TRAINED
    ypath = os.path.join(tmp, 'shapes_regnet.yaml')
    with open(ypath, 'w') as fw:
        yaml.safe_dump(y, fw)
    root = corpus['root']
    wroot = os.path.join(tmp, 'weights_regnet')
    rec = {}
    wall = run_train_cli(['--yaml', ypath,
                          'dataset.train_txt_file', os.path.join(root, 'train.txt'),
                          'dataset.eval_txt_file', os.path.join(root, 'test.txt'),
                          'weight.dir', wroot, 'train.max_epochs', '1', 'eval.after', '0',
                          'train.input_sizes', f'[{SIZE}]', 'experiment_name',
                          'shapes_regnet'], rec)
    trainer = rec['trainer']
    ep = rec['epochs'][0]
    print(f'phase 16 (d): {tag} cli.train {os.path.basename(ypath)} (model.cfg_path '
          f'{trainer.config.model.cfg_path}): {wall:.2f} s; epoch 0 {ep["s"]:.3f} s, '
          f'{ep["steps"]} steps of B={trainer.config.train.batch_size}')
    host_ips = statistics.mean(e['steps'] * corpus['batch'] / e['s']
                               for i, e in corpus['host_epochs'].items() if i > 0)
    trainer_gates(rec, '(d) RegNet trainer', tag, gate, host_ips, [0], phase='phase 16')
    wdir = os.path.join(wroot, 'shapes_regnet')
    path = os.path.join(wdir, sorted(os.listdir(wdir))[-1])
    ck = load_checkpoint(path)
    want_cfg = get_cfg(REGNET_TRAINED, num_classes=len(trainer.config.dataset.classes))
    grouped = [n for n in trainer.network.graph.nodes
               if n.kind == 'convolutional' and n.attrs['groups'] > 1]
    hwio = all(tuple(ck['params'][str(n.index)]['w'].shape)
               == (3, 3, n.in_channels // n.attrs['groups'], n.attrs['filters'])
               for n in grouped)
    _, p2, _, _ = build_detector(None, weight_path=path, device=dev)
    same = all(bool((p2[k]['w'] == trainer.params[k]['w']).all()) for k in p2)
    gate(ck['type'] == 'normal' and ck['cfg'] == want_cfg and hwio and same,
         f'(d) {os.path.basename(path)}: type {ck["type"]}, the zoo\'s cfg text, {len(grouped)} '
         'grouped conv weights in HWIO (3, 3, Cin/G, Cout), loaded back strictly and equal')
    return wall


def phase16_timings(dev, tag, servers, models, kernels, ptx):
    """(e): request p50/p90 of each model and mode, the forward on the device
    alone (CUDA graph), bf16 with grouped cuDNN convs against densified,
    each kernel's device ms per forward, MACs grouped against densified."""
    import torch
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    gen = phase_gen(163)
    batch = request_maker(gen, dev)
    with torch.inference_mode():
        x = device_normalize(batch(BATCH)['image'])
    for name, sv in servers.items():
        request_times({f'{name} {m}': v[0] for m, v in sv.items()}, batch, BATCH, tag,
                      'phase 16 (e)', REGNET_TIMED_REQUESTS)
        net, params, state, _ = models[name]
        grouped = bf16_server(net, params, state, dev, densify_groups=False)
        fwd = {'bf16 densified': sv['bf16'][1], 'bf16 grouped (cuDNN)': grouped[1],
               'int8': sv['int8'][1]}
        dms = {k: device_ms(lambda f=f: f(x), iters=3, replays=3) for k, f in fwd.items()}
        cms = {k: cuda_ms(lambda f=f: f(x), iters=5) for k, f in fwd.items()}
        macs, dense = grouped_macs(net.graph, SIZE)
        print(f'phase 16 (e): {tag} {name} B={BATCH} forward on the device alone (CUDA graph): '
              + ', '.join(f'{k} {v:.4f} ms' for k, v in dms.items())
              + '; a call with its launches: '
              + ', '.join(f'{k} {v:.4f} ms' for k, v in cms.items())
              + f'; MACs an image grouped {macs} against densified {dense} ({dense / macs:.3f}x)')
    for name in REGNET_FPN:
        int8_kernel_times(gen, dev, int8_conv_shapes(models[name][3], SIZE), ptx, tag,
                          f'phase 16 (e) {name}')
    yq = int8_conv_shapes(models[REGNET_YOLO][3], SIZE)
    int8_kernel_times(gen, dev, {k: c for k, c in yq.items() if k[0] == 'dw'}, ptx, tag,
                      f'phase 16 (e) {REGNET_YOLO}')
    fused_chain_times(gen, dev, kernels['chains'], ptx, tag, f'phase 16 (e) {REGNET_YOLO}')


def phase16_regnet(dev, tag, tmp, corpus, ptx):
    """Phase 16: the RegNet zoo and grouped convs on the card ((a)-(e),
    module docstring). Raises on any failed gate; returns the kernels'
    errors and the launches of (b)'s main path."""
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.zoo import get_cfg
    t_phase = time.perf_counter()
    fails = []

    def gate(ok, what):
        print(f'phase 16: {what}: {"ok" if ok else "FAIL"}')
        if not ok:
            fails.append(what)

    qnets = {name: DetectionNetwork.from_cfg(get_cfg(name), quant=True)
             for name in REGNET_FPN + (REGNET_YOLO,)}
    t0 = time.perf_counter()
    kernels = phase16_kernels(dev, tag, qnets)
    t1 = time.perf_counter()
    servers, launches, models = phase16_serving(dev, tag, gate)
    t2 = time.perf_counter()
    phase16_train(dev, tag, gate)
    t3 = time.perf_counter()
    phase16_trainer(dev, tag, tmp, corpus, gate)
    t4 = time.perf_counter()
    phase16_timings(dev, tag, servers, models, kernels, ptx)
    print(f'phase 16: {tag} seconds: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, '
          f'(d) {t4 - t3:.1f}, (e) {time.perf_counter() - t4:.1f}; phase '
          f'{time.perf_counter() - t_phase:.1f}')
    if fails:
        raise AssertionError(f'phase 16 gates failed: {fails}')
    return {'int8_err': kernels['int8_err'], 'fused_err': kernels['fused_err'],
            'launches': launches}

# learning, NAS search and hyper-parameter evolution (phase 17): the learning
# tasks of tests/test_learning.py (a); the kernels at the NAS candidates'
# shapes and at the 352x352 eval of the NAS and evolution yamls (b);
# cli.search (c) and cli.evolute (d) on phase 13's clutter corpus

# the port's copy of tests/test_learning.py's net; tests/test_torch_learning.py
# holds it, write_squares and squares_opts to the JAX test's
SQUARES_CFG = """
[net]
channels=3
[convolutional]
filters=16
size=3
pad=1
stride=2
batch_normalize=1
activation=leaky
[convolutional]
filters=24
size=3
pad=1
stride=2
batch_normalize=1
activation=leaky
[convolutional]
filters=32
size=3
pad=1
stride=2
batch_normalize=1
activation=leaky
[convolutional]
filters=18
size=1
pad=1
activation=linear
[yolo]
classes=1
[route]
layers=-3
[convolutional]
filters=48
size=3
pad=1
stride=2
batch_normalize=1
activation=leaky
[convolutional]
filters=18
size=1
pad=1
activation=linear
[yolo]
classes=1
[route]
layers=-3
[convolutional]
filters=48
size=3
pad=1
stride=2
batch_normalize=1
activation=leaky
[convolutional]
filters=18
size=1
pad=1
activation=linear
[yolo]
classes=1
"""
SQUARES_AP50 = 0.5             # tests/test_learning.py:141
PRUNED_SQUARES_AP50 = 0.4      # tests/test_learning.py:213
NAS_SIZES = (352, 512)         # (b): eval.input_size of the NAS and evolution yamls, SIZE
NAS_GAIN = REGNET_GAIN         # (b): seed_bn's weight gain of the RegNet-backbone candidates
CANDIDATE_REQUESTS = 4         # (b): bf16 requests of B=BATCH per model and size
NAS_ROUNDS = 3                 # (c): cli.search --rounds (the yaml's recorded run: 8)
NAS_MAX_MACS = 5e9
NAS_MAX_LATENCY_MS = 1000.0    # (c): every candidate passes (the yaml's 8 ms is a TPU figure)
EVOLUTE_ROUNDS = 2             # (d): cli.evolute --rounds (the yaml's recorded run: 6)
MEMORY_SLACK = 64 << 20        # (c), (d): device bytes a candidate or round may leave behind


def write_squares(root, n=24, size=96, seed=0):
    """tests/test_learning.py's corpus: a VOC-layout directory of ``n`` dark
    ``size`` px images with one bright square each; returns its list file."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'JPEGImages')
    ann_dir = os.path.join(root, 'Annotations')
    os.makedirs(img_dir), os.makedirs(ann_dir)
    paths = []
    for i in range(n):
        img = rng.randint(0, 40, (size, size, 3), np.uint8)
        side = rng.randint(28, 44)
        x1 = rng.randint(0, size - side)
        y1 = rng.randint(0, size - side)
        img[y1:y1 + side, x1:x1 + side] = rng.randint(200, 255, 3)
        p = os.path.join(img_dir, f'sq{i}.jpg')
        cv2.imwrite(p, img)
        xml = (f'<annotation><object><name>square</name>'
               f'<difficult>0</difficult><bndbox><xmin>{x1}</xmin>'
               f'<ymin>{y1}</ymin><xmax>{x1+side}</xmax><ymax>{y1+side}</ymax>'
               f'</bndbox></object></annotation>')
        with open(os.path.join(ann_dir, f'sq{i}.xml'), 'w') as fw:
            fw.write(xml)
        paths.append(p)
    txt = os.path.join(root, 'list.txt')
    with open(txt, 'w') as fw:
        fw.write('\n'.join(paths))
    return txt


def squares_opts(txt, cfg_path, weight_dir):
    """The overrides both tests of tests/test_learning.py share."""
    return ['dataset.train_txt_file', txt, 'dataset.eval_txt_file', txt,
            'dataset.classes', '[square]', 'model.cfg_path', cfg_path,
            'model.anchors', '[[36, 36], [36, 36], [36, 36], [36, 36], [36, 36],'
                             ' [36, 36], [36, 36], [36, 36], [36, 36]]',
            'model.max_gt_boxes', '4', 'train.batch_size', '8', 'train.input_sizes', '[96]',
            'train.learning_rate_init', '3e-3', 'augment.mixup_p', '0.0',
            'augment.crop_p', '0.0', 'eval.batch_size', '8', 'eval.input_size', '96',
            'eval.score_threshold', '0.3', 'eval.max_detections', '16',
            'weight.dir', weight_dir, 'system.num_workers', '4',
            'system.compute_dtype', 'float32']


def _squares_task(root):
    txt = write_squares(root)
    cfg_file = os.path.join(root, 'sq.cfg')
    with open(cfg_file, 'w') as fw:
        fw.write(SQUARES_CFG)
    return squares_opts(txt, cfg_file, os.path.join(root, 'w'))


def learn_squares(root, device='cuda', trainer=None):
    """tests/test_learning.py::test_detector_learns_synthetic_squares through
    the port's Trainer (or ``trainer``, a subclass of it) on ``device``, in the
    new directory ``root``: 14 f32 epochs at 96 px, AP after the last.
    Returns (AP50, the trainer)."""
    from pqdet_tpu_torch.config import load_config
    from pqdet_tpu_torch.train.trainer import Trainer
    cfg = load_config(opts=_squares_task(root) + [
        'train.max_epochs', '14', 'train.warmup_epochs', '1', 'augment.hflip_p', '0.5',
        'eval.after', '13'])
    t = (trainer or Trainer)(cfg, device=device)
    t.run()
    return float(t.AP.raw[0][0]), t


def sparse_prune_finetune(root, device='cuda', trainer=None):
    """tests/test_learning.py::test_sparse_prune_finetune_cycle with the port
    on ``device``, in the new directory ``root``: 12 sparse epochs, a 30 %
    slimming prune, 6 fine-tune epochs from the pruned weights. Returns
    (AP50, params before the prune, after it, the fine-tune's trainer)."""
    from pqdet_tpu_torch.compress.prune import prune_slimming
    from pqdet_tpu_torch.config import load_config
    from pqdet_tpu_torch.model.factory import build_detector
    from pqdet_tpu_torch.model.graph import Graph
    from pqdet_tpu_torch.train.checkpoint import save_checkpoint
    from pqdet_tpu_torch.train.step import tree_leaves
    from pqdet_tpu_torch.train.trainer import Trainer
    trainer = trainer or Trainer
    opts = _squares_task(root)
    cfg = load_config(opts=opts + [
        'train.max_epochs', '12', 'train.warmup_epochs', '1',
        'eval.after', '99', 'sparse.switch', 'true', 'sparse.ratio', '0.005'])
    trainer(cfg, device=device).run()
    ckpt_path = os.path.join(root, 'w', 'VOC', 'model-11.ckpt')

    network, params, state, _ = build_detector(None, weight_path=ckpt_path, device=device)
    result = prune_slimming(network.graph, params, state, prune_ratio=0.3)
    n0 = sum(t.numel() for t in tree_leaves(params))
    n1 = sum(t.numel() for t in tree_leaves(result.params))
    new_cfg = os.path.join(root, 'pruned.cfg')
    with open(new_cfg, 'w') as fw:
        fw.write(result.cfg_text)
    pruned_ckpt = os.path.join(root, 'pruned.ckpt')
    save_checkpoint(pruned_ckpt, Graph.from_cfg(result.cfg_text), result.params,
                    result.state, step=0, cfg_text=result.cfg_text)

    cfg2 = load_config(opts=opts + [
        'train.max_epochs', '6', 'train.warmup_epochs', '0', 'eval.after', '5',
        'train.learning_rate_init', '1e-3',
        'weight.resume', pruned_ckpt, 'weight.clear_history', 'true'])
    cfg2.model.cfg_path = new_cfg
    t2 = trainer(cfg2, device=device)
    t2.run()
    return float(t2.AP.raw[0][0]), n0, n1, t2


def phase17_learning(dev, tag, tmp, gate, host_ips):
    """(a): both tasks of tests/test_learning.py on the card through the
    port's Trainer at the test's sizes, gated on its AP50 floors and phase
    13's trainer gates. Returns the kernel launches."""
    from pqdet_tpu_torch.train.trainer import Trainer
    reset_kernel_launches()
    rec = {}
    t0 = time.perf_counter()
    ap50, _ = learn_squares(os.path.join(tmp, 'squares'), dev, probed_trainer(Trainer, rec))
    s = time.perf_counter() - t0
    launches = kernel_launches()
    gate(ap50 > SQUARES_AP50, f'(a) {tag} the detector learns the squares (24 images, 96 px, '
         f'14 f32 epochs): AP50 {ap50:.4f} (> {SQUARES_AP50}) in {s:.2f} s')
    trainer_gates(rec, '(a) squares', tag, gate, host_ips, [13], phase='phase 17')
    rec = {}
    reset_kernel_launches()
    t0 = time.perf_counter()
    ap50, n0, n1, _ = sparse_prune_finetune(os.path.join(tmp, 'squares_prune'), dev,
                                            probed_trainer(Trainer, rec))
    s = time.perf_counter() - t0
    launches = {k: v + kernel_launches()[k] for k, v in launches.items()}
    gate(n1 < n0 and ap50 > PRUNED_SQUARES_AP50,
         f'(a) {tag} sparse 12 epochs, prune 0.3 ({n0} -> {n1} params), fine-tune 6 epochs: '
         f'AP50 {ap50:.4f} (> {PRUNED_SQUARES_AP50}) in {s:.2f} s')
    trainer_gates(rec, '(a) pruned squares fine-tune', tag, gate, host_ips, [5],
                  phase='phase 17')
    return launches


def decode_parity(gen, dev, heads, nc, label):
    """``decode_heads`` against its plain version on B=BATCH raw heads of
    ``heads`` ((H, stride) each), bf16 and f32, one launch into the preds:
    raw values at scale 2 without and with exp_cap 40, and at scale 30 with
    it (capped box offsets), within ``decode_tolerance``. Raises on a
    disagreement; returns the largest error."""
    import torch
    from pqdet_tpu_torch.ops.decode_kernel import decode_heads, decode_heads_reference
    strides = [st for _, st in heads]
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for scale, cap in ((2.0, 0.0), (2.0, 40.0), (30.0, 40.0)):
            caps = [cap] * len(heads)
            raws = [(torch.randn(BATCH, h, h, 3 * (5 + nc), generator=gen) * scale).to(dev, dt)
                    for h, _ in heads]
            got = decode_heads(raws, nc, strides, caps)
            ref = decode_heads_reference(raws, nc, strides, caps)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            tol = torch.cat([decode_tolerance(r, nc, st, c).flatten(1, 3)
                             for r, st, c in zip(raws, strides, caps)], 1)
            ok = got.shape == ref.shape and bool((err <= tol).all())
            worst = max(worst, err.max().item())
            print(f'{label}: decode_heads B={BATCH} heads {[h for h, _ in heads]} {dt} raw '
                  f'scale {scale} exp_cap {cap}: one launch into {tuple(got.shape)}, max |err| '
                  f'{err.max().item():.3g} {"ok" if ok else "FAIL"}')
            if not ok:
                raise AssertionError(f'{label}: decode kernel disagrees with its plain version')
    return worst


def phase17_kernels(dev, tag, gate, ptx):
    """(b): ``generate_candidates(3, seed=0)`` (20 classes) and
    mobilenetv2-fpn: every fused chain against ``fused_ir_reference`` (phase
    3's tolerance) at B=BATCH and the decode against its plain version, at
    352x352 and 512x512 (mobilenetv2-fpn at 352: B=1 and BATCH); each
    model served in bf16 with seeded weights, CANDIDATE_REQUESTS requests
    at each size, launches per forward from the graph, the walk node by node
    against ``plain=True`` (phase 16 (b)'s gate); the chains' device ms per
    forward. Returns the largest errors and the served launches."""
    import torch
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.nas.search import generate_candidates
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.zoo import get_cfg
    gen = phase_gen(17)
    models = [(f'candidate {k}', cfg, info['head'], NAS_SIZES, NAS_GAIN)
              for k, (cfg, info) in enumerate(generate_candidates(3, seed=0, device=dev))]
    models.append(('mobilenetv2-fpn', get_cfg('mobilenetv2-fpn'), None, NAS_SIZES[:1], 2.0))
    fused_err = 0.0
    timed = {}
    for name, cfg_text, head, sizes, _ in models:
        net = DetectionNetwork.from_cfg(cfg_text)
        for size in sizes:
            chains = chain_shapes(net, size)
            print(f'phase 17 (b): {name} (head {head}) at {size}x{size}: {len(chains)} fused '
                  f'chains, (H, Cin, E, P) {sorted({c[3:7] for c in chains})}')
            if name == 'mobilenetv2-fpn':
                gate(len(chains) == 21, f'(b) mobilenetv2-fpn has 21 chains at {size}')
            if chains:
                batches = (1, BATCH) if name == 'mobilenetv2-fpn' else (BATCH,)
                checks = [(f'{a},{b},{c}', n, h, h, cin, e, p, a is not None, acts, 0.0)
                          for a, b, c, h, cin, e, p, acts in chains for n in batches]
                fused_err = max(fused_err, fused_parity(gen, dev, checks,
                                                        f'phase 17 (b) {name} {size}'))
                timed[(name, size)] = chains
    nc = 20
    decode_err = 0.0
    for size in NAS_SIZES:
        heads = [(size // st, st) for st in (8, 16, 32)]
        decode_err = max(decode_err, decode_parity(gen, dev, heads, nc, f'phase 17 (b) {size}'))

    launches = dict.fromkeys(('decode_heads', 'fused_ir_conv', 'qconv1x1_s8', 'qdwconv3x3_s8'),
                             0)
    for name, cfg_text, head, sizes, gain in models:
        net = DetectionNetwork.from_cfg(cfg_text)
        params, state = net.init(gen, device=dev)
        seed_bn(params, state, gen, dev, gain=gain)
        for size in sizes:
            predict, _, table, fparams = bf16_server(net, params, state, dev, size=size)
            batch = request_maker(gen, dev, size)
            requests = [batch(BATCH) for _ in range(CANDIDATE_REQUESTS)]
            predict(requests[0])                       # warm-up
            torch.cuda.synchronize()
            reset_kernel_launches()
            dets = [predict(r) for r in requests]
            torch.cuda.synchronize()
            got = kernel_launches()
            for k, v in got.items():
                launches[k] += v
            per = {'decode_heads': 1, 'fused_ir_conv': len(table)}
            want = {**dict.fromkeys(got, 0),
                    **{k: n * CANDIDATE_REQUESTS for k, n in per.items()}}
            n_det = sum(len(d) for r in dets for d in r)
            finite = all(d.shape[1] == 6 and bool(torch.isfinite(torch.from_numpy(d)).all())
                         for r in dets for d in r)
            gate(got == want and finite and n_det > 0,
                 f'(b) {name} bf16 at {size}x{size}: {CANDIDATE_REQUESTS} requests of B={BATCH}, '
                 f'launches {got} (want {want}: per forward {per}); {n_det} detections, all '
                 'finite')
            with torch.inference_mode():
                x = device_normalize(requests[0]['image'])
            n, n_eq, n_before, n_before_eq, ds, db = bf16_node_parity(net, fparams, table, x)
            gate(n_before_eq == n_before and ds <= 0.03 and db <= 1.5,
                 f'(b) {name} bf16 at {size} against plain=True: {n_eq} of {n} tapped nodes '
                 f'equal bit for bit, {n_before_eq} of the {n_before} before the first fused '
                 f'chain (want all); preds scores max |d| {ds:.4g} (<= 0.03), boxes {db:.4g} px '
                 '(<= 1.5)')
    times = {}
    for (name, size), chains in timed.items():
        times[(name, size)] = fused_chain_times(gen, dev, chains, ptx, tag,
                                                f'phase 17 (b) {name} {size}')
    return {'fused_err': fused_err, 'decode_err': decode_err, 'launches': launches,
            'times': times}


def memo_bytes():
    """Device bytes of the trainer's device corpus memo."""
    import torch
    from pqdet_tpu_torch.train.trainer import Trainer
    return sum(v.numel() * v.element_size() for hit in Trainer._CACHE_MEMO.values()
               for v in hit.values() if torch.is_tensor(v))


def memory_probe(Trainer, probes):
    """``Trainer`` whose construction opens a record in ``probes`` (the card's
    allocated bytes and the corpus memo's after a collection, the clock) and
    whose epochs and evals record their seconds and kernel launches;
    ``probed_free`` closes the record when the driver has freed what the
    candidate or round held. Holds no tensor."""
    import gc
    import torch

    def since(before):
        return {k: v - before[k] for k, v in kernel_launches().items()}

    class Probe(Trainer):
        def __init__(self, *args, **kwargs):
            gc.collect()
            torch.cuda.synchronize()
            probes.append({'before': torch.cuda.memory_allocated(), 'memo_before': memo_bytes(),
                           't0': time.perf_counter(), 'epochs': {}, 'evals': {}})
            super().__init__(*args, **kwargs)

        def train_epoch(self, epoch):
            l0, t0 = kernel_launches(), time.perf_counter()
            try:
                return super().train_epoch(epoch)
            finally:
                probes[-1]['epochs'][epoch] = {'s': time.perf_counter() - t0,
                                               'launches': since(l0),
                                               'steps': self.steps_per_epoch}

        def evaluate(self):
            l0, t0 = kernel_launches(), time.perf_counter()
            ap = super().evaluate()
            probes[-1]['evals'][len(probes[-1]['evals'])] = {
                's': time.perf_counter() - t0, 'AP': ap.AP, 'launches': since(l0),
                'batches': len(self.eval_data)}
            return ap
    return Probe


def probed_free(free, probes):
    """The drivers' ``free_device_memory``, then the card's allocated bytes,
    the memo's and the seconds since the record opened, into the last
    record of ``probes``."""
    import torch

    def wrapped(device):
        free(device)
        torch.cuda.synchronize()
        rec = probes[-1]
        rec.update(after=torch.cuda.memory_allocated(), memo_after=memo_bytes(),
                   s=time.perf_counter() - rec['t0'])
    return wrapped


def probe_gates(probes, label, gate, per_batch):
    """Each record of ``probes``: device memory back within MEMORY_SLACK of
    its level before, apart from the corpus memo's change; 0 launches in its
    epochs; ``per_batch`` launches per eval batch and no other kernel.
    Returns the launches the records' evals want in all."""
    want = {}
    for i, r in enumerate(probes):
        left = r['after'] - r['before'] - (r['memo_after'] - r['memo_before'])
        gate(abs(left) <= MEMORY_SLACK,
             f'{label} {i}: device memory {r["before"] / 2**20:.1f} MiB before, '
             f'{r["after"] / 2**20:.1f} MiB after (corpus memo {r["memo_before"] / 2**20:.1f} '
             f'-> {r["memo_after"] / 2**20:.1f} MiB): {left / 2**20:.2f} MiB left behind '
             f'(within {MEMORY_SLACK >> 20} MiB)')
        gate(all(not any(ep['launches'].values()) for ep in r['epochs'].values()),
             f'{label} {i}: hand-written kernel launches in the steps of epochs '
             f'{sorted(r["epochs"])}: 0')
        for ev in r['evals'].values():
            w = {**dict.fromkeys(ev['launches'], 0),
                 **{k: n * ev['batches'] for k, n in per_batch.items()}}
            gate(ev['launches'] == w, f'{label} {i}: eval of {ev["batches"]} batches launched '
                 f'{ev["launches"]} (want {w})')
            for k, n in w.items():
                want[k] = want.get(k, 0) + n
    return want


def phase17_nas(dev, tag, tmp, croot, gate):
    """(c): ``python -m pqdet_tpu_torch.cli.search`` in this process on
    yamls/nas_clutter.yaml (the corpus paths and weight.dir overridden),
    NAS_ROUNDS candidates of seed 0 under NAS_MAX_MACS and NAS_MAX_LATENCY_MS.
    Gates: the log's records and keys; every completed AP in [0, 1]; every
    diverged record a NaN loss (any other error, a kernel's or the port's,
    fails); at least one completed; device memory back after each candidate;
    the launches: ``measure_latency``'s forwards and the evals, one decode
    each. Returns the launches."""
    import inspect
    import torch
    import pqdet_tpu_torch.cli.search as cli_search
    import pqdet_tpu_torch.nas.search as search_mod
    import pqdet_tpu_torch.train.trainer as trainer_mod
    here = os.path.dirname(os.path.abspath(__file__))
    log = os.path.join(tmp, 'nas_search.json')
    probes = []
    saved = trainer_mod.Trainer, search_mod.free_device_memory
    trainer_mod.Trainer._CACHE_MEMO.clear()       # candidate 0 builds the corpus
    search_mod.free_device_memory(dev)
    trainer_mod.Trainer = memory_probe(saved[0], probes)
    search_mod.free_device_memory = probed_free(saved[1], probes)
    try:
        records, _, wall, launches = run_cli(cli_search.main, [
            '--yaml', os.path.join(here, 'yamls', 'nas_clutter.yaml'),
            '--rounds', str(NAS_ROUNDS), '--seed', '0', '--max-macs', str(NAS_MAX_MACS),
            '--max-latency-ms', str(NAS_MAX_LATENCY_MS), '--log', log,
            'dataset.train_txt_file', os.path.join(croot, 'train.txt'),
            'dataset.eval_txt_file', os.path.join(croot, 'test.txt'),
            'weight.dir', os.path.join(tmp, 'weights_nas')])
    finally:
        trainer_mod.Trainer, search_mod.free_device_memory = saved
    with open(log) as fr:
        logged = json.load(fr)
    print(f'phase 17 (c): {tag} cli.search yamls/nas_clutter.yaml --rounds {NAS_ROUNDS} '
          f'--seed 0: {wall:.2f} s; meta {logged["meta"]}')
    data = logged['data']
    base = {'cfg', 'macs', 'params', 'head', 'latency_ms', 'status', 'ap'}
    for i, r in enumerate(data):
        pr = probes[i] if i < len(probes) else {}
        print(f'phase 17 (c): {tag} candidate {i}: head {r["head"]}, MACs {r["macs"]}, params '
              f'{r["params"]}, measure_latency p50 {r["latency_ms"]:.4f} ms (B=1, 512x512, '
              f'f32); {r["status"]}, AP {r["ap"]}, step of death {r.get("step_of_death")}, '
              f'{pr.get("s", float("nan")):.2f} s; epochs '
              + ', '.join(f'{e}: {ep["s"]:.2f} s, {ep["steps"]} steps'
                          for e, ep in sorted(pr.get('epochs', {}).items()))
              + ''.join(f'; eval {ev["s"]:.2f} s, {ev["batches"]} batches'
                        for ev in pr.get('evals', {}).values())
              + (f'; error {r["error"][:200]!r}' if 'error' in r else ''))
    gate(len(data) == NAS_ROUNDS and data == records and all(
        set(r) == (base if r['status'] == 'completed'
                   else base | {'step_of_death', 'error'}) for r in data),
         f'(c) the log holds {len(data)} records (want {NAS_ROUNDS}) with JAX\'s keys')
    done = [r for r in data if r['status'] == 'completed']
    gate(all(0.0 <= r['ap'] <= 1.0 for r in done), '(c) every completed AP in [0, 1]')
    gate(all(r['status'] == 'completed' or (
        r['status'] == 'diverged' and 'NaN in loss near step' in r['error']) for r in data),
         '(c) every diverged record is a NaN loss (no other error)')
    gate(len(done) >= 1, f'(c) {len(done)} of {len(data)} candidates completed (want >= 1)')
    gate(len(probes) == len(data) and all('after' in r for r in probes),
         f'(c) {len(probes)} trainers probed, each closed by the driver')
    want = probe_gates(probes, '(c) candidate', gate, {'decode_heads': 1})
    from pqdet_tpu_torch.utils.profiling import forward_latency_ms
    params = inspect.signature(forward_latency_ms).parameters
    calls = params['warmup'].default + params['iters'].default
    want['decode_heads'] = want.get('decode_heads', 0) + calls * len(data)
    want = {**dict.fromkeys(launches, 0), **want}
    gate(launches == want, f'(c) launches {launches} (want {want}: {calls} measure_latency '
         'forwards a candidate and one decode per eval batch)')
    return launches


def phase17_evolute(dev, tag, tmp, croot, gate):
    """(d): ``python -m pqdet_tpu_torch.cli.evolute`` in this process on
    yamls/evolute_clutter.yaml (mobilenetv2-fpn, the device corpus and
    device augmentation; the corpus paths and weight.dir overridden),
    EVOLUTE_ROUNDS rounds of seed 0. Gates: every round recorded (none
    dropped) with distinct hypers and fitness in [0, 1]; device memory back
    after each round; one decode per eval batch and no other launch.
    Returns the launches."""
    import pqdet_tpu_torch.cli.evolute as cli_evolute
    import pqdet_tpu_torch.nas.evolute as evolute_mod
    here = os.path.dirname(os.path.abspath(__file__))
    log = os.path.join(tmp, 'evolution.json')
    probes = []
    saved = evolute_mod.Trainer, evolute_mod.free_device_memory
    evolute_mod.Trainer = memory_probe(saved[0], probes)
    evolute_mod.free_device_memory = probed_free(saved[1], probes)
    try:
        records, _, wall, launches = run_cli(cli_evolute.main, [
            '--yaml', os.path.join(here, 'yamls', 'evolute_clutter.yaml'),
            '--rounds', str(EVOLUTE_ROUNDS), '--seed', '0', '--log', log,
            'dataset.train_txt_file', os.path.join(croot, 'train.txt'),
            'dataset.eval_txt_file', os.path.join(croot, 'test.txt'),
            'weight.dir', os.path.join(tmp, 'weights_evolute')])
    finally:
        evolute_mod.Trainer, evolute_mod.free_device_memory = saved
    with open(log) as fr:
        logged = json.load(fr)
    print(f'phase 17 (d): {tag} cli.evolute yamls/evolute_clutter.yaml --rounds '
          f'{EVOLUTE_ROUNDS} --seed 0: {wall:.2f} s; exit {logged["exit"]}')
    for i, r in enumerate(logged['data']):
        pr = probes[i] if i < len(probes) else {}
        print(f'phase 17 (d): {tag} round {i}: fitness {r["fitness"]:.6f}, {pr.get("s", 0):.2f} '
              f's (epoch ' + ', '.join(f'{ep["s"]:.2f} s, {ep["steps"]} steps'
                                      for ep in pr.get('epochs', {}).values())
              + ''.join(f'; eval {ev["s"]:.2f} s, {ev["batches"]} batches'
                        for ev in pr.get('evals', {}).values())
              + f'); telemetry {r["telemetry"]}; hypers '
              + json.dumps({k: round(v, 4) for k, v in r['hyper'].items()}))
    data = logged['data']
    gate(len(data) == EVOLUTE_ROUNDS and data == records and logged['exit'] == {
        'status': 'completed', 'completed_rounds': EVOLUTE_ROUNDS,
        'target_rounds': EVOLUTE_ROUNDS},
         f'(d) {len(data)} rounds recorded of {EVOLUTE_ROUNDS}, none dropped')
    gate(len({json.dumps(r['hyper'], sort_keys=True) for r in data}) == len(data)
         and all(0.0 <= r['fitness'] <= 1.0 for r in data),
         '(d) distinct hypers, every fitness in [0, 1]')
    gate(len(probes) == len(data) and all('after' in r for r in probes)
         and all(abs(r['telemetry']['cuda_allocated'] - p['after']) <= 1 << 20
                 for r, p in zip(data, probes)),
         f'(d) {len(probes)} trainers probed, each closed by the driver; the telemetry\'s '
         'cuda_allocated is the level after each round (within 1 MiB)')
    want = probe_gates(probes, '(d) round', gate, {'decode_heads': 1})
    want = {**dict.fromkeys(launches, 0), **want}
    gate(launches == want, f'(d) launches {launches} (want {want}: one decode per eval batch; '
         'the trainer\'s eval runs the layer walk, no fused chain, as JAX\'s does)')
    return launches


def phase17_nas_evolution(dev, tag, tmp, corpus, croot, ptx):
    """Phase 17: learning, the kernels at the NAS shapes, NAS search and
    evolution on the card ((a)-(d), module docstring). Raises on any failed
    gate; returns the kernels' errors and the launches of its main paths."""
    t_phase = time.perf_counter()
    fails = []

    def gate(ok, what):
        print(f'phase 17: {what}: {"ok" if ok else "FAIL"}')
        if not ok:
            fails.append(what)

    print(f'phase 17: cuts: (a) the learning tasks at tests/test_learning.py\'s sizes (the full '
          f'30-epoch yamls/shapes.yaml run is not made here); (c), (d) phase 13\'s '
          f'{CLUTTER_IMAGES}-image synth_clutter corpus at {AUG_SIZE} px for the yamls\' '
          f'/tmp/clutter8k (8k images); cli.search --rounds {NAS_ROUNDS} (the yaml\'s recorded '
          f'run 8), --max-latency-ms {NAS_MAX_LATENCY_MS} (the yaml\'s 8 ms is a TPU figure); '
          f'cli.evolute --rounds {EVOLUTE_ROUNDS} (its recorded run 6)')
    if not os.path.isfile(os.path.join(croot, 'train.txt')):
        raise AssertionError(f'phase 17: no clutter corpus at {croot}')
    host_ips = statistics.mean(e['steps'] * corpus['batch'] / e['s']
                               for i, e in corpus['host_epochs'].items() if i > 0)
    t0 = time.perf_counter()
    learned = phase17_learning(dev, tag, tmp, gate, host_ips)
    t1 = time.perf_counter()
    kernels = phase17_kernels(dev, tag, gate, ptx)
    t2 = time.perf_counter()
    nas = phase17_nas(dev, tag, tmp, croot, gate)
    t3 = time.perf_counter()
    evo = phase17_evolute(dev, tag, tmp, croot, gate)
    t4 = time.perf_counter()
    launches = {k: learned[k] + kernels['launches'][k] + nas[k] + evo[k] for k in learned}
    for (name, size), t in kernels['times'].items():
        print(f'phase 17: {tag} fused_ir_conv {name} at {size}x{size} B={BATCH} per forward: '
              f'{t["ms"]:.4f} ms (plain {t["plain_ms"]:.4f}, cuDNN x3 {t["library_ms"]:.4f}, '
              f'bound {t["bound_ms"]:.5f} ms by {t["bound_by"]})')
    print(f'phase 17: {tag} launches of its main paths {launches}; seconds: (a) {t1 - t0:.1f}, '
          f'(b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}; phase '
          f'{time.perf_counter() - t_phase:.1f}')
    if fails:
        raise AssertionError(f'phase 17 gates failed: {fails}')
    return {'fused_err': kernels['fused_err'], 'decode_err': kernels['decode_err'],
            'launches': launches}


# VisDrone2019-DET's image sizes (w, h), the largest first
VISDRONE_SIZES = ((2000, 1500), (1920, 1080), (1360, 765), (960, 540))
VISDRONE_SETS = ('VisDrone2019-DET-train', 'VisDrone2019-DET-val', 'VisDrone2019-DET-test')
COCO_SIZES = ((640, 480), (480, 640), (640, 427), (500, 375))


def synth_scene(rng, w, h, boxes, colors):
    """A smooth RGB background (a gradient and upsampled noise, so the JPEG
    stays small) with a filled rectangle for each (x, y, w, h, class) box."""
    import cv2
    import numpy as np
    noise = cv2.resize(rng.randint(0, 120, (6, 8, 3)).astype(np.uint8), (w, h),
                       interpolation=cv2.INTER_LINEAR)
    ramp = np.linspace(0, 60, w, dtype=np.float32)[None, :, None]
    img = np.clip(noise + ramp, 0, 255).astype(np.uint8)
    for x, y, bw, bh, c in boxes:
        cv2.rectangle(img, (int(x), int(y)), (int(x + bw - 1), int(y + bh - 1)),
                      colors[int(c)], -1)
    return img


def write_visdrone(root, sizes=VISDRONE_SIZES, per_size=2, seed=SEED, boxes=(20, 300)):
    """A seeded corpus in VisDrone2019-DET's layout under ``root``: for each
    (w, h) of ``sizes``, ``per_size`` images split over the train and val
    sets and one test image, each with ``boxes`` (lo, hi) annotated boxes
    as VisDrone writes them, ``x,y,w,h,score,category,truncation,
    occlusion`` over categories 0-11 (0 ignored regions, 11 others), score 0
    on about one in ten. Returns the number of boxes written."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    colors = [tuple(int(v) for v in rng.randint(60, 256, 3)) for _ in range(12)]
    for s in VISDRONE_SETS:
        for sub in ('images', 'annotations'):
            os.makedirs(os.path.join(root, s, sub), exist_ok=True)
    n_boxes = 0
    for k, (w, h) in enumerate(sizes):
        for j in range(per_size + 1):
            s = VISDRONE_SETS[2] if j == per_size else VISDRONE_SETS[j % 2]
            n = rng.randint(boxes[0], boxes[1] + 1)
            bw = rng.randint(max(2, w // 200), max(3, w // 12), n)
            bh = rng.randint(max(2, h // 200), max(3, h // 8), n)
            x = rng.randint(0, w - bw)
            y = rng.randint(0, h - bh)
            cat = rng.randint(0, 12, n)
            score = (rng.rand(n) > 0.1).astype(int)
            trunc, occ = rng.randint(0, 3, n), rng.randint(0, 3, n)
            stem = f'{k:02d}_{j:02d}_{w}x{h}'
            cv2.imwrite(os.path.join(root, s, 'images', stem + '.jpg'),
                        synth_scene(rng, w, h, zip(x, y, bw, bh, cat), colors))
            with open(os.path.join(root, s, 'annotations', stem + '.txt'), 'w') as fw:
                fw.write(''.join(f'{a},{b},{c},{d},{e},{f},{g},{o}\n' for a, b, c, d, e, f, g, o
                                 in zip(x, y, bw, bh, score, cat, trunc, occ)))
            n_boxes += n
    return n_boxes


def write_coco(root, n_train, n_val, seed=SEED, classes=80, boxes=(1, 15)):
    """A seeded corpus in COCO's darknet layout under ``root``: ``images/``
    and ``labels/`` (one ``class cx cy w h`` line a box, normalized), at
    COCO's common sizes, ``train.txt`` and ``val.txt`` listing the images.
    Returns the two list files."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    colors = [tuple(int(v) for v in rng.randint(60, 256, 3)) for _ in range(classes)]
    for sub in ('images', 'labels'):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lists = {'train': [], 'val': []}
    for i in range(n_train + n_val):
        w, h = COCO_SIZES[rng.randint(len(COCO_SIZES))]
        n = rng.randint(boxes[0], boxes[1] + 1)
        bw = rng.randint(w // 16, w // 2, n)
        bh = rng.randint(h // 16, h // 2, n)
        x = rng.randint(0, w - bw)
        y = rng.randint(0, h - bh)
        cls = rng.randint(0, classes, n)
        path = os.path.join(root, 'images', f'{i:06d}.jpg')
        cv2.imwrite(path, synth_scene(rng, w, h, zip(x, y, bw, bh, cls), colors))
        with open(os.path.join(root, 'labels', f'{i:06d}.txt'), 'w') as fw:
            fw.write(''.join(f'{c} {(a + bw_ / 2) / w:.6f} {(b + bh_ / 2) / h:.6f} '
                             f'{bw_ / w:.6f} {bh_ / h:.6f}\n'
                             for c, a, b, bw_, bh_ in zip(cls, x, y, bw, bh)))
        lists['train' if i < n_train else 'val'].append(path)
    out = {}
    for k, paths in lists.items():
        out[k] = os.path.join(root, f'{k}.txt')
        with open(out[k], 'w') as fw:
            fw.write('\n'.join(paths) + '\n')
    return out


# the space-to-depth stem, the rest of the host data and the playground
# (phase 18): the stem folded for serving (a) and training (b), VisDrone
# (c) and COCO (d) as shipped, host labels, the process loader and the
# upload thread (e), the playground (f)
S2D = 2                        # (a), (b): eval.s2d_stem and train.s2d_stem
S2D_REQUESTS = 8               # (a): requests of each B, launches counted
S2D_TIMED_STEPS = 10           # (b): bf16 steps of each mode at B=12, TRAIN_SIZE, in turns ...
S2D_TIMED_WARMUP = 3           # ... the first ones out of the p50
S2D_STEM_TOL = 1e-5            # (a): the folded stem against the stem, f32 (tests/test_s2d.py)
S2D_GRAD_RTOL, S2D_GRAD_ATOL = 1e-4, 1e-6   # (b): the stem kernel's grad (tests/test_s2d.py)
VISDRONE_PER_SIZE = 3          # (c): train and val images of each VisDrone size (+1 test)
VISDRONE_TRAIN_SIZE = 416      # (c): train.input_sizes (one size: each new one pays a first step)
VISDRONE_TIMED = ((1888, 2528),)  # (c): qconv1x1_s8 timed at this eval input (the largest)
COCO_TRAIN, COCO_VAL = 64, 32  # (d): 2 steps of the yaml's batch 32, one eval batch of 32
COCO_SIZE = 512                # (d): train.input_sizes and eval.input_size
LOADER_BATCHES = 2             # (e): first batches held against the thread loader's
OUTPUT_DIR = 'chiprun_out'     # (f): the checkout's git-ignored directory for a run's files


def phase18_s2d_serving(dev, tag, gate, net, params, state):
    """(a): phase 4's mobilenetv2-fpn and weights through make_batch_predict
    with ``eval.s2d_stem`` S2D (bf16, the fused-IR table), S2D_REQUESTS
    requests at B=1 and B=BATCH: 21 fused_ir_conv + 1 decode_heads per
    forward, the walk node by node against plain=True (bit for bit before
    the first chain), the preds against ``s2d_stem`` 0's within phase 4's
    bounds; the chains and the decode against their plain versions at the
    path's shapes (phases 3 and 2's checks); the folded stem against the
    stem in f32. Timings: request p50/p90 with and without the fold, the
    forward on the device alone (CUDA graph) and the stem's device ms."""
    import torch
    from pqdet_tpu_torch.config import Config
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    from pqdet_tpu_torch.model import layers as L
    from pqdet_tpu_torch.model.graph import solve_padding
    from pqdet_tpu_torch.model.network import cast_params, fuse_params, s2d_stem_input
    from pqdet_tpu_torch.ops.fused_ir import prepare_fused_ir
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    gen = phase_gen(18)
    bf16 = torch.bfloat16
    fused = fuse_params(net, params, state)
    table = prepare_fused_ir(net, fused)
    fparams = cast_params(fused, bf16)
    predicts = {}
    for s2d in (0, S2D):
        cfg = Config()
        cfg.eval.input_size, cfg.eval.fused_ir, cfg.eval.s2d_stem = SIZE, True, s2d
        run = build_predict_pipeline(net, cfg, compute_dtype=bf16, fused_ir=table, device=dev)
        predicts[s2d] = make_batch_predict(run, fparams)
    batch = request_maker(gen, dev)
    launches = dict.fromkeys(('decode_heads', 'fused_ir_conv', 'qconv1x1_s8', 'qdwconv3x3_s8'),
                             0)
    for b in (1, BATCH):
        requests = [batch(b) for _ in range(S2D_REQUESTS)]
        predicts[S2D](requests[0])                    # warm-up
        torch.cuda.synchronize()
        reset_kernel_launches()
        dets = [predicts[S2D](r) for r in requests]
        torch.cuda.synchronize()
        got = kernel_launches()
        for k, v in got.items():
            launches[k] += v
        want = {**dict.fromkeys(got, 0), 'fused_ir_conv': 21 * S2D_REQUESTS,
                'decode_heads': S2D_REQUESTS}
        gate(got == want, f'(a) s2d_stem {S2D}, {S2D_REQUESTS} requests of B={b}: launches '
             f'{got} (want {want}: 21 chains and 1 decode per forward)')
        n_det = sum(len(d) for r in dets for d in r)
        gate(n_det > 0 and all(d.shape[1] == 6 and bool(torch.isfinite(torch.from_numpy(d)).all())
                               for r in dets for d in r),
             f'(a) B={b}: {n_det} detections, all finite')
        with torch.inference_mode():
            x = device_normalize(requests[0]['image'])
            p2 = net(fparams, {}, x, compute_dtype=bf16, fused_ir=table, s2d_stem=S2D)
            p0 = net(fparams, {}, x, compute_dtype=bf16, fused_ir=table)
        ds = (p2[..., 4:] - p0[..., 4:]).abs().max().item()
        db = (p2[..., :4] - p0[..., :4]).abs().max().item()
        gate(ds <= 0.03 and db <= 1.5, f'(a) B={b} preds with s2d_stem {S2D} against s2d_stem 0: '
             f'scores max |d| {ds:.4g} (<= 0.03), boxes {db:.4g} px (<= 1.5)')
        n, n_eq, n_before, n_before_eq, ds, db = bf16_node_parity(net, fparams, table, x,
                                                                  s2d_stem=S2D)
        gate(n_before_eq == n_before and ds <= 0.03 and db <= 1.5,
             f'(a) B={b} s2d walk against plain=True: {n_eq} of {n} tapped nodes equal bit for '
             f'bit, {n_before_eq} of the {n_before} before the first fused chain (want all); '
             f'preds scores max |d| {ds:.4g} (<= 0.03), boxes {db:.4g} px (<= 1.5)')
    chains = chain_shapes(net, SIZE)
    checks = [(f'{a},{b},{c}', n, h, h, cin, e, p, a is not None, acts, 0.0)
              for a, b, c, h, cin, e, p, acts in chains for n in (1, BATCH)]
    fused_err = fused_parity(gen, dev, checks, 'phase 18 (a)')
    heads = [(SIZE // y.attrs['stride'], y.attrs['stride']) for y in net.graph.yolo_nodes]
    decode_err = decode_parity(gen, dev, heads, net.num_classes, 'phase 18 (a)')

    stem = net.graph.nodes[0].attrs
    pad = solve_padding(stem['size'], stem['padding'], stem['pad'])
    w0, b0 = fused['0']['w'], fused['0']['b']
    xb = device_normalize(batch(BATCH)['image'])
    with torch.inference_mode():
        ref = L.conv2d(xb, w0, b0, stride=stem['stride'], padding=pad)
        xs, wf, st, pd = s2d_stem_input(xb, w0, S2D, stem['stride'], pad)
        got = L.conv2d(xs, wf, b0, stride=st, padding=pd)
    err = (got - ref).abs()
    gate(got.shape == ref.shape and bool((err <= S2D_STEM_TOL * (1 + ref.abs())).all()),
         f'(a) the folded stem ({tuple(wf.shape)} OIHW on {tuple(xs.shape)}) against the stem '
         f'({tuple(w0.shape)} at stride {stem["stride"]}) on B={BATCH} {SIZE}x{SIZE}, f32, TF32 '
         f'off: max |d| {err.max().item():.3g} (<= {S2D_STEM_TOL:g} (1 + |y|))')

    times = request_times({'s2d_stem 0': predicts[0], f's2d_stem {S2D}': predicts[S2D]}, batch,
                          BATCH, tag, 'phase 18 (a)')
    with torch.inference_mode():
        fwd = {s2d: device_ms(lambda s2d=s2d: net(fparams, {}, xb, compute_dtype=bf16,
                                                  fused_ir=table, s2d_stem=s2d),
                              iters=3, replays=3) for s2d in (0, S2D)}
        wb, bb = fparams['0']['w'], fparams['0']['b']
        stem_ms = {0: device_ms(lambda: L.conv2d(xb, wb, bb, stride=stem['stride'],
                                                 padding=pad, compute_dtype=bf16)),
                   S2D: device_ms(lambda: L.conv2d(*s2d_stem_input(xb, wb, S2D, stem['stride'],
                                                                   pad)[:2], bb, stride=1,
                                                   compute_dtype=bf16))}
    print(f'phase 18 (a): {tag} B={BATCH} {SIZE}x{SIZE} bf16 forward on the device alone (CUDA '
          f'graph): s2d_stem 0 {fwd[0]:.4f} ms, s2d_stem {S2D} {fwd[S2D]:.4f} ms (ratio '
          f'{fwd[S2D] / fwd[0]:.4f}); the stem alone (device ms): conv 3x3 s2 on 3 channels '
          f'{stem_ms[0]:.4f} ms, s2d reshape + pad + conv 2x2 s1 on 12 channels '
          f'{stem_ms[S2D]:.4f} ms')
    return {'launches': launches, 'fused_err': fused_err, 'decode_err': decode_err,
            'fwd_ms': fwd, 'stem_ms': stem_ms, 'requests': times}


def phase18_s2d_train(dev, tag, gate):
    """(b): the mobilenetv2-fpn train step with ``train.s2d_stem`` S2D
    (phase 9's weights and config): card against CPU at
    PARITY_RUNNING_SIZE with running and batch statistics (phase 9's
    check), the grad of the original stem kernel against ``s2d_stem`` 0's on
    the card, then S2D_TIMED_STEPS bf16 steps of each at B=12, TRAIN_SIZE in
    turns (ms p50)."""
    import copy
    import torch
    from pqdet_tpu_torch.model.network import DetectionNetwork, to_device
    from pqdet_tpu_torch.train.step import train_step_from_config
    from pqdet_tpu_torch.zoo import get_cfg
    gen = phase_gen(9)
    cfg = train_config()
    cfg.train.s2d_stem = S2D
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'))
    params, state = net.init(gen, device='cpu')
    reset_kernel_launches()
    t0 = time.perf_counter()
    phase9_parity(net, params, state, gen, dev, cfg, label='phase 18 (b)',
                  cases=((False, PARITY_RUNNING_SIZE), (True, PARITY_RUNNING_SIZE)),
                  s2d_stem=S2D)
    tb = train_batch(gen, PARITY_BATCH, PARITY_RUNNING_SIZE, torch.device('cpu'),
                     cfg.model.max_gt_boxes)
    g = {s2d: grad_step_parts(net, params, state, tb, dev, cfg, False, s2d)['grads']['0']['w']
         for s2d in (0, S2D)}
    err = (g[S2D] - g[0]).abs()
    gate(bool((err <= S2D_GRAD_ATOL + S2D_GRAD_RTOL * g[0].abs()).all()),
         f'(b) the grad of the original stem kernel {tuple(g[0].shape)} through the fold against '
         f's2d_stem 0\'s, on the card, f32, B={PARITY_BATCH} {PARITY_RUNNING_SIZE}x'
         f'{PARITY_RUNNING_SIZE}: max |d| {err.max().item():.3g} (<= {S2D_GRAD_ATOL:g} + '
         f'{S2D_GRAD_RTOL:g} |g|, max |g| {g[0].abs().max().item():.3g})')
    print(f'phase 18 (b): {tag} parity and grads {time.perf_counter() - t0:.1f} s')

    steps, p, s, o = {}, {}, {}, {}
    for s2d in (0, S2D):
        c = copy.deepcopy(cfg)
        c.train.s2d_stem = s2d
        steps[s2d], opt = train_step_from_config(net, c, TRAIN_WARMUP, device=dev)
        p[s2d], s[s2d] = to_device(params, dev), to_device(state, dev)
        o[s2d] = opt.init(p[s2d])
    batch = train_batch(gen, cfg.train.batch_size, TRAIN_SIZE, dev, cfg.model.max_gt_boxes)
    ms, losses = {0: [], S2D: []}, {0: [], S2D: []}
    for k in range(S2D_TIMED_STEPS):
        for s2d in ((0, S2D) if k % 2 == 0 else (S2D, 0)):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            p[s2d], s[s2d], o[s2d], m = steps[s2d](p[s2d], s[s2d], o[s2d], batch)
            e1.record()
            e1.synchronize()
            ms[s2d].append(e0.elapsed_time(e1))
            losses[s2d].append(float(m['loss']))
    p50 = {k: statistics.median(v[S2D_TIMED_WARMUP:]) for k, v in ms.items()}
    gate(all(math.isfinite(x) for v in losses.values() for x in v)
         and statistics.mean(losses[S2D][-3:]) < statistics.mean(losses[S2D][:3]),
         f'(b) {S2D_TIMED_STEPS} bf16 steps with s2d_stem {S2D} at B={cfg.train.batch_size} '
         f'{TRAIN_SIZE}x{TRAIN_SIZE} on one batch: losses {[round(x, 3) for x in losses[S2D]]} '
         f'finite and falling (s2d_stem 0: {[round(x, 3) for x in losses[0]]})')
    launches = kernel_launches()
    gate(not any(launches.values()), f'(b) hand-written kernel launches in the steps: '
         f'{launches} (want 0)')
    print(f'phase 18 (b): {tag} bf16 step B={cfg.train.batch_size} {TRAIN_SIZE}x{TRAIN_SIZE}, '
          f'p50 after {S2D_TIMED_WARMUP} (CUDA events, in turns): s2d_stem 0 {p50[0]:.3f} ms, '
          f's2d_stem {S2D} {p50[S2D]:.3f} ms (ratio {p50[S2D] / p50[0]:.4f})')
    return p50


def eval_shapes(eval_data):
    """The distinct (H, W) of the eval batches' images and the images at each."""
    shapes = {}
    for i in range(len(eval_data)):
        hw = eval_data.batch(i)['image'].shape[1:3]
        shapes[hw] = shapes.get(hw, 0) + 1
    return shapes


def yaml_copy(tmp, name, **changes):
    """A copy of yamls/<name>.yaml in ``tmp`` with ``changes`` ({group:
    {key: value}}) merged in; returns its path."""
    import yaml
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, 'yamls', name)) as fr:
        y = yaml.safe_load(fr)
    for group, kv in changes.items():
        y.setdefault(group, {}).update(kv)
    path = os.path.join(tmp, name)
    with open(path, 'w') as fw:
        yaml.safe_dump(y, fw)
    return path


def phase18_visdrone(dev, tag, tmp, gate, ptx, host_ips):
    """(c): VisDrone as shipped. A seeded corpus in VisDrone2019-DET's
    layout at its four resolutions (write_visdrone), ``visdrone_txt --seed
    0``, one epoch of ``cli.train`` on yamls/visdrone.yaml (regnetx-600m-fpn,
    batch 30, max_gt_boxes 256, the eval at batch 1 in per-image sizes after
    it), then the trained checkpoint's int8 route (observers, convert,
    Int8Inference kernel mode) at each eval image, B=1, conv by conv against
    plain=True; the decode against its plain version at each eval shape;
    the decode's and qconv1x1_s8's device ms at those shapes."""
    import torch
    from pqdet_tpu_torch.compress.quantized import Int8Inference
    from pqdet_tpu_torch.config import load_config
    from pqdet_tpu_torch.data.eval_data import EvalData
    from pqdet_tpu_torch.data.scripts import visdrone_txt
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.decode_kernel import decode_heads, decode_heads_reference
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    gen = phase_gen(183)
    root = os.path.join(tmp, 'visdrone')
    t0 = time.perf_counter()
    n_boxes = write_visdrone(root, per_size=VISDRONE_PER_SIZE)
    visdrone_txt.main(['--root', root, '--seed', '0'])
    train_txt, test_txt = os.path.join(root, 'trainval.txt'), os.path.join(root, 'test.txt')
    with open(train_txt) as fr:
        n_train = sum(1 for line in fr if line.strip())
    print(f'phase 18 (c): wrote {len(VISDRONE_SIZES) * (VISDRONE_PER_SIZE + 1)} VisDrone images '
          f'at {VISDRONE_SIZES} with {n_boxes} boxes and the lists ({n_train} train entries with '
          f'the area repeats) in {time.perf_counter() - t0:.2f} s')
    ypath = yaml_copy(tmp, 'visdrone.yaml')
    wroot = os.path.join(tmp, 'weights_visdrone')
    rec = {}
    wall = run_train_cli(['--yaml', ypath, 'dataset.train_txt_file', train_txt,
                          'dataset.eval_txt_file', test_txt, 'weight.dir', wroot,
                          'train.max_epochs', '1', 'eval.after', '0',
                          'train.input_sizes', f'[{VISDRONE_TRAIN_SIZE}]'], rec)
    trainer = rec['trainer']
    c = trainer.config
    gate((c.train.batch_size, c.model.max_gt_boxes, c.eval.batch_size, c.model.cfg_path)
         == (30, 256, 1, 'regnetx-600m-fpn'),
         f'(c) visdrone.yaml as shipped: batch {c.train.batch_size}, max_gt_boxes '
         f'{c.model.max_gt_boxes}, eval batch {c.eval.batch_size}, {c.model.cfg_path}')
    n_eval = trainer.eval_data.length
    ips = trainer_gates(rec, '(c) VisDrone trainer', tag, gate, host_ips, [0],
                        phase='phase 18')
    ep, ev = rec['epochs'][0], rec['evals'][0]
    gate(ev['launches']['decode_heads'] == n_eval == len(VISDRONE_SIZES),
         f'(c) the eval: {ev["launches"]["decode_heads"]} decode_heads launches for {n_eval} '
         'images at batch 1')
    shapes = eval_shapes(trainer.eval_data)
    print(f'phase 18 (c): {tag} cli.train visdrone.yaml {wall:.2f} s: epoch {ep["s"]:.3f} s '
          f'({ep["steps"]} steps of B={c.train.batch_size} at {VISDRONE_TRAIN_SIZE}), eval '
          f'{ev["s"]:.3f} s over {n_eval} images at per-image sizes {sorted(shapes)}; AP '
          f'{ev["AP"]:.6f}')
    net, params, state = trainer.network, trainer.params, trainer.state
    nc = net.num_classes
    strides = [y.attrs['stride'] for y in net.graph.yolo_nodes]
    dec = {}
    worst = 0.0
    for h, w in sorted(shapes):
        raws = [(torch.randn(1, h // st, w // st, 3 * (5 + nc), generator=gen) * 2)
                .to(dev, torch.bfloat16) for st in strides]
        got = decode_heads(raws, nc, strides, [0.0] * 3)
        ref = decode_heads_reference(raws, nc, strides, [0.0] * 3)
        tol = torch.cat([decode_tolerance(r, nc, st, 0.0).flatten(1, 3)
                         for r, st in zip(raws, strides)], 1)
        err = (got - ref).abs()
        worst = max(worst, err.max().item())
        nbytes = sum(r.numel() for r in raws) * (2 + 4)
        dec[(h, w)] = {'ms': device_ms(lambda: decode_heads(raws, nc, strides, [0.0] * 3)),
                       'plain_ms': device_ms(lambda: decode_heads_reference(
                           raws, nc, strides, [0.0] * 3), iters=5, replays=2),
                       'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3}
        gate(bool((err <= tol).all()),
             f'(c) decode_heads at the eval input {h}x{w}, grids '
             f'{[(h // st, w // st) for st in strides]}, bf16, B=1: one launch into '
             f'{tuple(got.shape)}, max |err| {err.max().item():.3g}; device {dec[(h, w)]["ms"]:.4f}'
             f' ms, plain {dec[(h, w)]["plain_ms"]:.4f} ms, bound {dec[(h, w)]["bound_ms"]:.5f} '
             'ms (bytes)')

    # the int8 route of the trained checkpoint, at each eval image
    cfg_text = trainer.cfg_text
    qnet = DetectionNetwork.from_cfg(cfg_text, quant=True)
    t0 = time.perf_counter()
    _, _, qparams = calibrate_int8(qnet, params, state, request_maker(gen, dev))
    inf = Int8Inference(qnet, mode='kernel')
    prep = Int8Inference.prepare(qparams, mode='kernel', network=qnet)
    print(f'phase 18 (c): {tag} int8: {N_CALIB} observer passes, convert_to_int8 and prepare '
          f'{time.perf_counter() - t0:.2f} s')
    qcfg = load_config(ypath, ['dataset.eval_txt_file', test_txt])
    predict = make_batch_predict(build_predict_pipeline(qnet, qcfg, apply_fn=inf.apply,
                                                        device=dev), prep)
    eval_data = EvalData(qcfg)
    n_pw = sum(1 for n in qnet.graph.nodes if n.kind == 'convolutional'
               and not n.attrs['groups'] == n.in_channels == n.attrs['filters'])
    launches = dict.fromkeys(('decode_heads', 'fused_ir_conv', 'qconv1x1_s8', 'qdwconv3x3_s8'),
                             0)
    first = {}
    for i in range(len(eval_data)):
        b = eval_data.batch(i)
        hw = tuple(b['image'].shape[1:3])
        torch.cuda.synchronize()
        reset_kernel_launches()
        t1 = time.perf_counter()
        dets = predict(b)
        torch.cuda.synchronize()
        first[hw] = time.perf_counter() - t1
        got = kernel_launches()
        for k, v in got.items():
            launches[k] += v
        t1 = time.perf_counter()
        predict(b)
        torch.cuda.synchronize()
        again = time.perf_counter() - t1
        want = {**dict.fromkeys(got, 0), 'qconv1x1_s8': n_pw, 'decode_heads': 1}
        gate(got == want and all(bool(torch.isfinite(torch.from_numpy(d)).all()) for d in dets),
             f'(c) int8 request at {hw[0]}x{hw[1]} (B=1): launches {got} (want {want}), '
             f'{sum(len(d) for d in dets)} finite detections; first call {first[hw]:.3f} s, the '
             f'next {again:.3f} s')
        with torch.inference_mode():
            x = device_normalize(torch.as_tensor(b['image'], device=dev))
        kern, plain, bad, n_exact, n_nodes = int8_node_parity(inf, prep, qparams, qnet, x)
        ds = (kern[..., 4:] - plain[..., 4:]).abs().max().item()
        db = (kern[..., :4] - plain[..., :4]).abs().max().item()
        gate(not bad and ds <= 0.02 and db <= 1.0,
             f'(c) int8 at {hw[0]}x{hw[1]} against plain=True conv by conv: {n_exact} of '
             f'{n_nodes} nodes equal bit for bit, outside the bound {bad}; preds scores max |d| '
             f'{ds:.4g} (<= 0.02), boxes {db:.4g} px (<= 1)')
    qt = {}
    for hw in VISDRONE_TIMED:
        qt[hw] = int8_kernel_times(gen, dev, int8_conv_shapes(qnet, hw), ptx, tag,
                                   f'phase 18 (c) {hw[0]}x{hw[1]}', batch=1)['qconv1x1_s8']
    return {'launches': launches, 'decode_err': worst, 'decode': dec, 'qconv': qt,
            'epoch_s': ep['s'], 'eval_s': ev['s'], 'first_s': first, 'ips': ips}


def bce_saturation(trainer, start, gate, label):
    """The reference's saturated BCE (ROADMAP §3) as the cause of a NaN at
    step 2: on the trainer's initial params ``start`` (leaves) and its first
    batch, the loss is finite, some conf or class logit reaches 17 (its f32
    sigmoid rounds to 1.0, where the -100 log clamp gives a NaN gradient)
    and grads are non-finite. Returns the initial params."""
    import torch
    from pqdet_tpu_torch.data.train_data import make_batch
    from pqdet_tpu_torch.ops.labels import label_assigner_from_config
    from pqdet_tpu_torch.train.step import (COMPUTE_DTYPES, make_loss_fn, tree_leaves,
                                            tree_unflatten, value_and_grad)
    net, cfg = trainer.network, trainer.config
    params = tree_unflatten(trainer.params, start)
    data = trainer.train_data
    batch = trainer._put_batch(make_batch(data, data.batch_indices()[0]))
    heads = {n.index - 1: n.attrs['classes'] for n in net.graph.yolo_nodes}
    top = []

    def tap(i, t):
        if i in heads:
            r = t.detach().float().reshape(*t.shape[:3], -1, 5 + heads[i])
            top.append(r[..., 4:].max().item())
    walk = net.forward_train
    loss_fn = make_loss_fn(net, compute_dtype=COMPUTE_DTYPES[cfg.system.compute_dtype],
                           label_fn=label_assigner_from_config(cfg, device=trainer.device))
    net.forward_train = lambda *a, **k: walk(*a, **{**k, 'tap': tap})
    try:
        (loss, _), grads = value_and_grad(loss_fn, params, trainer.state, batch)
    finally:
        net.forward_train = walk
    n_bad = sum(not bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    one = torch.sigmoid(torch.tensor(max(top))).item() == 1.0
    gate(bool(torch.isfinite(loss)) and max(top) >= 17.0 and one and n_bad > 0,
         f'{label}: the NaN at step 2 is the reference\'s saturated BCE: on the initial params '
         f'and the first batch the loss is {float(loss):.2f}, the largest conf/class logit per '
         f'head {[round(x, 2) for x in top]} (>= 17: f32 sigmoid 1.0), {n_bad} grad leaves '
         'non-finite')
    return params


def run_train_cli_or_bce_nan(argv, rec):
    """``run_train_cli``, or the trainer's non-finite-loss error if the run
    raised it (any other error propagates): (wall seconds, None) or (None,
    the error's message)."""
    try:
        return run_train_cli(argv, rec), None
    except RuntimeError as e:
        if not str(e).startswith('NaN in loss near step'):
            raise
        return None, str(e)


def phase18_coco(dev, tag, tmp, gate, host_ips):
    """(d): COCO as shipped: a seeded darknet-txt corpus (write_coco, 80
    classes), one epoch of ``cli.train`` on yamls/coco.yaml
    (regnetx-600m-fpn, batch 32, the eval at COCO_SIZE, batch 32), and one
    with ``augment.device on`` from the device corpus (absolute boxes).
    From the zoo's random init some of the 255 head channels' logits reach
    17 on this corpus, where the reference's BCE (kept, ROADMAP §3) gives
    NaN gradients: a run either trains (phase 13's trainer gates) or
    raises the trainer's NaN at step 2, which ``bce_saturation`` traces to
    that cause; then the eval of the initial params runs the eval path."""
    import torch
    root = os.path.join(tmp, 'coco')
    t0 = time.perf_counter()
    lists = write_coco(root, COCO_TRAIN, COCO_VAL)
    print(f'phase 18 (d): wrote {COCO_TRAIN + COCO_VAL} COCO-layout images in '
          f'{time.perf_counter() - t0:.2f} s')
    ypath = yaml_copy(tmp, 'coco.yaml')
    base = ['--yaml', ypath, 'dataset.train_txt_file', lists['train'],
            'dataset.eval_txt_file', lists['val'], 'train.max_epochs', '1', 'eval.after', '0',
            'train.input_sizes', f'[{COCO_SIZE}]', 'eval.input_size', str(COCO_SIZE)]
    out = {}
    for name, extra in (('host', []), ('device corpus', ['augment.device', 'on',
                                                         'dataset.device_cache', 'on'])):
        rec = {}
        t0 = time.perf_counter()
        wall, nan = run_train_cli_or_bce_nan(
            base + ['weight.dir', os.path.join(tmp, f'weights_coco_{len(out)}'), *extra], rec)
        trainer = rec['trainer']
        c = trainer.config
        gate((c.train.batch_size, c.eval.batch_size, len(c.dataset.classes))
             == (32, 32, 80), f'(d) coco.yaml as shipped ({name}): batch '
             f'{c.train.batch_size}, eval batch {c.eval.batch_size}, {len(c.dataset.classes)} '
             'classes')
        if nan is None:
            trainer_gates(rec, f'(d) COCO trainer, {name}', tag, gate, host_ips, [0],
                          phase='phase 18')
            ep, ev = rec['epochs'][0], rec['evals'][0]
            print(f'phase 18 (d): {tag} cli.train coco.yaml ({name}) {wall:.2f} s: epoch '
                  f'{ep["s"]:.3f} s, {ep["steps"]} steps, eval {ev["s"]:.3f} s, AP '
                  f'{ev["AP"]:.6f}')
            out[name] = {'trained': True, 'wall': wall, 'epoch_s': ep['s'], 'eval_s': ev['s']}
        else:
            losses = [float(x) for x in rec['loss'].get(0, [])]
            print(f'phase 18 (d): {tag} cli.train coco.yaml ({name}) raised after '
                  f'{time.perf_counter() - t0:.2f} s: {nan}; step losses {losses}')
            gate(nan.startswith('NaN in loss near step 2') and len(losses) == 2
                 and math.isfinite(losses[0]),
                 f'(d) {name}: step 1 finite ({losses[:1]}), the NaN at step 2')
            trainer.params = bce_saturation(trainer, rec['start'], gate, f'(d) {name}')
            reset_kernel_launches()
            t1 = time.perf_counter()
            ap = trainer.evaluate()
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t1
            got = kernel_launches()
            n_b = len(trainer.eval_data)
            gate(got == {**dict.fromkeys(got, 0), 'decode_heads': n_b} and 0 <= ap.AP <= 1,
                 f'(d) {name}: the eval of the initial params at {COCO_SIZE}, {n_b} batches of '
                 f'{c.eval.batch_size}: launches {got}, AP {ap.AP:.6f}, {eval_s:.3f} s')
            out[name] = {'trained': False, 'eval_s': eval_s}
        if name == 'device corpus':
            cache = trainer._device_cache
            gt = cache['gt']
            real = gt[..., 2] > gt[..., 0]
            gate(bool(real.any()) and gt[real][:, :4].max().item() > 2.0
                 and gt[real][:, 2:4].max().item() <= COCO_SIZE,
                 f'(d) the device corpus holds absolute boxes: {int(real.sum())} boxes, largest '
                 f'coordinate {gt[real][:, :4].max().item():.1f} px at {cache["smax"]}')
        trainer.close()
    return out


def phase18_loaders(dev, tag, tmp, corpus, gate):
    """(e): phase 11's corpus with a copy of yamls/shapes.yaml, one epoch
    each of ``label_assign host`` (thread loader), ``loader process``
    (device labels) and ``loader process`` with ``label_assign host`` and
    ``device_prefetch 2``. Gates: the host grids equal the device
    assigner's on the card for one batch; the process loader's first
    batches equal the thread loader's bit for bit; the prefetched epoch's
    batches, as its steps read them, equal the synchronous host-label
    epoch's; no worker process and no /dev/shm slab after close."""
    import numpy as np
    import torch
    from pqdet_tpu_torch.config import load_config
    from pqdet_tpu_torch.data.train_data import (ProcessLoader, TrainData, epoch_batches,
                                                 make_batch)
    from pqdet_tpu_torch.ops.labels import label_assigner_from_config
    root = corpus['root']
    ypath = yaml_copy(tmp, 'shapes.yaml')
    base = ['dataset.train_txt_file', os.path.join(root, 'train.txt'),
            'dataset.eval_txt_file', os.path.join(root, 'test.txt'), 'train.max_epochs', '1',
            'eval.after', '5', 'train.input_sizes', f'[{SIZE}]']
    host = ['system.label_assign', 'host', 'augment.device', 'off']

    # the host assigner against the device's, on one batch of the same samples
    cfg_h = load_config(ypath, base + host)
    cfg_d = load_config(ypath, base + ['augment.device', 'off'])
    dh, dd = TrainData(cfg_h), TrainData(cfg_d)
    idx = dh.batch_indices()[0]
    bh, bd = make_batch(dh, idx), make_batch(dd, idx)
    gate(np.array_equal(bh['image'], bd['image']), '(e) host- and device-label samples: the same '
         'images')
    size = bh['image'].shape[1:3]
    grids = label_assigner_from_config(cfg_d, device=dev)(
        torch.from_numpy(bd['gt']).to(dev), size)
    same = [torch.equal(torch.from_numpy(a).to(dev), b) for a, b in zip(bh['targets'], grids)]
    gate(all(same), f'(e) the host grids and boxes against the device assigner\'s on the card, '
         f'B={len(idx)} {size[0]}x{size[1]}: {sum(same)} of 6 equal bit for bit')

    # the process loader's first batches against the thread loader's
    for name, cfg in (('device labels', cfg_d), ('host labels', cfg_h)):
        data = TrainData(cfg)
        n = min(LOADER_BATCHES, data.batches_per_epoch)
        t0 = time.perf_counter()
        loader = ProcessLoader(data, int(corpus['workers']), prefetch=2)
        try:
            it = loader.epoch()
            got = [next(it) for _ in range(n)]
            spawn_s = time.perf_counter() - t0
            it.close()
        finally:
            loader.close()
        want = [make_batch(data, i) for i in data.batch_indices()[:n]]
        eq = all(np.array_equal(x, y) for g, w in zip(got, want) for k in g
                 for x, y in zip(*((g[k], w[k]) if isinstance(g[k], tuple)
                                   else ((g[k],), (w[k],)))))
        gate(eq, f'(e) ProcessLoader ({name}, {corpus["workers"]} workers): its first {n} '
             f'batches equal the thread loader\'s bit for bit ({spawn_s:.2f} s from the pool\'s '
             'start to the last of them)')

    runs = (('host labels, thread loader', host),
            ('process loader, device labels', ['system.loader', 'process']),
            ('process loader, host labels, device_prefetch 2',
             host + ['system.loader', 'process', 'system.device_prefetch', '2']))
    recs, out = {}, {}
    for name, extra in runs:
        rec = {'sums': []}
        wall = run_train_cli(['--yaml', ypath, *base, *extra, 'weight.dir',
                              os.path.join(tmp, f'weights_loader_{len(recs)}')], rec)
        recs[name] = rec
        ep = rec['epochs'][0]
        b = rec['trainer'].config.train.batch_size
        out[name] = ep['steps'] * b / ep['s']
        print(f'phase 18 (e): {tag} {name}: cli.train {wall:.2f} s, epoch {ep["s"]:.3f} s, '
              f'data load {ep["data_load_s"]:.3f} s, {out[name]:.2f} images/s; losses '
              f'{[round(x, 3) for x in rec["loss"][0]]}')
        losses = rec['loss'][0]
        gate(all(math.isfinite(x) for x in losses) and not any(ep['launches'].values()),
             f'(e) {name}: {len(losses)} finite losses, 0 kernel launches in the steps')
        trainer = rec['trainer']
        pool = rec['pool']
        trainer.close()
        if pool is not None:
            pids, slabs = pool
            alive = [pid for pid in pids if os.path.exists(f'/proc/{pid}')
                     and open(f'/proc/{pid}/stat').read().split()[2] != 'Z']
            left = [n for n in slabs if os.path.exists(os.path.join('/dev/shm', n))]
            gate(not alive and not left, f'(e) {name}: after close, worker processes alive '
                 f'{alive} of {len(pids)}, slabs left in /dev/shm {left} of {len(slabs)}')
    a, b = (recs[runs[0][0]]['sums'], recs[runs[2][0]]['sums'])
    eq = len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))
    gate(eq, f'(e) the prefetched epoch\'s {len(b)} batches, as its steps read them on the card '
         f'(the sum of each tensor), equal the synchronous thread-loader epoch\'s ({len(a)})')
    print(f'phase 18 (e): {tag} images/s of one epoch at B={corpus["batch"]}, {SIZE}x{SIZE}: '
          + ', '.join(f'{k} {v:.2f}' for k, v in out.items())
          + f'; phase 11\'s thread loader, host augment, epochs 1-2: '
          f'{statistics.mean(e["steps"] * corpus["batch"] / e["s"] for i, e in corpus["host_epochs"].items() if i > 0):.2f}')
    return out


def phase18_playground(tmp, corpus, gate):
    """(f): ``cli.playground`` writes a grid of 8 views for a VOC (phase
    11's corpus), a COCO and a VisDrone image into OUTPUT_DIR."""
    from pqdet_tpu_torch.cli import playground
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, OUTPUT_DIR)
    os.makedirs(out_dir, exist_ok=True)

    def first(txt):
        with open(txt) as fr:
            return next(line.strip() for line in fr if line.strip())
    vd = os.path.join(tmp, 'visdrone')
    cases = {
        'voc': (first(os.path.join(corpus['root'], 'train.txt')),
                ['dataset.classes', '[square, circle, triangle]']),
        'coco': (first(os.path.join(tmp, 'coco', 'train.txt')),
                 ['--yaml', yaml_copy(tmp, 'coco.yaml')]),
        'visdrone': (first(os.path.join(vd, 'trainval.txt')),
                     ['--yaml', yaml_copy(tmp, 'visdrone.yaml')]),
    }
    for name, (img, extra) in cases.items():
        path = os.path.join(out_dir, f'playground_{name}.jpg')
        grid = playground.main(['--img', img, '--n', '8', '--seed', str(SEED), '--out', path,
                                'augment.mixup_p', '0.5', 'augment.color_p', '0.5', *extra])
        gate(os.path.getsize(path) > 0 and grid.shape == (2 * 420, 4 * 420, 3),
             f'(f) playground {name}: {path} {grid.shape}')


def phase18_s2d_host_data(dev, tag, tmp, corpus, net, params, state, ptx):
    """Phase 18: the space-to-depth stem, the rest of the host data and the
    playground on the card ((a)-(f), module docstring). Raises on any
    failed gate; returns the kernels' errors, the main path's launches and
    the timings the kernels line and PERF.md read."""
    t_phase = time.perf_counter()
    fails = []

    def gate(ok, what):
        print(f'phase 18: {what}: {"ok" if ok else "FAIL"}')
        if not ok:
            fails.append(what)

    host_ips = statistics.mean(e['steps'] * corpus['batch'] / e['s']
                               for i, e in corpus['host_epochs'].items() if i > 0)
    secs = {}
    t0 = time.perf_counter()
    a = phase18_s2d_serving(dev, tag, gate, net, params, state)
    secs['a'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = phase18_s2d_train(dev, tag, gate)
    secs['b'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = phase18_visdrone(dev, tag, tmp, gate, ptx, host_ips)
    secs['c'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = phase18_coco(dev, tag, tmp, gate, host_ips)
    secs['d'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    e = phase18_loaders(dev, tag, tmp, corpus, gate)
    secs['e'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase18_playground(tmp, corpus, gate)
    secs['f'] = time.perf_counter() - t0
    print(f'phase 18: {tag} seconds: '
          + ', '.join(f'({k}) {v:.1f}' for k, v in secs.items())
          + f'; phase {time.perf_counter() - t_phase:.1f}')
    if fails:
        raise AssertionError(f'phase 18 gates failed: {fails}')
    launches = {k: a['launches'][k] + c['launches'][k] for k in a['launches']}
    return {'launches': launches, 'fused_err': a['fused_err'],
            'decode_err': max(a['decode_err'], c['decode_err']), 'visdrone': c,
            's2d_train': b, 'coco': d, 'loaders': e}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'runs only on a GPU', file=sys.stderr)
        return 2
    import pqdet_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pqdet_tpu_torch.config import Config
    from pqdet_tpu_torch.evaluation.predict import (build_predict_pipeline,
                                                    make_batch_predict)
    from pqdet_tpu_torch.model.network import (DetectionNetwork, cast_params,
                                               fuse_params)
    from pqdet_tpu_torch.ops._build import build_all
    from pqdet_tpu_torch.ops.decode_kernel import decode_heads, decode_heads_reference
    from pqdet_tpu_torch.ops.fused_ir import fused_ir_conv, prepare_fused_ir
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.zoo import get_cfg

    t_start = time.perf_counter()

    def stamp(what):
        print(f'chip_smoke: {what} at {time.perf_counter() - t_start:.1f} s')

    dev = torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    tag = f'[{card}]'

    # ---- phase 1: card, versions, build
    import triton
    print(f'phase 1: card {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}, triton {triton.__version__}, python '
          f'{sys.version.split()[0]}')
    print('TF32 off: torch.backends.cudnn.allow_tf32 = False, '
          'torch.backends.cuda.matmul.allow_tf32 = False')
    print(f'phase 1: host libraries {host_libraries()} (the port needs cv2, yaml, msgpack, '
          'numpy)')
    t0 = time.perf_counter()
    report = build_all()
    print(f'phase 1: built {sorted(report)} in {time.perf_counter() - t0:.2f} s')
    for name, r in report.items():
        print(f'  nvcc {name}: {r["seconds"]:.2f} s -> {r["path"]}\n'
              + '\n'.join('    ' + ln for ln in r['log'].splitlines()))
    ptx = ptxas_report('\n'.join(r['log'] for r in report.values()))
    for k, v in sorted(ptx.items()):
        print(f'phase 1: ptxas {k}: {v}')

    stamp('phase 2 starts')
    # ---- phase 2: decode kernel vs plain decode
    gen = phase_gen(2)
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'))
    heads = [(SIZE // y.attrs['stride'], y.attrs['stride']) for y in net.graph.yolo_nodes]
    nc = net.num_classes
    strides = [s for _, s in heads]
    # (B, [(H, W) of each head], strides, dtype, exp caps)
    cases = [(BATCH, [(h, h) for h, _ in heads], strides, dt, caps)
             for dt in (torch.bfloat16, torch.float32)
             for caps in ([0.0] * 3, [2.0, 0.0, 1.5])]
    cases += [(2, [(13, 16)], [8], torch.float32, [0.0]),
              (BATCH, [(7, 9), (13, 16)], [16, 8], torch.float32, [0.0, 2.0])]
    decode_err = 0.0
    for b, sizes, ss, dt, caps in cases:
        raws = [(torch.randn(b, h, w, 3 * (5 + nc), generator=gen) * 2).to(dev, dt)
                for h, w in sizes]
        got = decode_heads(raws, nc, ss, caps)
        ref = decode_heads_reference(raws, nc, ss, caps)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        tol = torch.cat([decode_tolerance(r, nc, st, cap).flatten(1, 3)
                         for r, st, cap in zip(raws, ss, caps)], 1)
        ok = got.shape == ref.shape and bool((err <= tol).all())
        decode_err = max(decode_err, err.max().item())
        print(f'phase 2: decode_heads B={b} heads {sizes} strides {ss} {dt} exp_cap={caps}: '
              f'one launch into {tuple(got.shape)}, max |err| {err.max().item():.3g} '
              f'{"ok" if ok else "FAIL"}')
        if not ok:
            raise AssertionError('decode kernel disagrees with its plain version')

    stamp('phase 3 starts')
    # ---- phase 3: fused IR kernel vs fused_ir_reference
    gen = phase_gen(3)
    chains = chain_shapes(net, SIZE)
    if len(chains) != 21:
        raise AssertionError(f'expected 21 fused chains, found {len(chains)}')
    # (label, n, h, w, cin, e, p, expand, acts, bias shift)
    checks = [(f'{a},{b},{c}', n, h, h, cin, e, p, a is not None, acts, 0.0)
              for a, b, c, h, cin, e, p, acts in chains for n in (1, BATCH)]
    checks += [(f'{a},{b},{c}', 1, h, h, cin, e, p, a is not None, acts, 3.0)
               for a, b, c, h, cin, e, p, acts in (chains[0], chains[-1])]   # pad domain
    checks += [('edge', n, h, w, cin, e, p, ex, acts, 0.0)
               for h, w, cin, e, p, ex, acts in EDGE_CHAINS for n in (1, BATCH)]
    h, w, cin, e, p, ex, acts = EDGE_CHAINS[0]       # pad domain under a cluster of 5
    checks.append(('edge', BATCH, h, w, cin, e, p, ex, acts, 3.0))
    fused_err = fused_parity(gen, dev, checks, 'phase 3')

    stamp('phase 4 starts')
    # ---- phase 4: the main path
    gen = phase_gen(4)
    cfg = Config()
    cfg.eval.input_size = SIZE
    cfg.eval.fused_ir = True
    params, state = net.init(gen, device=dev)
    seed_bn(params, state, gen, dev)
    fused = fuse_params(net, params, state)
    table = prepare_fused_ir(net, fused)
    if len(table) != 21:
        raise AssertionError(f'fused-IR table has {len(table)} entries, not 21')
    fparams = cast_params(fused, torch.bfloat16)
    run = build_predict_pipeline(net, cfg, compute_dtype=torch.bfloat16,
                                 fused_ir=table, device=dev)
    predict = make_batch_predict(run, fparams)
    batch = request_maker(gen, dev)
    requests = [batch(BATCH) for _ in range(N_REQUESTS)]
    predict(requests[0])                      # warm-up: Triton compile
    torch.cuda.synchronize()
    fused_ir_conv.launches = 0
    decode_heads.launches = 0
    dets = [predict(r) for r in requests]
    torch.cuda.synchronize()
    launches = {'fused_ir': fused_ir_conv.launches, 'decode': decode_heads.launches}
    want = {'fused_ir': 21 * N_REQUESTS, 'decode': N_REQUESTS}
    print(f'phase 4: served {N_REQUESTS} requests of {BATCH} images at {SIZE}x{SIZE}; '
          f'launches {launches} (want {want})')
    if launches != want:
        raise AssertionError(f'kernel launches {launches} != {want}')
    n_det = sum(len(d) for r in dets for d in r)
    for r in dets:
        for d in r:
            if d.shape[1] != 6 or not bool(torch.isfinite(torch.from_numpy(d)).all()):
                raise AssertionError('a detection is not finite or has the wrong shape')
            if len(d) and not ((d[:, 5] >= 0) & (d[:, 5] < nc)).all():
                raise AssertionError('a detection has a class outside the model')
    print(f'phase 4: {n_det} detections, all finite')

    with torch.inference_mode():
        x = device_normalize(requests[0]['image'])
        kern = net(fparams, {}, x, compute_dtype=torch.bfloat16, fused_ir=table)
        plain = net(fparams, {}, x, compute_dtype=torch.bfloat16, fused_ir=table, plain=True)
        walk = net(fparams, {}, x, compute_dtype=torch.bfloat16, plain=True)
    rows = sum((SIZE // s) ** 2 * 3 for _, s in heads)
    if tuple(kern.shape) != (BATCH, rows, 5 + nc) or not bool(torch.isfinite(kern).all()):
        raise AssertionError(f'preds {tuple(kern.shape)} not finite (B, {rows}, {5 + nc})')
    # the plain fused path rounds where the kernel does: the bounds of the
    # JAX package's fused-walk test (scores 0.03, boxes 1.5 px). The layer
    # walk (cuDNN convs) rounds each conv's sum to bf16 before its bias add,
    # the kernel after it; at 512 px with nonzero biases that alone moves
    # boxes by over 1 px, so its box bound is 3 px (a wrong bias,
    # activation or pad moves scores by far more than 0.03)
    for name, ref, box_tol in (('plain fused path', plain, 1.5),
                               ('plain layer walk', walk, 3.0)):
        ds = (kern[..., 4:] - ref[..., 4:]).abs().max().item()
        db = (kern[..., :4] - ref[..., :4]).abs().max().item()
        print(f'phase 4: kernel path vs {name}: scores max |d| {ds:.4g} (<= 0.03), '
              f'boxes max |d| {db:.4g} (<= {box_tol})')
        if not (ds <= 0.03 and db <= box_tol):
            raise AssertionError(f'kernel path disagrees with the {name}')

    stamp('phase 5 starts')
    # ---- phase 5: timings (CUDA events, after warm-up; kernels, their plain
    # versions and cuDNN as device time, from CUDA graphs)
    gen = phase_gen(5)
    batch = request_maker(gen, dev)
    for b in (1, BATCH):
        request_times({'': predict}, batch, b, tag, 'phase 5')
    rb = batch(BATCH)
    ev = cfg.eval
    with torch.inference_mode():
        xb = device_normalize(rb['image'])
    stage_split(lambda x: net(fparams, {}, x, compute_dtype=torch.bfloat16, fused_ir=table),
                xb, rb, dev, ev, tag, 'phase 5')
    rp = batch(BATCH)
    profile_calls(lambda: predict(rp), tag, 'phase 5', f'request B={BATCH}')

    # decode: the three heads of one B=4 bf16 forward, one launch into the
    # preds; and the earlier form, a launch per head and the concatenation
    raws = [torch.randn(BATCH, h, h, 3 * (5 + nc), generator=gen).to(dev, torch.bfloat16)
            for h, _ in heads]
    caps = [0.0] * len(heads)
    nbytes = sum(r.numel() for r in raws) * (2 + 4)

    def per_head():
        return torch.cat([decode_heads([r], nc, [s], [0.0]) for r, (_, s) in zip(raws, heads)], 1)

    dec = {'ms': device_ms(lambda: decode_heads(raws, nc, strides, caps)),
           'plain_ms': device_ms(lambda: decode_heads_reference(raws, nc, strides, caps)),
           'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3}
    call_ms = cuda_ms(lambda: decode_heads(raws, nc, strides, caps))
    old_ms = device_ms(per_head)
    old_call_ms = cuda_ms(per_head)
    print(f'phase 5: {tag} decode B={BATCH} heads {[h for h, _ in heads]}: one launch '
          f'{dec["ms"]:.4f} ms ({call_ms:.4f} ms a call with its launch); a launch per head '
          f'and torch.cat {old_ms:.4f} ms ({old_call_ms:.4f} ms a call with its launches); '
          f'plain {dec["plain_ms"]:.4f} ms, bound {dec["bound_ms"]:.5f} ms (bytes)')

    # fused IR: each chain at B=4, its plain version and three cuDNN convs
    fir = fused_chain_times(gen, dev, chains, ptx, tag, 'phase 5')
    print(f'phase 5: {tag} decode per B={BATCH} forward (1 launch): kernel '
          f'{dec["ms"]:.4f} ms, plain {dec["plain_ms"]:.4f} ms, bound '
          f'{dec["bound_ms"]:.5f} ms')

    stamp('phase 6 starts')
    # ---- phases 6-8: the int8 serving path
    qnet = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'), quant=True)
    shapes = int8_conv_shapes(qnet, SIZE)
    int8_err = phase6_int8_parity(phase_gen(6), dev, shapes)
    gen = phase_gen(7)
    inf, qprep, qpredict, qlaunches, qparams = phase7_int8_path(gen, dev, cfg, request_maker(gen, dev),
                                                       tag, qnet, shapes)
    gen = phase_gen(8)
    qt = phase8_int8_timings(gen, dev, cfg, request_maker(gen, dev), tag, shapes, inf, qprep,
                             qpredict, ptx)

    stamp('phase 9 starts')
    # ---- phases 9-10: the training step
    train_run = phase9_training(dev, tag)
    stamp('phase 10 starts')
    tt = phase10_training_timings(train_run, tag)
    stamp('phase 11 starts')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_trainer_') as tmp:
        corpus = phase11_trainer(dev, tag, train_run['cfg'].train.batch_size * 1000.0 / tt['p50'],
                                 tmp)
        stamp('phase 12 starts')
        phase12_qat(dev, tag, tmp, corpus, tt)
        stamp('phase 13 starts')
        phase13_device_augment(dev, tag, tmp, corpus)
        stamp('phase 14 starts')
        p14 = phase14_prune(dev, tag, tmp, corpus, ptx, {'fused_ir_conv': fir, **qt})
        stamp('phase 15 starts')
        exported = phase15_exporters(dev, tag, tmp, net, params, state, qnet, qparams)
        stamp('phase 16 starts')
        p16 = phase16_regnet(dev, tag, tmp, corpus, ptx)
        stamp('phase 17 starts')
        p17 = phase17_nas_evolution(dev, tag, tmp, corpus, os.path.join(tmp, 'clutter'), ptx)
        stamp('phase 18 starts')
        p18 = phase18_s2d_host_data(dev, tag, tmp, corpus, net, params, state, ptx)
    stamp('phase 18 ends')
    arc = p14['launches']
    rn = p16['launches']
    nas = p17['launches']
    hd = p18['launches']

    kernels = [
        {'name': 'decode_heads', 'route': 'triton',
         'source': 'pqdet_tpu_torch/ops/decode_kernel.py',
         'replaces': 'pqdet_tpu/ops/pallas_decode.py:59',
         'launches': launches['decode'] + qlaunches['decode'] + arc.get('decode_heads', 0)
         + exported['decode_heads'] + rn['decode_heads'] + nas['decode_heads']
         + hd['decode_heads'],
         'max_abs_err': max(decode_err, p17['decode_err'], p18['decode_err']),
         'ms': dec['ms'], 'plain_ms': dec['plain_ms'], 'bound_ms': dec['bound_ms'],
         'bound_by': 'bytes', 'library_ms': None},
        {'name': 'fused_ir_conv', 'route': 'cuda',
         'source': 'pqdet_tpu_torch/csrc/fused_ir.cu',
         'replaces': 'pqdet_tpu/ops/pallas_fused.py:135',
         'launches': launches['fused_ir'] + arc.get('fused_ir_conv', 0) + rn['fused_ir_conv']
         + nas['fused_ir_conv'] + hd['fused_ir_conv'],
         'max_abs_err': max(fused_err, p14['fused_err'], p16['fused_err'], p17['fused_err'],
                            p18['fused_err']),
         'ms': fir['ms'], 'plain_ms': fir['plain_ms'], 'bound_ms': fir['bound_ms'],
         'bound_by': fir['bound_by'], 'library_ms': fir['library_ms']},
        {'name': 'qconv1x1_s8', 'route': 'cuda',
         'source': 'pqdet_tpu_torch/csrc/qconv.cu',
         'replaces': 'pqdet_tpu/ops/pallas_qconv.py:121',
         'launches': qlaunches['qconv1x1_s8'] + arc.get('qconv1x1_s8', 0)
         + exported['qconv1x1_s8'] + rn['qconv1x1_s8'] + hd['qconv1x1_s8'],
         'max_abs_err': max(int8_err['qconv1x1_s8'], p14['int8_err']['qconv1x1_s8'],
                            p16['int8_err']['qconv1x1_s8']),
         **qt['qconv1x1_s8']},
        {'name': 'qdwconv3x3_s8', 'route': 'cuda',
         'source': 'pqdet_tpu_torch/csrc/qconv.cu',
         'replaces': 'pqdet_tpu/ops/pallas_qconv.py:261',
         'launches': qlaunches['qdwconv3x3_s8'] + arc.get('qdwconv3x3_s8', 0)
         + exported['qdwconv3x3_s8'] + rn['qdwconv3x3_s8'] + hd['qdwconv3x3_s8'],
         'max_abs_err': max(int8_err['qdwconv3x3_s8'], p14['int8_err']['qdwconv3x3_s8'],
                            p16['int8_err']['qdwconv3x3_s8']),
         **qt['qdwconv3x3_s8']},
    ]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
