"""Quantisation-aware fake-quant int8 and its observers (the port of
``pqdet_tpu/compress/qat.py``).

Scheme, as in the JAX package:
- weights: per-output-channel symmetric int8, quantised at use time. The
  port's conv weights are OIHW, so the output channel is dim 0 and the
  absmax reduces over dims 1-3 (the JAX package's HWIO reduces over the
  leading three);
- activations: per-tensor affine uint8 with moving-average min/max
  observers kept in ``state['quant']``;
- the quant graph forces plain relu activations (``Graph(quant=True)``).

Fake-quant rounds with a straight-through estimator,
``x + (round(x) - x).detach()``: rounding is invisible to the gradient.
The clip after it is ``jnp.clip``'s: ``minimum(maximum(x, lo), hi)`` with
tensor bounds, whose gradient splits a tie at a bound 0.5/0.5 (a weight's
largest |w| in each output channel lands exactly on +-127).
``torch.clamp`` would pass the whole gradient there.

Activations fake-quantise in f32 and come back f32, as JAX's promotion of
a bf16 activation against the observer's f32 0-d scale gives (a torch 0-d
f32 tensor does not promote a bf16 one); the walk casts the result back
to its compute dtype after the edge, as JAX's does.

The scales divide by a tensor on the operand's device (``ieee_div``): CUDA
turns a division by a Python number into a multiplication by its
reciprocal, whose result is an ulp off the IEEE quotient (the CPU's and
JAX's) in some elements, and every dequantised value carries its scale.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

ACT_QMIN, ACT_QMAX = 0, 255       # uint8 activations
W_QMIN, W_QMAX = -127, 127        # symmetric int8 weights
OBSERVER_MOMENTUM = 0.01          # torch MovingAverageMinMaxObserver default


def _ste_round(x):
    return x + (torch.round(x) - x).detach()


def _clip(x, lo: torch.Tensor, hi: torch.Tensor):
    """``jnp.clip``: the gradient at a tie with a bound is 0.5. ``lo`` and
    ``hi`` are 0-d CPU tensors, which elementwise ops take as scalars on
    any device."""
    return torch.minimum(torch.maximum(x, lo), hi)


_DIVISORS: Dict[tuple, torch.Tensor] = {}


def ieee_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as IEEE division on every device (module
    docstring). The 0-d divisor is made once per device, dtype and value
    (outside inference mode, so autograd may save it) and reused, so the
    quotient costs no fill launch."""
    key = (x.device, x.dtype, float(d))
    div = _DIVISORS.get(key)
    if div is None:
        with torch.inference_mode(False):
            div = _DIVISORS[key] = torch.full((), float(d), dtype=x.dtype, device=x.device)
    return x / div


_W_LO, _W_HI = torch.tensor(float(W_QMIN)), torch.tensor(float(W_QMAX))
_ACT_LO, _ACT_HI = torch.tensor(float(ACT_QMIN)), torch.tensor(float(ACT_QMAX))


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric fake-quant (dim 0 = out channels)."""
    dims = tuple(range(1, w.ndim))
    absmax = torch.amax(torch.abs(w), dim=dims, keepdim=True)
    # observer-derived scales are buffers, not differentiable params
    scale = torch.clamp_min(ieee_div(absmax, W_QMAX), 1e-8).detach()
    q = _clip(_ste_round(w / scale), _W_LO, _W_HI)
    return q * scale


def observe(obs: Dict, x: torch.Tensor, group=None) -> Dict:
    """Moving-average min/max observer update; returns a new dict. With a
    process ``group`` (data parallelism) ``x`` is this rank's shard and the
    min and max are the global batch's, as ``jnp.min`` over JAX's sharded
    batch: one MIN all-reduce of (min, -max), exact. A shard with no
    element (a band wholly past a padded input's real rows) takes +inf and
    -inf, which the reduction drops."""
    x32 = x.detach().float()
    if x32.numel():
        mn, mx = torch.amin(x32), torch.amax(x32)
    else:
        mn, mx = x32.new_full((), float('inf')), x32.new_full((), float('-inf'))
    if group is not None:
        both = torch.stack([mn, -mx])
        dist.all_reduce(both, op=dist.ReduceOp.MIN, group=group)
        mn, mx = both[0], -both[1]
    m = OBSERVER_MOMENTUM
    init = obs['initialized']
    new_min = torch.where(init, (1 - m) * obs['min'] + m * mn, mn)
    new_max = torch.where(init, (1 - m) * obs['max'] + m * mx, mx)
    return {'min': new_min, 'max': new_max,
            'initialized': torch.ones_like(init)}


def act_qparams(obs: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero_point) for affine uint8 activation quantisation."""
    mn = torch.clamp_max(obs['min'], 0.0)
    mx = torch.clamp_min(obs['max'], 0.0)
    scale = torch.clamp_min(ieee_div(mx - mn, ACT_QMAX - ACT_QMIN), 1e-8)
    zp = torch.clamp(torch.round(ACT_QMIN - mn / scale), ACT_QMIN, ACT_QMAX)
    return scale, zp


def fake_quant_act(x: torch.Tensor, obs: Dict) -> torch.Tensor:
    """Affine uint8 fake-quant of ``x`` with ``obs``'s range, in f32 (the
    result is f32 whatever ``x``'s dtype)."""
    scale, zp = act_qparams(obs)
    q = _clip(_ste_round(x.float() / scale + zp), _ACT_LO, _ACT_HI)
    return (q - zp) * scale


def _new_observer(device) -> Dict:
    return {'min': torch.zeros((), device=device),
            'max': torch.zeros((), device=device),
            'initialized': torch.zeros((), dtype=torch.bool, device=device)}


# graph node kinds that produce a quantised activation (the torch analogues
# carry FloatFunctional / fused-module output observers)
QUANT_OUTPUT_KINDS = ('convolutional', 'shortcut', 'scale_channels', 'route',
                      'maxpool', 'avgpool', 'upsample', 'fc')


def _params_device(params: Dict) -> torch.device:
    for p in params.values():
        for v in p.values():
            if isinstance(v, torch.Tensor):
                return v.device
    raise ValueError('prepare_qat_state: params hold no tensor to take a device from')


def prepare_qat_state(network, params: Dict, state: Dict):
    """Add activation observers, on the params' device, for every quantised
    edge: the network input and each quantisable node output, except those
    feeding a yolo head (they dequantise first, like the reference's
    DeQuantStub). Returns (params, new_state)."""
    dev = _params_device(params)
    quant = {'input': _new_observer(dev)}
    yolo_feeders = {n.index - 1 for n in network.graph.nodes if n.kind == 'yolo'}
    for node in network.graph.nodes:
        if node.kind in QUANT_OUTPUT_KINDS and node.index not in yolo_feeders:
            quant[str(node.index)] = _new_observer(dev)
    new_state = dict(state)
    new_state['quant'] = quant
    return params, new_state


class QuantCtx:
    """Hooks threaded through ``Network.forward(quant_ctx=...)`` in QAT mode.

    ``observing``: update the observers on this pass. The new observer
    states collect in ``self.new_obs``; the caller merges them back into
    ``state['quant']``. ``group``: the process group of data-parallel
    ranks, whose observers then see the global batch (``observe``).
    """

    def __init__(self, quant_state: Dict, observing: bool = True, group=None):
        self.quant_state = quant_state
        self.observing = observing
        self.group = group
        self.new_obs = dict(quant_state)

    def quantize_input(self, x, rows=None):
        return self._fq('input', x, rows)

    def fake_weights(self, node_id: str, w):
        return fake_quant_weight(w)

    def observe_output(self, node_id: str, x, rows=None):
        return self._fq(node_id, x, rows)

    def _fq(self, key: str, x, rows=None):
        """``rows``: the observer sees only ``x``'s first ``rows`` rows (a
        band's real rows of a padded input under ``train.spatial``)."""
        if key not in self.quant_state:
            return x
        obs = self.quant_state[key]
        if self.observing:
            obs = observe(obs, x if rows is None else x[:, :rows], self.group)
            self.new_obs[key] = obs
        return fake_quant_act(x, obs)
