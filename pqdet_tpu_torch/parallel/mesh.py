"""Data-parallel training as one process per GPU (the port of
``pqdet_tpu/parallel/mesh.py``).

The JAX package keeps W devices in one controller process: a 1-D ``data``
mesh shards the batch, the parameters are replicated, and GSPMD turns the
gradient and batch-norm reductions into collectives, so BN is synchronised
across shards. The port runs one process per GPU under
``torch.distributed`` and writes those reductions out where JAX's compiler
inserts them, over an explicit process ``group``:

- train-mode BN takes the global batch's moments
  (``model/layers.py::batch_norm``, sync-BN), the QAT observers the global
  batch's min and max (``compress/qat.py::observe``);
- the step averages the grads with one all-reduce of their flat f32
  vector, before sparse-L1 and the clip, and all-reduces its metrics
  (``train/step.py``);
- params, BN state and optimizer state are broadcast from rank 0 once; the
  identical updates keep the copies equal.

At world size 1 the step gets no group and runs the one-process code: no
collective and no extra copy.

JAX's names and their counterparts here:

- ``make_mesh(n)``: ``launch`` of n ranks, each joining the group with
  ``init_process_group``; ``init_multihost``: ``init_process_group`` from
  torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or explicit arguments;
- ``batch_sharding``, ``shard_batch_pytree``, ``host_local_batch_to_global``:
  the local tensor is the shard. Rank r loads rows [r*B/W, (r+1)*B/W) of
  every global batch (``TrainData(num_hosts=W, host_id=r)``);
  ``all_gather_batch`` assembles the global batch where the step needs it
  (device augmentation's in-batch partners);
- ``replicated``, ``replicate_pytree``: ``broadcast_tree`` from rank 0;
- ``fit_mesh_to_batch``, ``pad_batch_to_devices``: as they are;
- ``make_mesh_2d(n_data, n_space)`` (spatial partitioning,
  ``train.spatial``): the (data x space) layout of the ranks, rank
  ``r = d * n_space + s``, as a ``SpatialCtx`` holding its three kinds of
  group: the world (BN moments, QAT observers, grads), one ``space``
  group per data shard ``d`` (halo exchanges, band sums) and one ``data``
  group per band ``s`` (device augmentation's in-batch gather). Each rank
  holds its data shard's rows at full height and cuts its band of rows in
  the step; ``spatial_batch_shardings`` gives those slices. The halo
  exchanges are ``parallel/halo.py``.

NCCL takes one GPU per rank; ranks that share a card (two ranks on one
H100) use gloo, which takes CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from pqdet_tpu_torch.parallel.halo import padded_height

# a hung rank fails the others' collectives after this long instead of
# hanging them (rank 0's eval runs while the others wait at a barrier);
# ``init_process_group`` and ``launch`` take another as ``timeout_s``
DEFAULT_TIMEOUT_S = 1800.0

BACKENDS = ('nccl', 'gloo')


def fit_mesh_to_batch(batch_size: int, num_devices: int = 0) -> int:
    """Largest device count <= available that divides the batch (the batch
    dim must shard evenly; a bs-12 job on 8 GPUs runs data-parallel x4).
    ``num_devices`` 0 means every visible GPU (1 without one)."""
    avail = num_devices or max(torch.cuda.device_count(), 1)
    for n in range(min(avail, batch_size), 0, -1):
        if batch_size % n == 0:
            return n
    return 1


def pad_batch_to_devices(batch_size: int, n_devices: int) -> int:
    """Smallest batch >= batch_size divisible by the mesh size."""
    rem = batch_size % n_devices
    return batch_size if rem == 0 else batch_size + (n_devices - rem)


def mesh_shape(data_devices: int, batch_size: int, spatial: int, avail: int):
    """(n_data, n_space) of a run, JAX's budget: ``system.data_devices`` (0:
    ``avail``) is the TOTAL rank count, the data axis takes the largest
    count <= it / ``train.spatial`` that divides the batch, and the space
    axis ``train.spatial`` (0 or 1: no spatial axis)."""
    n_space = max(int(spatial), 1)
    budget = data_devices or avail
    return fit_mesh_to_batch(batch_size, max(budget // n_space, 1)), n_space


def resolve_world(data_devices: int, batch_size: int, device='cuda', spatial: int = 0) -> int:
    """The ranks of ``system.data_devices`` x ``train.spatial``: on the card
    it counts GPUs (0: every visible one), on the CPU gloo processes (0:
    one); the data axis is capped by ``fit_mesh_to_batch``."""
    avail = torch.cuda.device_count() if torch.device(device).type == 'cuda' else 1
    n_data, n_space = mesh_shape(data_devices, batch_size, spatial, avail)
    return n_data * n_space


@dataclasses.dataclass
class SpatialCtx:
    """This rank's place in a (data x space) mesh and its groups: rank
    ``d * n_space + s`` holds rows [d*B/n_data, (d+1)*B/n_data) of every
    global batch and band ``s`` of its rows. Every band has the same
    height, so a band of ``h`` rows lies at global rows [s*h, (s+1)*h) of
    an activation ``n_space * h`` rows high (padded past its real height
    when ``rows`` is set)."""
    n_data: int
    n_space: int
    d: int
    s: int
    world: object       # every rank: BN moments, QAT observers, grads, metrics
    space: object       # the ranks of data shard d: halos, band sums
    data: object        # the ranks of band s: the in-batch gather of augmentation

    # the real height of the walk's input when the step padded it to
    # ``padded_height`` (0: not padded); the step sets it per batch on a copy
    rows: int = 0

    def offset(self, h: int) -> int:
        """Global row of this band's first row, for a band of ``h`` rows."""
        return self.s * h

    def padded_height(self, height: int, total_stride: int) -> int:
        """The rows an input ``height`` rows high is walked at: the next
        multiple of the bands x ``total_stride`` (``parallel/halo.py``)."""
        return padded_height(height, self.n_space, total_stride)


_MESHES = {}
_TIMEOUT = [None]       # the world's collective timeout, which the mesh's groups take


def make_mesh_2d(n_data: int, n_space: int) -> SpatialCtx:
    """The (data x space) mesh of the process group's ranks: rank ``r =
    d * n_space + s``. Every rank makes every group in the same order
    (``new_group`` is collective), once per process group and shape.
    Raises ``ValueError`` without a process group of ``n_data * n_space``
    ranks: a spatial run never falls back to one process."""
    need = n_data * n_space
    if not dist.is_initialized():
        raise ValueError(f'mesh {n_data}x{n_space} needs a process group of {need} ranks '
                         '(launch, run_ranks or torchrun); none is initialised')
    if world() != need:
        raise ValueError(f'mesh {n_data}x{n_space} needs {need} ranks, the process group has '
                         f'{world()}')
    key = (n_data, n_space)
    if key not in _MESHES:
        spaces = [dist.new_group([d * n_space + s for s in range(n_space)],
                                 timeout=_TIMEOUT[0]) for d in range(n_data)]
        datas = [dist.new_group([d * n_space + s for d in range(n_data)],
                                timeout=_TIMEOUT[0]) for s in range(n_space)]
        d, s = divmod(rank(), n_space)
        _MESHES[key] = SpatialCtx(n_data, n_space, d, s, dist.group.WORLD, spaces[d], datas[s])
    return _MESHES[key]


def spatial_batch_shardings(mesh: SpatialCtx, batch_size: int, height: int) -> dict:
    """This rank's slices of a global gt-mode batch, the port of JAX's
    per-leaf shardings: ``image`` (B, H, W, C) by data rows and band rows,
    ``gt`` (B, G, 6) by data rows only (replicated over the space axis)."""
    lb, hb = batch_size // mesh.n_data, height // mesh.n_space
    rows = slice(mesh.d * lb, (mesh.d + 1) * lb)
    return {'image': (rows, slice(mesh.s * hb, (mesh.s + 1) * hb)), 'gt': (rows,)}


# ------------------------------------------------------------- the group

def world(group=None) -> int:
    """Ranks in ``group`` (the default group when None); 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main(group=None) -> bool:
    return rank(group) == 0


def active_group():
    """The default group when it has more than one rank, else None: the
    ``group`` argument of the step and the walk, None meaning the
    one-process code."""
    return dist.group.WORLD if world() > 1 else None


def barrier(group=None):
    if world(group) > 1:
        dist.barrier(group)


def in_torchrun() -> bool:
    """Whether torchrun (or another launcher) set this process's rank."""
    return 'RANK' in os.environ and 'WORLD_SIZE' in os.environ


def single_host() -> bool:
    """Whether every rank of the group runs on this host (torchrun's
    ``LOCAL_WORLD_SIZE`` equals the world; ``launch`` spawns on one host)."""
    return int(os.environ.get('LOCAL_WORLD_SIZE', world())) == world()


def _rank_device(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != 'cuda':
        return torch.device('cpu')
    return torch.device('cuda', local_rank % max(torch.cuda.device_count(), 1))


def check_backend(backend: str, device, local_world: int):
    """Raise before any group is made if ``backend`` cannot serve
    ``local_world`` ranks of this host on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f'backend {backend!r} is not one of {BACKENDS}')
    if backend == 'nccl':
        if torch.device(device).type != 'cuda':
            raise ValueError('backend nccl needs CUDA devices; the CPU takes gloo')
        if not dist.is_nccl_available():
            raise RuntimeError('backend nccl is not available in this torch build')
        n = torch.cuda.device_count()
        if local_world > n:
            raise ValueError(f'backend nccl takes one GPU per rank: {local_world} ranks on '
                             f'{n} visible GPU(s) would share a device; use backend gloo '
                             'for ranks that share a card')
    elif not dist.is_gloo_available():
        raise RuntimeError('backend gloo is not available in this torch build')


def init_process_group(backend: Optional[str] = None, rank: Optional[int] = None,
                       world_size: Optional[int] = None, master_addr: Optional[str] = None,
                       master_port: Optional[int] = None, device='cuda',
                       local_rank: Optional[int] = None,
                       timeout_s: Optional[float] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    Arguments left None come from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``). ``backend``: nccl by default on the card, gloo on the
    CPU; an unavailable backend raises, and so do NCCL ranks that would
    share a GPU (before NCCL is initialised). On the card the rank takes
    ``cuda:{local_rank}`` (modulo the visible GPUs: gloo ranks may share
    one) as its current device. A collective that waits longer than
    ``timeout_s`` (a dead rank; default ``DEFAULT_TIMEOUT_S``) raises."""
    env = os.environ
    rank = int(env['RANK']) if rank is None else rank
    world_size = int(env['WORLD_SIZE']) if world_size is None else world_size
    local_rank = int(env.get('LOCAL_RANK', rank)) if local_rank is None else local_rank
    local_world = int(env.get('LOCAL_WORLD_SIZE', world_size))
    master_addr = master_addr or env.get('MASTER_ADDR', 'localhost')
    master_port = int(master_port or env['MASTER_PORT'])
    if backend is None:
        backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    check_backend(backend, device, local_world)
    dev = _rank_device(device, local_rank)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
    dist.init_process_group(backend, init_method=f'tcp://{master_addr}:{master_port}',
                            rank=rank, world_size=world_size, timeout=timeout)
    _TIMEOUT[0] = timeout
    return dev


def destroy_process_group():
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------ collectives

def all_reduce_mean_(flat: torch.Tensor, group=None,
                     shards: Optional[int] = None) -> torch.Tensor:
    """``flat`` replaced in place by its sum over the ranks of ``group``
    divided by ``shards`` (one all-reduce): the mean over the ranks by
    default, over the data shards under spatial partitioning, where the
    bands of a shard each hold a part of its sum. No collective at world
    size 1."""
    w = world(group)
    if w > 1:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(w if shards is None else shards)
    return flat


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the ranks' grads: the
    transpose of a psum is a psum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, differentiable: under
    autograd the backward pass all-reduces the grads it receives."""
    return _AllReduceSum.apply(t, group) if world(group) > 1 else t


def _flag_device():
    """Where a small collective's tensor lives: the current GPU under NCCL
    (which takes CUDA tensors only), the CPU under gloo."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def any_rank(flag: bool, group=None) -> bool:
    """Whether ``flag`` is set on any rank of ``group`` (one MAX
    all-reduce); ``flag`` itself at world size 1."""
    if world(group) == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s ``obj`` (any picklable value) on every rank of
    ``group``; ``obj`` itself at world size 1."""
    if world(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=group, device=_flag_device())
    return box[0]


def gather_objects(obj, group=None) -> list:
    """Every rank's ``obj``, in rank order, on every rank of ``group``."""
    if world(group) == 1:
        return [obj]
    out = [None] * world(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _tensor_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def broadcast_tree(tree, src: int = 0, group=None):
    """Every tensor of ``tree`` overwritten in place with rank ``src``'s, one
    broadcast per dtype (bools travel as bytes); other leaves (the
    optimizer's Python counts) are left as they are. Returns ``tree``."""
    if world(group) == 1:
        return tree
    by_dtype = {}
    for t in _tensor_leaves(tree):
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, leaves in by_dtype.items():
        views = [t.view(torch.uint8) if dtype == torch.bool else t for t in leaves]
        flat = torch.cat([v.reshape(-1) for v in views])
        dist.broadcast(flat, src, group=group)
        for v, part in zip(views, torch.split(flat, [v.numel() for v in views])):
            v.copy_(part.view(v.shape))
    return tree


def all_gather_batch(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equal-shaped ``t`` concatenated along dim 0 in rank
    order: the global batch from the local shards."""
    w = world(group)
    if w == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(w)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


# ------------------------------------------------------------------ launch

def free_port() -> int:
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, fn: Callable, world_size: int, device, backend: str,
               port: int, timeout_s: Optional[float], args: Sequence):
    """One spawned rank: its share of the host's CPU threads, the group,
    ``fn(device, *args)``, and the group's end."""
    torch.set_num_threads(max((os.cpu_count() or 1) // world_size, 1))
    dev = init_process_group(backend, rank=local_rank, world_size=world_size,
                             master_addr='localhost', master_port=port, device=device,
                             local_rank=local_rank, timeout_s=timeout_s)
    try:
        fn(dev, *args)
    finally:
        destroy_process_group()


def launch(fn: Callable, world_size: int, device='cuda', backend: Optional[str] = None,
           args: Sequence = (), timeout_s: Optional[float] = None):
    """Run ``fn(rank_device, *args)`` in ``world_size`` spawned processes,
    rank r on ``cuda:{r}`` (gloo ranks beyond the visible GPUs share them)
    or the CPU, each in the default group on a free localhost port.
    ``fn`` must be picklable (a module-level function). Returns when every
    rank has ended; a rank that raises or exits non-zero ends the others
    and makes ``launch`` raise."""
    import torch.multiprocessing as mp
    if backend is None:
        backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    check_backend(backend, device, world_size)
    mp.start_processes(_rank_main, args=(fn, world_size, device, backend, free_port(),
                                         timeout_s, tuple(args)),
                       nprocs=world_size, join=True, start_method='spawn')


def add_dist_args(parser):
    """The entry points' ``--dist-backend``."""
    parser.add_argument('--dist-backend', default=None, choices=BACKENDS,
                        help='collective backend of data-parallel ranks (default: nccl on '
                             'the card, gloo on the CPU)')


def run_ranks(rank_fn: Callable, cfg, device, backend: Optional[str] = None,
              args: Sequence = ()):
    """``rank_fn(device, cfg, *args)`` as an entry point runs it: in this
    process, joined to torchrun's group when its environment is set, or in
    one spawned rank per GPU (per process on the CPU) when
    ``system.data_devices`` x ``train.spatial`` resolves to more than one
    (``launch``)."""
    if in_torchrun():
        dev = init_process_group(backend, device=device)
        try:
            return rank_fn(dev, cfg, *args)
        finally:
            destroy_process_group()
    world_size = resolve_world(cfg.system.data_devices, cfg.train.batch_size, device,
                               cfg.train.spatial)
    if world_size > 1:
        return launch(rank_fn, world_size, device, backend, (cfg, *args))
    return rank_fn(device, cfg, *args)
