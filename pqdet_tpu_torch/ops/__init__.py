"""Ops: the kernels with their wrappers and plain versions, and the
plain pre- and post-processing around the forward."""

import torch


def refuse_autograd(name: str, *tensors):
    """Raise when grad mode is on and a tensor requires grad: the kernel of
    wrapper ``name`` has no backward (in the JAX package neither), so its
    output would carry no ``grad_fn`` and the gradient would be lost."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f'{name}: the kernel has no backward, and an input requires grad; run it '
            'under torch.no_grad() or torch.inference_mode(), or call its plain version')
