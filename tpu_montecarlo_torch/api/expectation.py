"""Differentiable expectations, 1-D and nd (port of ``expectation_fn``,
``tpu_montecarlo/api/integrate.py:301-405``).

The JAX package returns a pure function of the family parameters over
its XLA sweep, and ``jax.grad`` differentiates that sweep: the pathwise
(reparameterisation) gradient ``(1/n) sum_i f'(x_i) dx_i/dtheta``, the
base uniforms independent of the parameters.  The port has no XLA twin,
and autograd through the plain version would hold every sample, so the
estimator is a ``torch.autograd.Function`` over the kernels:

* without ``requires_grad`` it launches the value build, the very launch
  ``integrate`` makes: its values are ``integrate``'s bit for bit;
* with ``requires_grad`` it launches the gradient build of the same
  kernel once per group of functions (``IntegrateConfig.grad``,
  ``NdConfig.grad``), which sums the K values (the value build's, bit
  for bit) and the K x 2 (nd: K x d x 2) pathwise sums in one pass over
  the stream, and keeps their means, the Jacobian J; the backward pass
  is ``grad_output @ J``.

Second-order gradients and ``torch.func.vmap`` of an estimator, which
``jax.grad`` and ``jax.vmap`` give the JAX package's, raise naming
ROADMAP item 10.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..utils.roadmap import API_SURFACE, not_ported
from .passes import build_all

__all__ = ["estimator"]


class _Estimate(torch.autograd.Function):
    """``(values, J)`` of the parameters: the value build's means, or with
    ``want_grad`` the gradient build's means and Jacobian (J is not
    differentiable; the backward pass contracts it)."""

    @staticmethod
    def forward(params, value, grad, want_grad):
        if want_grad:
            return grad(params.detach())
        values = value(params.detach())
        return values, values.new_zeros(0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])
        ctx.param_like = (inputs[0].dtype, inputs[0].device)

    @staticmethod
    def backward(ctx, grad_values, _):
        if torch.is_grad_enabled():
            raise not_ported(
                "a second-order gradient of an expectation_fn estimator",
                API_SURFACE)
        (jac,) = ctx.saved_tensors
        dtype, device = ctx.param_like
        g = torch.tensordot(grad_values.to(jac.dtype), jac, dims=1)
        return g.to(dtype=dtype, device=device), None, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        raise not_ported("torch.func.vmap of an expectation_fn estimator",
                         API_SURFACE)


def estimator(shape: tuple, message: str, value: Callable, grad: Callable,
              builds: Sequence[Callable]) -> Callable:
    """``est(params, seed=42) -> (K,)`` over ``value(row, word)`` and
    ``grad(row, word)`` (the value build's means; the gradient build's
    means and Jacobian), ``params`` of ``shape`` (else ``ValueError`` with
    ``message`` and the shape), ``builds`` the kernels' libraries, built
    here in parallel."""
    if builds:
        build_all(builds)

    def est(params, seed: int = 42):
        if not isinstance(params, torch.Tensor):
            params = torch.as_tensor(np.asarray(params, np.float32))
        if tuple(params.shape) != shape:
            raise ValueError(f"{message}, got shape {tuple(params.shape)}")
        # np.uint32 rejects seeds outside [0, 2**32), as the JAX package
        # does.
        word = int(np.uint32(seed))
        want_grad = params.requires_grad and torch.is_grad_enabled()
        values, _ = _Estimate.apply(
            params, lambda row: value(row, word),
            lambda row: grad(row, word), want_grad)
        return values

    return est
