"""A minimal MLP as an `nn.Module`, and the mixed-precision product.

Weights are kept in the JAX package's `[in, out]` layout, so that
parameters carry across (`MLP.from_numpy`) with no transpose. Products
batch over any leading dims: `[batch, particle, features]` inputs stay
one matmul.

`compute_dtype='bfloat16'` is the mixed-precision lever of the deep
models (the VRNN), whose cost is MLP and GRU products: the parameters
stay float32 (the optimizer never sees bf16), the product's inputs are
rounded to bf16, and its output is float32 and never rounded, as the JAX
package's `preferred_element_type=float32` gives. Biases, activations
and everything downstream (log-weights, CDFs, resampling) stay float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import device as _device

# The activations by the JAX package's names (its models use 'tanh').
ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


def _dtype(compute_dtype) -> torch.dtype:
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, str(compute_dtype))


def _mm_float32(a, b):
    """``a @ b`` of two 2-d low-precision tensors with a float32 output.
    On the card `torch.mm`'s ``out_dtype`` multiplies the bf16 inputs on
    the tensor cores and writes float32. The CPU has no kernel for it:
    there the inputs are upcast, which multiplies the same rounded values
    in float32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _MixedMatmul(torch.autograd.Function):
    """``x @ w`` for 2-d float32 ``x`` and ``w`` with both rounded to
    ``dtype`` and a float32 output; the backward multiplies the same way
    (the cotangent rounded to ``dtype``), with float32 gradients."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        xl, wl = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(xl, wl)
        return _mm_float32(xl, wl)

    @staticmethod
    def backward(ctx, grad):
        xl, wl = ctx.saved_tensors
        gl = grad.to(xl.dtype)
        grad_x = _mm_float32(gl, wl.t()) if ctx.needs_input_grad[0] else None
        grad_w = _mm_float32(xl.t(), gl) if ctx.needs_input_grad[1] else None
        return grad_x, grad_w, None


def mixed_dot(x, w, compute_dtype: Optional[str] = None):
    """``x @ w`` over the last dim of ``x`` (any leading dims) and a
    `[in, out]` ``w``.

    With ``compute_dtype=None`` a float32 product (at the precision
    `torch.set_float32_matmul_precision` sets). With a dtype name such as
    'bfloat16' the inputs are rounded to it and the output is float32,
    never rounded to the low precision.
    """
    if compute_dtype is None:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    out = _MixedMatmul.apply(x.reshape(-1, x.shape[-1]), w,
                             _dtype(compute_dtype))
    return out.reshape(tuple(lead) + (w.shape[-1],))


class MLP(nn.Module):
    """Dense layers ``x -> act(x @ W_i + b_i)``, no activation after the
    last; ``weights[i]`` is `[in, out]` and ``biases[i]`` `[out]`.

    ``compute_dtype``: None (float32) or 'bfloat16' (bf16 product inputs,
    float32 output, biases and activations; see `mixed_dot`).
    """

    def __init__(self, weights: Sequence, biases: Sequence,
                 activation: Optional[str] = "tanh",
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if activation and activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of "
                             f"{sorted(ACTIVATIONS)} or None. currently = "
                             f"{activation}")
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(w, dtype=torch.float32))
             for w in weights])
        self.biases = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(b, dtype=torch.float32))
             for b in biases])
        self.activation = activation
        self.compute_dtype = compute_dtype

    @classmethod
    def create(cls, sizes: Sequence[int],
               generator: Optional[torch.Generator] = None,
               activation: Optional[str] = "tanh",
               compute_dtype: Optional[str] = None, device=None):
        """Layers of ``sizes`` (input first), weights uniform in
        +-1/sqrt(fan_in) from ``generator`` (a CPU `torch.Generator`;
        seed 0 if None), zero biases; on ``device`` (default: the card;
        raises without one)."""
        device = _device.resolve(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        weights, biases = [], []
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            bound = 1.0 / np.sqrt(fan_in)
            u = torch.rand((fan_in, fan_out), generator=generator)
            weights.append((2.0 * u - 1.0) * bound)
            biases.append(torch.zeros((fan_out,)))
        return cls(weights, biases, activation, compute_dtype).to(device)

    @classmethod
    def from_numpy(cls, weights: Sequence, biases: Sequence,
                   activation: Optional[str] = "tanh",
                   compute_dtype: Optional[str] = None, device=None):
        """An MLP holding copies of numpy ``weights`` (`[in, out]` each) and
        ``biases``, e.g. a JAX `MLP`'s leaves, on ``device`` (default: the
        card; raises without one)."""
        device = _device.resolve(device)
        return cls([np.array(w, dtype=np.float32) for w in weights],
                   [np.array(b, dtype=np.float32) for b in biases],
                   activation, compute_dtype).to(device)

    def forward(self, x):
        act = ACTIVATIONS[self.activation] if self.activation else None
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = mixed_dot(x, w, self.compute_dtype) + b
            if act is not None and i < n - 1:
                x = act(x)
        return x
