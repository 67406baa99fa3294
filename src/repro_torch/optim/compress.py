"""Int8 gradient compression with error feedback, for the slow leg of a
hierarchical gradient reduction (counterpart of ``repro/optim/compress.py``).

Design, the JAX package's:
    1. an all-reduce within the fast group in full precision,
    2. int8 quantization (per 256-block absmax scales) + an error-feedback
       residual,
    3. a sum across the slow group of the int8 payload (as int32, so it
       cannot overflow),
    4. dequantization.

The shard_map axis names of the JAX function become two
``torch.distributed`` process groups: ``fast_group`` (the ranks one fast
link joins) and ``slow_group`` (one rank of each fast group).
:func:`quantize` and :func:`dequantize` are pure and run anywhere.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

Tensor = torch.Tensor

BLOCK = 256


class Quantized(NamedTuple):
    q: Tensor        # int8 payload, (n_blocks, BLOCK)
    scale: Tensor    # (n_blocks,) fp32 absmax scales
    n: int           # original length


def _blocks(flat: Tensor) -> Tensor:
    return F.pad(flat, (0, (-flat.shape[0]) % BLOCK)).view(-1, BLOCK)


def _quantize_blocks(fp: Tensor, scale: Tensor) -> Tensor:
    return torch.clamp(torch.round(fp / scale[:, None]), -127, 127).to(torch.int8)


def quantize(x: Tensor) -> Tuple[Quantized, Tensor]:
    """Returns (quantized, residual). x is flattened; blocks of 256."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    fp = _blocks(flat)
    scale = fp.abs().amax(1) / 127.0 + 1e-12
    q = _quantize_blocks(fp, scale)
    deq = (q.float() * scale[:, None]).reshape(-1)[:n]
    residual = (flat - deq).reshape(x.shape).to(x.dtype)
    return Quantized(q, scale, n), residual


def dequantize(qt: Quantized, shape, dtype) -> Tensor:
    deq = (qt.q.float() * qt.scale[:, None]).reshape(-1)[: qt.n]
    return deq.reshape(shape).to(dtype)


def compressed_psum(grad: Tensor, error: Tensor, *, fast_group, slow_group):
    """Hierarchical error-feedback sum over every rank of both groups.

    ``error`` is this rank's running error-feedback buffer (the shape of
    ``grad``); returns (reduced_grad, new_error). Every rank of the slow
    group must agree on ONE scale a block before the int8 payloads are
    summed (sum q_p s_p is not (sum q_p) mean s_p): a MAX all-reduce of the
    block absmaxes (a small fp32 vector, n/256 elements) sets it.
    """
    g = grad.clone()
    dist.all_reduce(g, group=fast_group)                  # full precision, fast links
    g = g + error                                         # error feedback
    flat = g.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    fp = _blocks(flat)
    absmax = fp.abs().amax(1)
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=slow_group)
    scale = absmax / 127.0 + 1e-12
    q = _quantize_blocks(fp, scale)
    local_deq = (q.float() * scale[:, None]).reshape(-1)[:n]
    residual = (flat - local_deq).reshape(grad.shape).to(grad.dtype)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=slow_group)               # the compressed slow leg
    deq = (qsum.float() * scale[:, None]).reshape(-1)[:n]
    return deq.reshape(grad.shape).to(grad.dtype), residual
