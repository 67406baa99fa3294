"""Flash attention for Hopper, beside its plain version (B11).

Counterpart of ``repro/kernels/flash_attention.py``: :func:`flash_attention`
replaces ``flash_attention_pallas`` (``flash_attention.py:76``). q, k and v
are (BH, S, hd), batch and heads folded together, of one dtype (float32,
bfloat16 or float16); the result is (BH, S, hd) in that dtype. Causal
masking keeps ``q_pos >= k_pos`` and fills -1e30, the softmax is the online
one over kv blocks with fp32 state, and the output is ``acc / max(l,
1e-30)``. There is no backward, as the JAX door has none.

Two routes on the card, by dtype, both on the tensor cores (``wgmma``) with
q, K and V brought in by TMA (their shared helpers in
``csrc/flash_attention_sm90.cuh``):

- float32: ``csrc/flash_attention_f32_sm90.cu``, both products as three
  TF32 products (3xTF32): each operand split explicitly into ``hi`` (its
  low 13 mantissa bits cleared) and ``lo = x - hi``, and ``a·b ~ a_hi·b_hi
  + a_hi·b_lo + a_lo·b_hi`` accumulated in fp32, about 2^-21 of each
  product off the fp32 one. q is scaled by ``1/sqrt(hd)`` before the
  product as the Pallas kernel scales it; V is written transposed into
  shared memory by the same pass that splits it (TF32 ``wgmma`` reads its
  operands K-major only).
- bfloat16 and float16: ``csrc/flash_attention_sm90.cu``. The scores are
  the fp32 sums of the exact 16-bit products, scaled after the product; p
  stays fp32 for the softmax and goes into p·v split in two 16-bit halves
  (``p_hi + p_lo``), so that the result keeps the fp32 p of the Pallas
  kernel to within one unit in the last place of the output.

TMA needs 16-byte aligned data: a q, k or v whose data pointer is not (a
view at an odd offset) is copied to an aligned buffer first, in every
dtype.

``S`` must be a multiple of ``block_q`` and of ``block_k`` (the JAX door's
assert), on every device. The plain version walks the kv blocks of
``block_k`` for each q block of ``block_q`` with the causal skip, as the
Pallas kernel does; the CUDA kernels use their own tiles, so on the card the
blocks change only the order of rounding. The kernels take head widths
``hd`` that are multiples of 8 up to 256; another ``hd`` raises
``ValueError`` on a CUDA tensor.

The door has no gradient: on the card its output is filled by a ``ctypes``
launch and carries no autograd history. So it raises ``RuntimeError``, on
every device, when grad mode is on and q, k or v requires grad; a model
differentiates B11 through ``repro_torch.models.layers._B11Attention``,
whose forward calls the door with grad off.

Dispatch: a CPU tensor runs :func:`flash_attention_plain`; a CUDA tensor
launches the kernel of its dtype on the current stream, counts it in
``flash_attention.launches`` (registered with the other wrappers in
:mod:`repro_torch.kernels`) and raises on a failed build or launch. Nothing
falls back. A ``FakeTensor`` (a dry-run's trace, on any device) launches
nothing and gets an output of the contract's shape and dtype; under a
counting mode (``launch.hlo_analysis.CountingMode``) the door reports its
:func:`work` once, whatever it runs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TMA_ALIGN = 16                       # bytes: TMA's rule for a tensor's address
MAX_HEAD_DIM = 256
NEG_INF = -1e30


def _check(q: Tensor, k: Tensor, v: Tensor, block_q: int, block_k: int) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, hd), got shape {tuple(q.shape)}")
    for x, what in ((k, "k"), (v, "v")):
        if x.shape != q.shape:
            raise ValueError(f"{what} has shape {tuple(x.shape)}, q {tuple(q.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"{what} is {x.dtype}, q {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{what} lies on {x.device}, q on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q, k and v must be one of {tuple(DTYPES)}, got {q.dtype}")
    s = q.shape[1]
    if block_q < 1 or block_k < 1 or s % block_q or s % block_k:
        raise ValueError(f"S = {s} must be a multiple of block_q = {block_q} and "
                         f"block_k = {block_k}")


def _check_cuda(q: Tensor, k: Tensor, v: Tensor) -> None:
    """The CUDA kernels' own limits: head widths, contiguous operands."""
    hd = q.shape[-1]
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head widths that are multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, got hd = {hd}")
    for x, what in ((q, "q"), (k, "k"), (v, "v")):
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def work(q: Tensor, causal: bool):
    """(flops, bytes) of one call on (BH, S, hd) inputs: 4·hd flops a (q, k)
    pair the mask keeps (q·kᵀ and p·v, a multiply and an add each), and q,
    k, v and o each moved once."""
    bh, s, hd = q.shape
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    return 4 * hd * pairs, 4 * q.numel() * q.element_size()


def _accounted(q: Tensor, k: Tensor, v: Tensor, causal: bool, block_q: int,
               block_k: int) -> Tensor:
    """The door under a counting mode or on fake tensors: its :func:`work`
    reported once (``build.counted``); on a ``FakeTensor`` no launch and no
    plain version, only the output's shape and dtype (the CUDA kernels'
    limits checked for a fake CUDA tensor), else the door as usual."""
    with build.counted("flash_attention", *work(q, causal)):
        if not build.is_fake(q):
            return flash_attention(q, k, v, causal, block_q, block_k)
        if q.device.type == "cuda":
            _check_cuda(q, k, v)
        return q.new_empty(q.shape)


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                          block_q: int = 256, block_k: int = 256) -> Tensor:
    """The Pallas kernel's online softmax in plain torch, fp32 throughout:
    for each q block, the kv blocks up to the diagonal (causal) or all of
    them. Its products are ``torch.matmul`` in float32, which on a card is
    full fp32 while ``torch.backends.cuda.matmul.allow_tf32`` is False (the
    default)."""
    bh, s, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.float() * scale, k.float(), v.float()
    out = torch.empty((bh, s, hd), dtype=torch.float32, device=q.device)
    n_kv = s // block_k
    for qi in range(s // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        q_blk = qf[:, rows]
        q_pos = torch.arange(rows.start, rows.stop, device=q.device)[:, None]
        hi = min(((qi + 1) * block_q + block_k - 1) // block_k, n_kv) if causal else n_kv
        acc = torch.zeros((bh, block_q, hd), dtype=torch.float32, device=q.device)
        m = torch.full((bh, block_q, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((bh, block_q, 1), dtype=torch.float32, device=q.device)
        for kj in range(hi):
            cols = slice(kj * block_k, (kj + 1) * block_k)
            sc = torch.matmul(q_blk, kf[:, cols].transpose(1, 2))
            if causal:
                k_pos = torch.arange(cols.start, cols.stop, device=q.device)[None, :]
                sc = torch.where(q_pos >= k_pos, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=2, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=2, keepdim=True)
            acc = acc * corr + torch.matmul(p, vf[:, cols])
            m = m_new
        out[:, rows] = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    block_q: int = 256, block_k: int = 256) -> Tensor:
    """(BH, S, hd) q, k, v -> (BH, S, hd) attention output in q's dtype
    (B11)."""
    _check(q, k, v, block_q, block_k)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_attention has no gradient (the kernel's output carries no "
                           "autograd history): call it under torch.no_grad(), or differentiate "
                           "attention through repro_torch.models.layers.multihead_attention")
    if build.WORK_SINKS or build.is_fake(q):
        return _accounted(q, k, v, causal, block_q, block_k)
    if not build.on_cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal, block_q, block_k)
    _check_cuda(q, k, v)
    bh, s, hd = q.shape
    o = torch.empty((bh, s, hd), dtype=q.dtype, device=q.device)
    if not o.numel():
        return o
    q, k, v = (x if x.data_ptr() % TMA_ALIGN == 0 else x.clone() for x in (q, k, v))
    if q.dtype == torch.float32:
        build.raise_on(build.load("flash_attention_f32_sm90")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, hd, int(bool(causal)),
            build.stream(q)), "flash_attention_f32_sm90")
    else:
        build.raise_on(build.load("flash_attention_sm90")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, hd, int(bool(causal)),
            DTYPES[q.dtype], build.stream(q)), "flash_attention_sm90")
    flash_attention.launches += 1
    return o
