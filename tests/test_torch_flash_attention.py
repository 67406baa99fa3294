"""Flash attention (B11): the port's door against the JAX door.

On the CPU the door ``repro_torch.kernels.ops.flash_attention`` runs the
plain version, so these tests hold it against
``repro.kernels.ops.flash_attention`` in Pallas interpret mode (as
``tests/test_kernels.py`` runs it) and against the JAX oracle, on the same
numpy inputs, at the JAX tests' tolerances: 2e-4 in float32, 5e-2 in
bfloat16. Both sides compute in float32 from the same inputs, so a bfloat16
or float16 result is held within one unit in its last place as well. The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``."""

import ctypes
import functools
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jkops
from repro.kernels import ref as jref
import repro_torch.kernels as kernels
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import ref as tref

import _torch_threads

_torch_threads.pin()

CSRC = Path(fa.__file__).resolve().parent / "csrc"
_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


def _qkv(bh, s, hd, seed, bf16=False):
    """q, k, v float32 arrays; for bf16 the float32 values of bf16-rounded
    ones, so that both sides start from the same numbers."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(bh, s, hd).astype(np.float32) for _ in range(3)]
    if bf16:
        arrs = [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) for a in arrs]
    return arrs


# mantissa bits of the half-precision outputs
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def _assert_within_one_ulp(got: torch.Tensor, want: np.ndarray):
    """``got`` (bfloat16 or float16) within the JAX tests' 5e-2 and within
    one unit in the last place of the larger of each pair, plus 1e-5 for the
    float32 rounding the two sides may differ by."""
    g = got.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(g, want, atol=5e-2)
    limit = 2.0 ** -MANTISSA[got.dtype] * np.maximum(np.abs(g), np.abs(want)) + 1e-5
    assert (np.abs(g - want) <= limit).all(), np.abs(g - want).max()


# the four parametrisations of tests/test_kernels.py, and one non-causal
# case at danube's head width with block_k > block_q
@pytest.mark.parametrize("s,hd,causal,bq,bk", [
    (256, 64, True, 64, 64),
    (512, 128, True, 128, 64),
    (256, 64, False, 64, 128),
    (512, 32, True, 256, 256),
    (256, 80, False, 64, 256),
])
def test_door_vs_pallas_float32(s, hd, causal, bq, bk):
    q, k, v = _qkv(3, s, hd, s + hd)
    want = jkops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                 block_q=bq, block_k=bk)
    got = tkops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == torch.float32 and got.shape == (3, s, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_door_vs_pallas_bfloat16():
    q, k, v = _qkv(2, 256, 64, 0, bf16=True)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jkops.flash_attention(jq, jk, jv, causal=True, block_q=64, block_k=64)
    got = tkops.flash_attention(*(tensor_from_numpy(np.asarray(a)) for a in (jq, jk, jv)),
                                causal=True, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    _assert_within_one_ulp(got, want)
    _assert_within_one_ulp(got, jref.flash_attention_ref(jq, jk, jv, causal=True))


def test_bfloat16_output_crosses_bitwise():
    """``tensor_from_numpy`` carries a bf16 JAX result into the port with its
    bits, so the port's ops can start from the JAX package's state."""
    q, k, v = _qkv(2, 128, 32, 1, bf16=True)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    out = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=False))
    t = tensor_from_numpy(out)
    assert t.dtype == torch.bfloat16 and t.shape == out.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), out.view(np.int16))
    f = tensor_from_numpy(np.asarray(jnp.asarray(q)), device="cpu")
    assert f.dtype == torch.float32 and torch.equal(f, torch.from_numpy(q))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,hd", [(128, 64), (96, 80)])
def test_ref_vs_jax_ref(s, hd, causal):
    q, k, v = _qkv(2, s, hd, s * hd)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,hd,blocks", [
    (256, 64, ((64, 64), (128, 64), (64, 128), (256, 256))),
    (96, 40, ((24, 24), (32, 96), (96, 16))),
])
def test_plain_vs_ref_any_blocks(s, hd, blocks, causal):
    """The plain version equals the naive oracle, and its blocks change only
    the fp32 rounding."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, s, hd, 7))
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    outs = [fa.flash_attention_plain(q, k, v, causal, bq, bk) for bq, bk in blocks]
    for out in outs:
        torch.testing.assert_close(out, want, atol=2e-4, rtol=0)
        torch.testing.assert_close(out, outs[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_low_precision_in_and_out(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(2, 64, 32, 3))
    out = tkops.flash_attention(q, k, v, block_q=32, block_k=16)
    assert out.dtype == dtype
    _assert_within_one_ulp(out, tref.flash_attention_ref(q, k, v).float().numpy())


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,kw,match", [
    ((_t((2, 100, 8)),) * 3, dict(block_q=64, block_k=50), "multiple of block_q"),
    ((_t((2, 128, 8)),) * 3, dict(block_q=64, block_k=96), "multiple of block_q"),
    ((_t((2, 128, 8)),) * 3, dict(block_q=0), "multiple of block_q"),
    ((_t((2, 64, 8)), _t((2, 32, 8)), _t((2, 64, 8))), {}, "k has shape"),
    ((_t((2, 64, 8)), _t((2, 64, 8)), _t((1, 64, 8))), {}, "v has shape"),
    ((_t((2, 64, 8)), _t((2, 64, 8), torch.bfloat16), _t((2, 64, 8))), {}, "k is torch.bfloat16"),
    ((_t((2, 64, 8), torch.int32),) * 3, {}, "must be one of"),
    ((_t((64, 8)),) * 3, {}, r"\(BH, S, hd\)"),
], ids=["s-not-block_k", "s-not-block_k-larger", "zero-block", "k-shape", "v-shape", "k-dtype",
        "int-dtype", "two-dims"])
def test_door_rejects(args, kw, match):
    with pytest.raises(ValueError, match=match):
        tkops.flash_attention(*args, **kw)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    kernels.reset_launches()
    q = torch.randn(1, 16, 8)
    assert torch.equal(fa.flash_attention(q, q, q, block_q=8, block_k=8),
                       fa.flash_attention_plain(q, q, q, True, 8, 8))
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention in kernels.KERNELS
    assert kernels.replaces("flash_attention") == "src/repro/kernels/flash_attention.py:76"


def test_other_devices_raise():
    q = torch.empty((1, 16, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        fa.flash_attention(q, q, q, block_q=8, block_k=8)


def test_kernel_source_carries_its_note():
    """The float32 route's source names the Pallas function it replaces and
    its 495 TFLOP/s bound, takes both products as TF32 ``wgmma`` with the
    explicit hi / lo split, uses the accurate ``exp2f``, and declares the
    entry point ``build`` binds with its nine arguments."""
    text = (CSRC / "flash_attention_f32_sm90.cu").read_text()
    for name in ("flash_attention_pallas (src/repro/kernels/flash_attention.py:76)",
                 "flash_attention_ref (src/repro/kernels/ref.py:110)",
                 "Bound: operations", "495 TFLOP/s", "3.35 TB/s", "wgmma.mma_async",
                 ".tf32.tf32", "0xffffe000", "a_hi·b_hi + a_hi·b_lo + a_lo·b_hi",
                 "(0, 2, 4, 6,\n//   1, 3, 5, 7)", '#include "flash_attention_sm90.cuh"'):
        assert name in text, name
    assert "__expf" not in text and "__exp2f" not in text and re.search(r"\bexp2f\(", text)
    symbol, argtypes = build.ENTRY_POINTS["flash_attention_f32_sm90"]
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text).group(1).split(",")
    assert len(params) == len(argtypes) == 9
    assert [("*" in a) for a in params] == [t is ctypes.c_void_p for t in argtypes]
    assert "flash_attention_f32_sm90" in build.SOURCES and "flash_attention" not in build.SOURCES
    assert not (CSRC / "flash_attention.cu").exists()
    assert "--use_fast_math" not in build.NVCC_FLAGS


def test_sm90_source_carries_its_note():
    """The tensor-core route's source names the Pallas function it replaces
    and its bound, uses the accurate ``exp2f``, splits p, and declares the
    entry point ``build`` binds with its ten arguments."""
    text = (CSRC / "flash_attention_sm90.cu").read_text()
    assert '#include "flash_attention_sm90.cuh"' in text
    text += (CSRC / "flash_attention_sm90.cuh").read_text()     # the helpers both routes share
    assert "flash_attention_sm90.cuh" in build.HEADERS
    for name in ("flash_attention_pallas (src/repro/kernels/flash_attention.py:76)",
                 "flash_attention_ref (src/repro/kernels/ref.py:110)",
                 "Bound: operations", "989 TFLOP/s", "3.35 TB/s", "p_hi", "p_lo",
                 "wgmma.mma_async", "cp.async.bulk.tensor.3d", "mbarrier"):
        assert name in text
    assert "__expf" not in text and "__exp2f" not in text and re.search(r"\bexp2f\(", text)
    symbol, argtypes = build.ENTRY_POINTS["flash_attention_sm90"]
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text).group(1).split(",")
    assert len(params) == len(argtypes) == 10
    pointer = [("*" in a) for a in params]
    assert pointer == [t is ctypes.c_void_p for t in argtypes]
    assert "flash_attention_sm90" in build.SOURCES


def _route_arithmetic(q, k, v, split, tile_q=128, tile_k=64):
    """The tensor-core route's arithmetic in plain torch, causal: q·kᵀ of the
    16-bit values with fp32 sums (their products are exact in fp32), scaled
    after the product by log2(e)/sqrt(hd), the online softmax in fp32 with
    exp2 over kv tiles up to the diagonal, l from the fp32 p, and p·v from
    p split in two 16-bit halves (``split``) or rounded once to 16 bits."""
    dt = q.dtype
    bh, s, hd = q.shape
    scale = torch.tensor(math.log2(math.e) / math.sqrt(hd), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((bh, s, hd), dtype=torch.float32)
    for q0 in range(0, s, tile_q):
        rows = slice(q0, min(q0 + tile_q, s))
        q_pos = torch.arange(rows.start, rows.stop)[:, None]
        m = torch.full((bh, rows.stop - q0, 1), fa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((bh, rows.stop - q0, hd))
        for k0 in range(0, rows.stop, tile_k):
            cols = slice(k0, min(k0 + tile_k, s))
            sc = torch.matmul(qf[:, rows], kf[:, cols].transpose(1, 2)) * scale
            sc = torch.where(q_pos >= torch.arange(cols.start, cols.stop)[None, :], sc, fa.NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=2, keepdim=True))
            p = torch.exp2(sc - m_new)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(dim=2, keepdim=True)
            hi = p.to(dt).float()
            pv = torch.matmul(hi, vf[:, cols])
            if split:
                pv = pv + torch.matmul((p - hi).to(dt).float(), vf[:, cols])
            acc = acc * corr + pv
            m = m_new
        out[:, rows] = acc / torch.clamp(l, min=1e-30)
    return out.to(dt)


def _worst_share(got, want):
    """The worst share of chip_smoke.py's one-ulp limit over the elements."""
    dt = str(got.dtype).split(".")[1]
    g, w = got.float(), want.float()
    limit = torch.clamp(chip_smoke.ATTN_ULP[dt] * torch.maximum(g.abs(), w.abs())
                        + chip_smoke.ATTN_ATOL[dt], max=chip_smoke.ATTN_TOL[dt])
    return ((g - w).abs() / limit).max().item()


_ROUTE_CASES = [((2, 512, 64), torch.bfloat16), ((2, 512, 64), torch.float16),
                ((1, 1024, 128), torch.bfloat16), ((1, 1024, 128), torch.float16)]


def _route_inputs(shape, dtype):
    return [torch.from_numpy(a).to(dtype) for a in _qkv(*shape, seed=shape[1] + shape[2])]


@pytest.mark.parametrize("shape,dtype", _ROUTE_CASES)
def test_route_arithmetic_with_p_split_is_within_one_ulp(shape, dtype):
    """p split in hi + lo keeps the route within one unit in the last place
    of the fp32 plain version, the limit chip_smoke.py holds the kernel to."""
    q, k, v = _route_inputs(shape, dtype)
    want = fa.flash_attention_plain(q, k, v, True, 128, 128)
    assert _worst_share(_route_arithmetic(q, k, v, split=True), want) <= 1.0


@pytest.mark.parametrize("shape,dtype", _ROUTE_CASES)
def test_route_arithmetic_with_p_rounded_once_is_not(shape, dtype):
    """The same inputs with p rounded once to 16 bits pass the limit: the
    reason the kernel takes two p·v products."""
    q, k, v = _route_inputs(shape, dtype)
    want = fa.flash_attention_plain(q, k, v, True, 128, 128)
    assert _worst_share(_route_arithmetic(q, k, v, split=False), want) > 1.0


_TF32_HI = -(1 << 13)       # 0xffffe000 as an int32: sign, exponent, 10 mantissa bits
_KV_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]       # Vᵀ's columns in each group of 8 kv rows


def _tf32_split(x):
    """x split as the float32 route splits it: hi = x with its low 13
    mantissa bits cleared, lo = x - hi (exact in fp32), and lo truncated to
    TF32 as well (the worse of the ways a tensor core may read it)."""
    hi = (x.view(torch.int32) & _TF32_HI).view(torch.float32)
    return hi, ((x - hi).view(torch.int32) & _TF32_HI).view(torch.float32)


def _f32_route_arithmetic(q, k, v, causal, products=3, tile_q=64, tile_k=32):
    """The float32 route's arithmetic in plain torch: q scaled in fp32 and
    split, K, p and V split; each product ``a_hi·b_lo + a_lo·b_hi +
    a_hi·b_hi`` (``products=3``) or ``a_hi·b_hi`` alone (``products=1``),
    summed in fp32 (a product of two TF32 values is exact in fp32); the
    kernel's 64 x 32 tiles with the causal stop at the diagonal tile; the
    online softmax in fp32 with exp2 of the scores times log2(e); p·v over
    each tile's kv in the kernel's order, (0, 2, 4, 6, 1, 3, 5, 7) in every
    group of 8, on both sides; l from the fp32 p."""
    bh, s, hd = q.shape
    qs = q * torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    (qh, ql), (kh, kl) = _tf32_split(qs), _tf32_split(k)
    order = torch.tensor([8 * (j // 8) + _KV_ORDER[j % 8] for j in range(tile_k)])

    def prod(ah, al, bh_, bl):
        out = torch.matmul(ah, bh_)
        return out if products == 1 else torch.matmul(ah, bl) + torch.matmul(al, bh_) + out

    n_kt = -(-s // tile_k)
    out = torch.empty((bh, s, hd), dtype=torch.float32)
    for q0 in range(0, s, tile_q):
        rows = slice(q0, min(q0 + tile_q, s))
        q_pos = torch.arange(rows.start, rows.stop)[:, None]
        kt_end = min(n_kt, (rows.stop - 1) // tile_k + 1) if causal else n_kt
        m = torch.full((bh, rows.stop - q0, 1), fa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((bh, rows.stop - q0, hd))
        for kt in range(kt_end):
            cols = slice(kt * tile_k, min((kt + 1) * tile_k, s))
            sc = prod(qh[:, rows], ql[:, rows], kh[:, cols].transpose(1, 2),
                      kl[:, cols].transpose(1, 2)) * log2e
            if causal:
                sc = torch.where(q_pos >= torch.arange(cols.start, cols.stop)[None, :], sc,
                                 fa.NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=2, keepdim=True))
            p = torch.exp2(sc - m_new)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(dim=2, keepdim=True)
            # the tile's kv rows past S are zeros in the kernel, as p there is 0
            pad = tile_k - p.shape[2]
            p_t = torch.nn.functional.pad(p, (0, pad))[:, :, order]
            v_t = torch.nn.functional.pad(v[:, cols], (0, 0, 0, pad))[:, order]
            acc = acc * corr + prod(*_tf32_split(p_t), *_tf32_split(v_t))
            m = m_new
        out[:, rows] = acc / torch.clamp(l, min=1e-30)
    return out


# the JAX tests' float32 shapes and block pairs (tests/test_kernels.py), on
# the inputs of test_door_vs_pallas_float32
_F32_ROUTE_CASES = [((3, 256, 64), True, 64, 64), ((3, 512, 128), True, 128, 64),
                    ((3, 256, 64), False, 64, 128), ((3, 512, 32), True, 256, 256)]


@functools.lru_cache(maxsize=None)
def _f32_route_case(i):
    """(q, k, v), causal and flash_attention_pallas's result in interpret
    mode for case i."""
    (bh, s, hd), causal, bq, bk = _F32_ROUTE_CASES[i]
    q, k, v = _qkv(bh, s, hd, s + hd)
    want = np.asarray(jkops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=causal, block_q=bq, block_k=bk))
    return tuple(torch.from_numpy(a) for a in (q, k, v)), causal, want


def _f32_route_err(i, products):
    (q, k, v), causal, want = _f32_route_case(i)
    return float(np.abs(_f32_route_arithmetic(q, k, v, causal, products).numpy() - want).max())


@pytest.mark.parametrize("case", range(len(_F32_ROUTE_CASES)))
def test_f32_route_arithmetic_is_within_2e4_with_tenfold_headroom(case):
    """Three TF32 products of explicitly split operands keep the route within
    a tenth of the 2e-4 float32 limit of the Pallas kernel (interpret mode)."""
    assert _f32_route_err(case, products=3) <= 2e-5


@pytest.mark.parametrize("case", range(len(_F32_ROUTE_CASES)))
def test_f32_route_single_tf32_product_is_ten_times_further_off(case):
    """``hi·hi`` alone is at least ten times further off the Pallas kernel
    than the three products: the reason the route takes three."""
    assert _f32_route_err(case, products=1) >= 10 * _f32_route_err(case, products=3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cpu_half_precision_takes_the_plain_version(dtype):
    """On the CPU a 16-bit call runs the plain version, never the tensor-core
    route, and counts no launch."""
    kernels.reset_launches()
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(2, 64, 16, 5))
    got = fa.flash_attention(q, k, v, block_q=32, block_k=32)
    assert got.dtype == dtype
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, True, 32, 32))
    assert fa.flash_attention.launches == 0
