"""The rounding points of the tensor-core routes, held against the JAX
package on the CPU.

The bf16 routes of K1 (flash prefill), K2 (decode) and K3 (SSD chunk
scan) multiply bf16 operands on the tensor cores with f32 sums. A CUDA
kernel cannot run here, so each is emulated in plain PyTorch with the same
rounding points and held against the TPU kernel in interpret mode (and,
for K2, the plain version; for K3, the token-by-token recurrence), as
tests/test_kernels.py holds the TPU kernel:

- K1 rounds the unnormalised probabilities P to bf16 before P V, as the
  TPU kernel does (``p.astype(v.dtype)``); bf16 tolerance 5e-2.
- K2 splits the key axis, and each warp of each split rounds its P to bf16
  relative to its own running max, where the TPU kernel has one running
  max over the whole cache; the partials combine in f32 by the log-sum-exp
  rule. bf16 tolerance 5e-2.
- K3 keeps its y path f32 by splitting each f32 operand of a product (the
  masked scores, the carried state, B w) into hi = bf16(v) and
  lo = bf16(v - hi), two products each; y is rounded once at the store.
  Tolerances y 2e-2, state 1e-2. Rounding those operands to hi alone
  breaks the state tolerance, so a test keeps the lo half in.

Inputs are made with numpy from a seed and handed to both packages. These
emulations live here only; no package module uses them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.ssd import ssd_chunk_scan
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

NEG_INF = -1e30
SUB = 32                   # K1's keys per online-softmax step


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(v, lo: bool = True):
    """hi + lo as K3 forms it (exact in f32), or hi alone."""
    hi = _bf16(v)
    return hi + _bf16(v - hi) if lo else hi


def _pair(arr, dtype="bfloat16"):
    """The same values as a JAX array and an f32 torch tensor, rounded to
    ``dtype`` on both sides."""
    arr = np.asarray(arr, np.float32)
    j = jnp.asarray(arr).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(arr).to(getattr(torch, dtype)).float()


# ------------------------------------------------------------------- K3

def emulate_ssd(x, dt, A, B, C, *, chunk: int, lo: bool = True):
    """K3's bf16 route: x, B, C bf16 values; returns (y before its bf16
    store, final state), both f32."""
    b, s, h, p = x.shape
    Bf, Cf = B[:, :, 0].float(), C[:, :, 0].float()
    S = torch.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t0 in range(0, s, chunk):
        lc = min(chunk, s - t0)
        xs = x[:, t0:t0 + lc].float()                       # (b, l, h, p)
        d = dt[:, t0:t0 + lc].float()                       # (b, l, h)
        cs = torch.cumsum(d * A, dim=1)
        Bc, Cc = Bf[:, t0:t0 + lc], Cf[:, t0:t0 + lc]       # (b, l, n)
        # carried term: exp(cs_i) C_i (S_hi + S_lo)^T
        y = torch.einsum("bin,bhpn->bihp", Cc, _split(S, lo)) \
            * torch.exp(cs)[..., None]
        # G = C B^T, scaled where j <= i, split, times x
        G = torch.einsum("bin,bjn->bij", Cc, Bc)
        tril = torch.ones(lc, lc, dtype=torch.bool).tril()[None, :, :, None]
        seg = torch.where(tril, cs[:, :, None, :] - cs[:, None, :, :],
                          float("-inf"))
        M = G[..., None] * torch.exp(seg) * d[:, None, :, :]   # (b,i,j,h)
        y = y + torch.einsum("bijh,bjhp->bihp", _split(M, lo), xs)
        ys.append(y)
        # S = S exp(cs_last) + x^T (B w)
        w = torch.exp(cs[:, -1:] - cs) * d                  # (b, l, h)
        Bw = Bc[:, :, None, :] * w[..., None]               # (b, l, h, n)
        S = S * torch.exp(cs[:, -1])[..., None, None] \
            + torch.einsum("blhp,blhn->bhpn", xs, _split(Bw, lo))
    return torch.cat(ys, 1), S


def _ssd_inputs(b, s, h, p, n, seed=4):
    """x, B, C bf16 (the tensor-core route); dt, A f32."""
    rng = np.random.default_rng(seed)
    x = _pair(rng.standard_normal((b, s, h, p)))
    dt = _pair(np.log1p(np.exp(rng.standard_normal((b, s, h)))), "float32")
    A = _pair(-np.exp(rng.standard_normal(h)), "float32")
    B = _pair(rng.standard_normal((b, s, 1, n)))
    C = _pair(rng.standard_normal((b, s, 1, n)))
    return x, dt, A, B, C


def _np(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


SSD_SHAPES = [(1, 64, 2, 16, 32, 16), (2, 96, 4, 8, 16, 32),
              (1, 72, 2, 8, 16, 24),          # those of tests/test_kernels.py
              (1, 512, 2, 64, 128, 256)]      # mamba2's widths and chunk
Y_TOL, STATE_TOL = dict(rtol=2e-2, atol=2e-2), dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_split_emulation_matches_jax_kernel_and_recurrence(b, s, h, p, n,
                                                               chunk):
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = \
        _ssd_inputs(b, s, h, p, n)
    y, st = emulate_ssd(tx, tdt, tA, tB, tC, chunk=chunk)
    y = _bf16(y)                                   # the one rounding of y
    ky, kst = ssd_chunk_scan(jx, jdt, jA, jB, jC, chunk=chunk,
                             interpret=True)
    np.testing.assert_allclose(_np(y), _np(ky), **Y_TOL)
    np.testing.assert_allclose(_np(st), _np(kst), **STATE_TOL)
    f32 = [j.astype(jnp.float32) for j in (jx, jB, jC)]
    ny, nst = jref.ref_ssd_naive(f32[0], jdt, jA, f32[1], f32[2])
    np.testing.assert_allclose(_np(y), _np(ny), **Y_TOL)
    np.testing.assert_allclose(_np(st), _np(nst), **STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_lo_half_is_needed(b, s, h, p, n, chunk):
    """The split's y before the store is at least 100x closer to the f32
    scan than hi alone (280-880x at these inputs), and its state within
    1e-3 of it (hi alone: 0.005-0.028, over the 1e-2 tolerance in three of
    the four shapes)."""
    tx, tdt, tA, tB, tC = [t for _, t in _ssd_inputs(b, s, h, p, n)]
    ye, ste = tref.ref_ssd(tx, tdt, tA, tB, tC, chunk=chunk)   # f32 path
    errs = {}
    for lo in (True, False):
        y, st = emulate_ssd(tx, tdt, tA, tB, tC, chunk=chunk, lo=lo)
        errs[lo] = ((y - ye).abs().max().item(),
                    (st - ste).abs().max().item())
    assert errs[True][0] * 100 <= errs[False][0], errs
    assert errs[True][1] <= 1e-3, errs


# ------------------------------------------------------------------- K1

def emulate_flash(q, k, v, *, causal: bool = True):
    """K1's bf16 route: q (B,S,H,D), k, v (B,T,K,D) bf16 values. Online
    softmax in steps of 32 keys with f32 scores and sums; P rounded to bf16
    before P V; the output divided by l and rounded to bf16."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    kr = k.float().repeat_interleave(g, 2)
    vr = v.float().repeat_interleave(g, 2)
    qpos = torch.arange(s)[:, None]
    m = torch.full((b, h, s), NEG_INF)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, t, SUB):
        kt, vt = kr[:, k0:k0 + SUB], vr[:, k0:k0 + SUB]
        sc = torch.einsum("bshd,bthd->bhst", q.float(), kt) * d ** -0.5
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        if causal:
            sc = torch.where(kpos <= qpos, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhst,bthd->bhsd",
                                                    _bf16(p), vt)
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return _bf16(out.permute(0, 2, 1, 3))


@pytest.mark.parametrize("h,kh", [(4, 4), (14, 2)])     # g = 1 and 7
def test_flash_bf16_probabilities_match_jax_kernel(h, kh):
    rng = np.random.default_rng(0)
    b, s, d = 2, 128, 64
    (jq, tq), (jk, tk), (jv, tv) = [
        _pair(rng.standard_normal(shape))
        for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]
    g = h // kh
    expect = flash_attention_fwd(jq, jnp.repeat(jk, g, 2), jnp.repeat(jv, g, 2),
                                 causal=True, block_q=64, block_k=64,
                                 interpret=True)
    out = emulate_flash(tq, tk, tv)
    np.testing.assert_allclose(_np(out), _np(expect), rtol=5e-2, atol=5e-2)


# ------------------------------------------------------------------- K2

K2_WARP_KEYS = 16                  # a warp takes 16 keys at a time
K2_WARPS = 4                       # warps a block


def _lse_combine(parts):
    """Partials (m, l, acc) by the log-sum-exp rule; an empty partial
    (m = -1e30, l = 0, acc = 0) adds nothing."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp(p[0] - m) for p in parts]
    l = sum(p[1] * wi for p, wi in zip(parts, w))
    acc = sum(p[2] * wi[..., None] for p, wi in zip(parts, w))
    return m, l, acc


def emulate_decode_split(q, k, v, pos: int, splits: int):
    """K2's bf16 route: q (B,H,D), caches (B,T,K,D) bf16 values. The key
    axis is cut into ``splits`` slices of ceil(T / splits) keys, cut at
    pos; each slice is walked in chunks of 16 keys, warp w of the block's
    4 taking chunks w, w + 4, ... with its own online softmax (f32
    scores and running max, f32 l, P rounded to bf16 before P V); a
    block's warps, then the splits, combine by the log-sum-exp rule; the
    output is divided by l (a row with no key writes 0) and rounded to
    bf16."""
    b, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    kr = k.float().repeat_interleave(g, 2)
    vr = v.float().repeat_interleave(g, 2)
    qf = q.float()
    span = -(-t // splits)
    n_valid = min(pos + 1, t)
    blocks = []
    for s0 in range(0, splits * span, span):
        end = min(s0 + span, n_valid)
        parts = []
        for w in range(K2_WARPS):
            m = torch.full((b, h), NEG_INF)
            l = torch.zeros((b, h))
            acc = torch.zeros((b, h, d))
            for k0 in range(s0 + K2_WARP_KEYS * w, end,
                            K2_WARPS * K2_WARP_KEYS):
                k1 = min(k0 + K2_WARP_KEYS, end)
                sc = torch.einsum("bhd,bthd->bht", qf, kr[:, k0:k1]) \
                    * d ** -0.5
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bht,bthd->bhd", _bf16(p), vr[:, k0:k1])
                m = m_new
            parts.append((m, l, acc))
        blocks.append(_lse_combine(parts))
    _, l, acc = _lse_combine(blocks)
    return _bf16(acc / torch.where(l == 0, 1.0, l)[..., None])


@pytest.mark.parametrize("h,kh,t,pos,splits,d", [
    (4, 4, 192, 0, 8, 64),     # g = 1; pos 0: every split but the first empty
    (14, 2, 192, 0, 8, 64),    # g = 7
    (14, 2, 192, 23, 8, 64),   # pos on the last key of split 0 (span 24)
    (14, 2, 192, 24, 8, 64),   # ... and on the first key of split 1
    (4, 4, 192, 191, 8, 64),   # pos = T - 1
    (14, 2, 192, 191, 8, 64),  # qwen2's decode split at its last step
    (14, 2, 100, 99, 8, 64),   # T = 100: no split count divides it (span 13)
    (14, 2, 100, 51, 16, 64),  # span 7: a split shorter than a warp's chunk
    (14, 2, 512, 511, 2, 64),  # 4 chunks a warp: each warp's running max
    (14, 2, 512, 300, 2, 64),
    (14, 2, 1024, 1023, 2, 64),   # 8 chunks a warp
    (14, 2, 1024, 700, 2, 64),
    (8, 1, 192, 191, 8, 64),   # g = 8: one KV head
    (16, 1, 192, 100, 8, 64),  # g = 16: the m16 tile full
    (14, 2, 300, 299, 16, 64),    # span 19: one whole and one ragged chunk
    (14, 2, 256, 127, 16, 64),    # the upper half of the splits empty
    (14, 2, 192, 191, 8, 128),    # D = 128
    (14, 2, 192, 24, 8, 128),
    (4, 4, 100, 99, 8, 128),
    (14, 2, 512, 400, 2, 128),
])
def test_decode_split_emulation_matches_jax_kernel_and_plain(h, kh, t, pos,
                                                             splits, d):
    rng = np.random.default_rng(7)
    b = 2
    (jq, tq), (jk, tk), (jv, tv) = [
        _pair(3 * rng.standard_normal(shape))
        for shape in ((b, h, d), (b, t, kh, d), (b, t, kh, d))]
    out = emulate_decode_split(tq, tk, tv, pos, splits)
    assert torch.isfinite(out).all()
    expect = jops.decode_attention(jq, jk, jv, pos, block_k=64)
    np.testing.assert_allclose(_np(out), _np(expect), rtol=5e-2, atol=5e-2)
    plain = tref.ref_decode_attention(tq.to(torch.bfloat16),
                                      tk.to(torch.bfloat16),
                                      tv.to(torch.bfloat16), pos)
    np.testing.assert_allclose(_np(out), _np(plain), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("b,kh,t,sms,splits", [
    (16, 2, 192, 132, 8),      # qwen2 decode: 256 blocks of 24 keys
    (16, 2, 4096, 132, 8),     # long context: 256 blocks of 512 keys
    (1, 2, 8192, 132, 16),     # the long-tail straggler: a cluster of 16
    (2, 2, 192, 132, 8),       # stops at 16 keys a split (span 24)
    (64, 2, 192, 132, 2),      # a wide batch fills the card with few
    (1, 1, 20, 132, 1),        # too short to split
])
def test_decode_splits_fill_the_card(b, kh, t, sms, splits):
    """The split count comes from the batch, the KV heads and the cache
    capacity (never the decode position), covers the SMs where the cache
    is long enough, and fits one cluster."""
    got = tdec.splits_for(b, kh, t, sms)
    assert got == splits
    assert 1 <= got <= tdec.MAX_SPLITS
    assert got == 1 or -(-t // got) >= tdec.CHUNK
