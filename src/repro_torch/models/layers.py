"""Dense building blocks in PyTorch: RMS and layer norms, RoPE and
whisper's sinusoidal positions, GQA attention with QKV bias / qk-norm,
sliding window and logit softcap, and cross-attention over a separate
key/value input or, in a decode step, over precomputed cross K/V; gated MLPs (SiLU or tanh-approximate GELU) and whisper's
plain biased MLP, tied embeddings with gemma's scale and final softcap,
and the layer-group rematerialisation of ``cfg.remat``.

Plain functions on tensors; parameters are nested dicts built from the
``*_param_specs`` declarations, with the JAX package's layouts and
canonical keys. With a :class:`Ctx` (a mesh of several devices and the
sharding rules: a node group's (1, n) slice, or a mesh with ``data`` and
``pod`` rows, each row running the program below on its block of the
batch, leaves split over ``data`` gathered where they are used by
:meth:`Ctx.view`) :func:`embed_apply`, :func:`attn_apply`,
:func:`cross_decode`, :func:`mlp_apply` and :func:`unembed_apply` run
tensor-parallel over the slice: the parameters are
``models/sharding.py``'s ``Sharded`` leaves, an activation is a list of
per-device tensors, and each device computes with its local tensors
(Megatron's layout, which the reference's GSPMD derives from the same
specs): column-parallel Q/K/V and MLP input projections (a
cross-attention's K/V from the key/value input every device holds), K1
and K2 at each device's local heads, row-parallel output projections
summed by an all-reduce (whisper's output bias added once, after it),
and the tied embedding split over the vocabulary. Where the KV heads do not split over the slice, the
cache is split over head_dim and a decode step takes the reference's
head-dim-parallel branch (:func:`_hd_parallel_decode_attention`). Dtypes follow ``repro.models.layers``: activations stay in
the parameters' dtype (bf16), norms and RoPE compute in f32, logits are a
bf16 product cast to f32. Attention goes through
:mod:`repro_torch.kernels.ops`: plain version on the CPU, the hand-written
kernels on the card.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import xla_attention
from repro_torch.models import sharding as shd
from repro_torch.models import common
from repro_torch.models.common import spec


class Ctx(NamedTuple):
    """Sharding context threaded through model code
    (``repro/models/layers.py:19-29``): a mesh of several devices and the
    sharding rules. ``None`` is the one-device path, unchanged.

    The mesh is a (``data``, ``model``) or (``pod``, ``data``, ``model``)
    grid; a node group's slice is (1, n). An activation is a list of
    per-device tensors in flat position order; each model-axis group (one
    per data row: a ``pod`` x ``data`` coordinate) runs the
    tensor-parallel program on its row's block of the batch, and the
    collectives run within the groups of the axes they name
    (:meth:`all_reduce`, :meth:`all_gather`). ``rows`` limits the
    computed positions to the first ``rows`` data rows, every row's
    program being the same (equal blocks on every device): the dry run
    counts one row of a production mesh on ``meta`` (``launch/dryrun.py``),
    each leaf then holding the locals of those positions alone."""

    mesh: object
    rules: shd.Rules
    rows: Optional[int] = None

    @property
    def n(self) -> int:
        """The model-axis size."""
        return self.mesh.shape["model"]

    @property
    def n_rows(self) -> int:
        """The data rows of the mesh: ``pod`` x ``data``."""
        return self.mesh.size // self.n

    @property
    def size(self) -> int:
        """The computed positions."""
        return (self.rows or self.n_rows) * self.n

    @property
    def devices(self):
        """The computed positions' devices, in flat order."""
        return self.mesh.flat_devices()[:self.size]

    @property
    def dp(self) -> bool:
        """Whether the mesh has data rows beside the model axis."""
        return self.n_rows > 1

    def m(self, pos: int) -> int:
        """A position's model-axis coordinate (the last axis)."""
        return pos % self.n

    def row_starts(self) -> List[int]:
        """The first position of each computed data row."""
        return list(range(0, self.size, self.n))

    def groups(self, axes=("model",)) -> List[List[int]]:
        return shd.axis_groups(self.mesh, axes, self.size)

    def all_reduce(self, parts, axes=("model",)):
        """The sum of each group's parts on its members (``parts``: one
        per computed position), position order within each group."""
        out = [None] * len(parts)
        devs = self.devices
        for grp in self.groups(axes):
            for p, r in zip(grp, shd.all_reduce([parts[q] for q in grp],
                                                [devs[q] for q in grp])):
                out[p] = r
        return out

    def all_gather(self, parts, dim: int, axes=("model",)):
        """Each group's parts joined along ``dim`` on its members. A
        member not computed (``rows``) is stood in for by a computed one:
        the result has the group's whole shape."""
        out = [None] * len(parts)
        devs = self.devices
        for grp in shd.axis_groups(self.mesh, axes):
            here = [q for q in grp if q < self.size]
            if not here:
                continue
            got = shd.all_gather(
                [parts[q] if q < self.size else parts[here[0]] for q in grp],
                [devs[q] for q in here], dim,
                live=[q < self.size for q in grp])
            for p, r in zip(here, got):
                out[p] = r
        return out

    def batch_slice(self, n: int, pos: int, axis: str = "batch") -> slice:
        """Position ``pos``'s block of a batch of ``n`` (the rules'
        ``batch`` over ``pod`` x ``data``; all of it where it does not
        split, as batch 1 under ``long``)."""
        sh = shd.NamedSharding(self.mesh, shd.resolve(
            (axis,), self.mesh, self.rules, shape=(n,)))
        return sh.slices(pos, (n,))[0]

    def local_batch(self, x, pos: int):
        """Position ``pos``'s block of ``x`` along its leading batch dim
        (``x``: a tensor, or one per data row, :func:`per_row`)."""
        if isinstance(x, list):
            x = x[pos // self.n]
        if not self.dp:
            return x
        sl = self.batch_slice(x.shape[0], pos)
        return x if sl.stop - sl.start == x.shape[0] else x[sl]

    def view(self, tree):
        """``tree`` with each leaf split over ``data`` (the embed dim under
        ``fsdp_tp``) all-gathered over ``data`` where it is used: a
        ``Sharded`` in the spec without ``data``, each computed position
        holding its gathered block. The gradient goes back through the
        gather as its reduce-scatter. Families call it on each layer
        group inside ``remat``, so a step holds one group's gathered
        weights at a time."""
        if not self.dp:
            return tree
        return common.tree_map(
            lambda x: _gather_data(self, x) if isinstance(x, shd.Sharded)
            else x, tree)


def _gather_data(ctx: Ctx, leaf: shd.Sharded) -> shd.Sharded:
    spec = list(leaf.sharding.spec)
    dims = [d for d, e in enumerate(spec) if "data" in shd._mesh_axes_tuple(e)]
    if not dims:
        return leaf
    d = dims[0]
    rest = tuple(a for a in shd._mesh_axes_tuple(spec[d]) if a != "data")
    spec[d] = rest[0] if len(rest) == 1 else (rest or None)
    sh = shd.NamedSharding(ctx.mesh, shd.PartitionSpec(*spec))
    n_here = min(len(leaf.locals), ctx.size)
    out = [None] * n_here
    devs = ctx.devices
    for grp in shd.axis_groups(ctx.mesh, ("data",)):
        here = [q for q in grp if q < n_here]
        if not here:
            continue
        # a position not computed (a count of one row on meta) is stood
        # in for by a computed one of the same block shape; its gradient
        # is not wanted
        parts = [leaf.locals[q] if q < n_here else leaf.locals[here[0]]
                 for q in grp]
        got = shd.all_gather(parts, [devs[q] for q in here], dim=d,
                             live=[q < n_here for q in grp])
        for q, t in zip(here, got):
            out[q] = t
    return shd.Sharded(out, sh)


def per_row(ctx: Optional[Ctx], make):
    """``make()``, or over data rows a list of one a row: the positions
    and the zero aux loss a forward makes outside its per-device code are
    made by every row's program, as each device of the reference's
    makes its own."""
    if ctx is None or not ctx.dp:
        return make()
    return [make() for _ in ctx.row_starts()]


def make_ctx(mesh, rules: str = "tp", rows: Optional[int] = None
             ) -> Optional[Ctx]:
    """The context of a mesh: ``None`` over one device. ``rows``: compute
    the first data rows alone (:class:`Ctx`)."""
    if mesh is None or mesh.size == 1:
        return None
    return Ctx(mesh, shd.named_rules(rules), rows)


def constrain(ctx: Optional[Ctx], x, axes):
    if ctx is None:
        return x
    return shd.constrain(x, ctx.mesh, ctx.rules, axes)


def on_slice(ctx: Optional[Ctx], x):
    """An input on every device (audio's frames, vlm's patch
    embeddings): each position's block of the batch, or ``x`` itself
    without ``ctx``."""
    if ctx is None:
        return x
    return [ctx.local_batch(x, r).to(d) for r, d in enumerate(ctx.devices)]


def row_logits(ctx: Optional[Ctx], logits, batch: int):
    """The logits of a forward of ``batch`` sequences as one tensor: over
    data rows (a list, one per row, each on its row's first device), the
    rows' batch blocks joined on the first device, or the first row's
    where the batch does not split (batch 1 under ``long``)."""
    if not isinstance(logits, list):
        return logits
    if ctx.batch_slice(batch, 0).stop == batch:
        return logits[0]
    dev = logits[0].device
    return torch.cat([t.to(dev) for t in logits])


def add(x, y):
    """A residual add: of tensors, or of per-device lists position by
    position."""
    if isinstance(x, list):
        return [a + b for a, b in zip(x, y)]
    return x + y

# ------------------------------------------------------------------- norms


def rms_norm(x, scale, eps: float):
    """RMS norm with the (1 + scale) convention, computed in f32."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float):
    """Layer norm computed in f32, scale and bias in f32, cast back."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_param_specs(cfg: ModelConfig, dim: Optional[int] = None):
    d = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": spec((d,), ("embed",), "ones"),
                "bias": spec((d,), ("embed",), "zeros")}
    return {"scale": spec((d,), ("embed",), "zeros")}  # (1 + scale)


def apply_norm(p, x, cfg: ModelConfig, ctx: Optional[Ctx] = None):
    """The config's norm; with ``ctx``, of a replicated activation (a
    per-device list), on every device by its copy of the (replicated)
    parameters."""
    if ctx is not None:
        p = ctx.view(p)
        return [apply_norm(shd.local_tree(p, r), xr, cfg)
                for r, xr in enumerate(x)]
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ------------------------------------------------------------------- rope

def rope(x, positions, theta: float):
    """Rotate-half RoPE in f32. x: (B, S, H, D); positions: (B, S) or (S,)."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    angle = positions[..., None].float() * freq          # (B, S, half)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions, d_model: int):
    """Whisper's sinusoidal embedding in f32, ``[sin, cos]`` over
    frequencies ``exp(-i log(1e4) / (half - 1))``. positions: (B, S) ->
    (B, S, d_model)."""
    half, dev = d_model // 2, positions.device
    step = torch.log(torch.tensor(10_000.0, device=dev)) / (half - 1)
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev)
                     * step)
    angle = positions[..., None].float() * freq
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# --------------------------------------------------------------- attention

def attn_param_specs(cfg: ModelConfig):
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": spec((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wv": spec((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wo": spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = spec((h, hd), ("heads", "head_dim"), "zeros")
        p["bk"] = spec((k, hd), ("kv_heads", "head_dim"), "zeros")
        p["bv"] = spec((k, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = spec((hd,), ("head_dim",), "zeros")
        p["k_norm"] = spec((hd,), ("head_dim",), "zeros")
    return p


def _project_qkv(p, cfg: ModelConfig, x, kv_x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", kv_x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", kv_x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_core(q, k, v, *, causal: bool, window: int,
                   softcap: Optional[float], scale: float, q_chunk: int):
    """Prefill attention, positions from 0. q: (B, S, H, D); k, v:
    (B, T, K, D). K1 on the card, its plain version on the CPU, under an
    autograd Function whose backward is that of the JAX package's XLA
    branch (``kernels/ops.py``), the branch ``grpo.py`` differentiates."""
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale, q_chunk=q_chunk)


def _cached_attention(cfg: ModelConfig, q, ck, cv, *, positions, causal,
                      window, softcap, scale, cache_pos: int):
    """The ``s`` new queries at ``cache_pos ..`` over a cache already
    written: one query to K2; several to K1 with that query offset on the
    card, to the port of the reference's XLA branch on the CPU."""
    s = q.shape[1]
    if s == 1:
        return kops.decode_attention(q[:, 0], ck, cv, cache_pos, scale=scale,
                                     window=window, softcap=softcap)[:, None]
    if q.is_cuda:
        # K1 with the queries at cache_pos.., over the cache's first
        # cache_pos + s rows, read in place
        t = cache_pos + s
        return kops.flash_attention(q, ck[:, :t], cv[:, :t], causal=causal,
                                    window=window, softcap=softcap,
                                    scale=scale, q_chunk=cfg.attn_q_chunk,
                                    q_off=cache_pos)
    kv_mask = torch.arange(ck.shape[1], device=q.device) <= cache_pos + s - 1
    return xla_attention(q, ck, cv, q_positions=positions, kv_mask=kv_mask,
                         causal=causal, window=window, softcap=softcap,
                         scale=scale, q_chunk=cfg.attn_q_chunk)


def attn_apply(p, cfg: ModelConfig, x, *, positions, causal=True, window=0,
               kv_x=None, cache=None, cache_pos: Optional[int] = None,
               use_rope=True, ctx: Optional[Ctx] = None):
    """Project, rope, (cache update), attend, out-project.

    q comes from ``x``; k and v from ``kv_x`` when it is given
    (cross-attention, keys at positions 0..T-1 and never rotated), else
    from ``x``. cache: optional {"k": (B, T, K, D), "v": ...}; the new keys
    and values are written at ``cache_pos`` (a host int) IN PLACE, which
    saves a copy of the cache per token (the JAX version returns an updated
    copy). The ``s`` new queries sit at positions ``cache_pos ..
    cache_pos + s - 1``: one goes to K2; several go to K1 with that query
    offset on the card and to the port of the reference's XLA branch on
    the CPU. Returns ``(out, kv)``: the cache dict when one was given, else
    the freshly projected (post-rope) {"k", "v"} the prefill uses to build
    one. With ``ctx``, tensor-parallel self- or cross-attention over the
    slice (:func:`_attn_apply_tp`; ``x`` and ``kv_x`` per device).
    """
    if ctx is not None:
        return _attn_apply_tp(p, cfg, x, positions=positions, causal=causal,
                              window=window, kv_x=kv_x, cache=cache,
                              cache_pos=cache_pos, use_rope=use_rope, ctx=ctx)
    q, k, v = _project_qkv(p, cfg, x, x if kv_x is None else kv_x)
    scale = cfg.attn_scale if cfg.attn_scale is not None \
        else cfg.resolved_head_dim ** -0.5
    softcap = cfg.attn_logit_softcap
    if use_rope and cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        if kv_x is None:        # self-attention: keys at their own positions
            k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        s = x.shape[1]
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
        kv_out = cache
        out = _cached_attention(cfg, q, ck, cv, positions=positions,
                                causal=causal, window=window,
                                softcap=softcap, scale=scale,
                                cache_pos=cache_pos)
    else:
        kv_out = {"k": k, "v": v}
        out = attention_core(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale,
                             q_chunk=cfg.attn_q_chunk)
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return proj, kv_out


# ------------------------------------------------- attention over a slice

def _kv_for_heads(t, r: int, hl: int, g: int):
    """The KV heads (axis 2 of (B, T, K, D)) that device ``r``'s query
    heads ``r*hl .. (r+1)*hl - 1`` attend, where the query heads split
    over the slice and the KV heads do not (reduced configs: 4 heads, 2
    KV heads over 4 devices). A copy: K1 and K2 take no strided view of
    the heads axis, so the slice is made contiguous here."""
    h0 = r * hl
    if hl % g == 0:
        return t[:, :, h0 // g:(h0 + hl) // g].contiguous()
    if g % hl == 0:
        return t[:, :, h0 // g:h0 // g + 1].contiguous()
    return t.repeat_interleave(g, dim=2)[:, :, h0:h0 + hl].contiguous()


def hd_parallel(cfg: ModelConfig, ctx: Optional[Ctx]) -> bool:
    """The reference's condition for the head-dim-parallel decode
    (``repro/models/layers.py:279-283``): the KV heads do not split over
    the model axis and head_dim does; the cache is then split over
    head_dim (``cache_hd``)."""
    return ctx is not None and cfg.num_kv_heads % ctx.n != 0 \
        and cfg.resolved_head_dim % ctx.n == 0


def _attn_apply_tp(p, cfg: ModelConfig, xs: List[torch.Tensor], *,
                   positions, causal, window, kv_x, cache, cache_pos,
                   use_rope, ctx: Ctx):
    """:func:`attn_apply` over the slice. ``xs`` (and ``kv_x``, the
    cross-attention's key/value input): the input on every device; ``p``:
    ``Sharded`` leaves. Each device projects its local query heads from
    ``xs`` and its local KV heads from ``kv_x`` or ``xs``
    (column-parallel, biases split alike) and attends
    with K1 (prefill) or K2 (decode) at its local heads; its output
    projection by its rows of ``wo`` is a partial sum, and an all-reduce
    gives every device the whole. Where the query heads split and the KV
    heads do not, each device attends with the KV heads its query heads
    map to; where neither splits, every device attends in full and ``wo``
    is whole on each. ``cache``: {"k", "v": per-device lists of the
    layer's local (B, T, K_local, D_local)}. Returns the per-device
    outputs and {"k", "v": per-device lists}: the cache, or the local
    blocks of the new keys and values in the cache's layout. Over data
    rows each position takes its row's block of the batch (and of
    ``positions``); under ``long`` a decode step's cache splits along its
    sequence over ``data`` (:func:`_cp_decode_tp`)."""
    p = ctx.view(p)
    devs = ctx.devices
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    g = h // cfg.num_kv_heads
    q_split, kv_split = shd.splits(p["wq"], 1), shd.splits(p["wk"], 1)
    hl = h // ctx.n if q_split else h
    mixed = q_split and not kv_split
    hd_cache = hd_parallel(cfg, ctx)
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    softcap = cfg.attn_logit_softcap
    s = xs[0].shape[1]
    outs, qs, new_k, new_v, pos_l = [], [], [], [], []
    for r, dev in enumerate(devs):
        pr = shd.local_tree(p, r)
        pos_r = ctx.local_batch(positions, r).to(dev)
        pos_l.append(pos_r)
        q, k, v = _project_qkv(pr, cfg, xs[r],
                               xs[r] if kv_x is None else kv_x[r])
        if use_rope and cfg.rope_theta > 0:
            q = rope(q, pos_r, cfg.rope_theta)
            if kv_x is None:
                k = rope(k, pos_r, cfg.rope_theta)
        new_k.append(k)
        new_v.append(v)
        if cache is None:
            m = ctx.m(r)
            kk, vv = (_kv_for_heads(k, m, hl, g), _kv_for_heads(v, m, hl, g)) \
                if mixed else (k, v)
            out = attention_core(q, kk, vv, causal=causal, window=window,
                                 softcap=softcap, scale=scale,
                                 q_chunk=cfg.attn_q_chunk)
            outs.append(torch.einsum("bshk,hkd->bsd", out, pr["wo"]))
        else:
            qs.append(q)
    if hd_cache:
        # the cache (or the cross K/V) keeps each device's head_dim block
        # of every KV head
        new_k = constrain(ctx, new_k, ("cache_batch", "cache_seq",
                                       "kv_heads", "cache_hd"))
        new_v = constrain(ctx, new_v, ("cache_batch", "cache_seq",
                                       "kv_heads", "cache_hd"))
    if cache is None:
        kv_out = {"k": new_k, "v": new_v}
    else:
        kv_out = cache
        if cache_seq_split(ctx):
            return _cp_decode_tp(p, cfg, qs, new_k, new_v, cache,
                                 window=window, softcap=softcap, scale=scale,
                                 cache_pos=cache_pos, q_split=q_split,
                                 mixed=mixed, hl=hl, g=g, ctx=ctx), kv_out
        for ck, cv, k, v in zip(cache["k"], cache["v"], new_k, new_v):
            ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
        if hd_cache:
            outs = _hd_decode_tp(p, cfg, qs, cache, positions=pos_l,
                                 window=window, softcap=softcap, scale=scale,
                                 cache_pos=cache_pos, q_split=q_split, hl=hl,
                                 ctx=ctx)
            return ctx.all_reduce(outs), kv_out
        for r, q in enumerate(qs):
            ck, cv = cache["k"][r], cache["v"][r]
            if mixed:
                # the replicated cache's KV heads for this device's queries
                # (head_dim does not split either): a copy a step
                m = ctx.m(r)
                ck, cv = _kv_for_heads(ck, m, hl, g), _kv_for_heads(cv, m, hl, g)
            out = _cached_attention(cfg, q, ck, cv, positions=pos_l[r],
                                    causal=causal, window=window,
                                    softcap=softcap, scale=scale,
                                    cache_pos=cache_pos)
            outs.append(torch.einsum("bshk,hkd->bsd", out,
                                     p["wo"].locals[r]))
    return (ctx.all_reduce(outs) if q_split else outs), kv_out


def cache_seq_split(ctx: Ctx) -> bool:
    """Whether a cache's sequence dim splits over ``data``: the ``long``
    rules' context parallelism on a mesh with data rows."""
    return ctx.mesh.shape.get("data", 1) > 1 and \
        dict(ctx.rules).get("cache_seq") == "data"


def _cp_decode_tp(p, cfg: ModelConfig, qs, new_k, new_v, cache, *, window,
                  softcap, scale, cache_pos, q_split, mixed, hl, g,
                  ctx: Ctx):
    """A decode step's attention over a cache split along its sequence
    over ``data`` (``repro/models/sharding.py:76-83``; zamba2 under
    ``long``): the device whose block holds slot ``cache_pos`` writes the
    new key and value there; each device runs K2 over its own block of
    keys, up to ``cache_pos`` (no key live where the block starts past
    it: an lse of -inf), returning its rows' f32 log-sum-exp; the partial
    outputs are combined across ``data`` by the log-sum-exp rule (an
    all-reduce of the max, then of the weighted outputs and weights);
    and each device projects by its rows of ``wo``, summed over
    ``model``. One query a step; the window and head-dim routes do not
    take this path."""
    if window or qs[0].shape[1] != 1:
        raise ValueError("the context-parallel decode takes one query a "
                         "step and no sliding window")
    span = cache["k"][0].shape[1]
    coords = ctx.mesh.axis_names.index("data")
    outs, lses = [], []
    for r, q in enumerate(qs):
        j = int(np.unravel_index(r, ctx.mesh.devices.shape)[coords])
        ck, cv = cache["k"][r], cache["v"][r]
        local = cache_pos - j * span
        # every device writes one slot, the same program on each: the one
        # whose block holds the position the new key and value, the
        # others their own slot back (the reference's masked update)
        i = min(max(local, 0), span - 1)
        holds = 0 <= local < span
        for c, new in ((ck, new_k[r]), (cv, new_v[r])):
            new = new.to(c.dtype)
            c[:, i:i + 1] = new if holds else c[:, i:i + 1]
        if mixed:
            m = ctx.m(r)
            ck, cv = _kv_for_heads(ck, m, hl, g), _kv_for_heads(cv, m, hl, g)
        out, lse = kops.decode_attention(q[:, 0], ck, cv, min(local, span - 1),
                                         scale=scale, softcap=softcap,
                                         return_lse=True)
        outs.append(out)
        lses.append(lse)
    top = [t.amax(dim=0) for t in
           ctx.all_gather([x[None] for x in lses], 0, axes=("data",))]
    wts = [torch.exp(x - t) for x, t in zip(lses, top)]
    num = ctx.all_reduce([o.float() * w[..., None] for o, w in zip(outs, wts)],
                         axes=("data",))
    den = ctx.all_reduce(wts, axes=("data",))
    projs = []
    for r, (nm, dn) in enumerate(zip(num, den)):
        o = (nm / dn[..., None]).to(qs[r].dtype)
        projs.append(torch.einsum("bshk,hkd->bsd", o[:, None],
                                  p["wo"].locals[r]))
    return ctx.all_reduce(projs) if q_split else projs


def _hd_decode_tp(p, cfg: ModelConfig, qs, cache, *, positions, window,
                  softcap, scale, cache_pos, q_split, hl, ctx: Ctx):
    """A decode step's attention where the cache is split over head_dim:
    every device takes all query heads (gathered where they split) at
    its head_dim block, :func:`_hd_parallel_decode_attention` sums the
    partial scores, and each device projects its block of the output:
    by its rows of a whole ``wo``, or, where ``wo`` splits over heads, by
    its heads of the gathered output. Returns the partial projections."""
    s = qs[0].shape[1]
    q_full = ctx.all_gather(qs, 2) if q_split else qs
    q_hd = constrain(ctx, q_full, ("cache_batch", None, None, "cache_hd"))
    kv_mask = torch.arange(cache["k"][0].shape[1],
                           device=positions[0].device) <= cache_pos + s - 1
    out = _hd_parallel_decode_attention(
        q_hd, cache["k"], cache["v"], q_positions=positions,
        kv_mask=kv_mask, window=window, softcap=softcap, scale=scale,
        ctx=ctx)
    dl = out[0].shape[-1]
    ms = [ctx.m(r) for r in range(len(out))]
    if q_split:
        full = ctx.all_gather(out, 3)
        return [torch.einsum("bshk,hkd->bsd", o[:, :, m * hl:(m + 1) * hl],
                             p["wo"].locals[r])
                for r, (o, m) in enumerate(zip(full, ms))]
    return [torch.einsum("bshk,hkd->bsd", o,
                         p["wo"].locals[r][:, m * dl:(m + 1) * dl])
            for r, (o, m) in enumerate(zip(out, ms))]


def _hd_scores(q, k):
    """QK^T over the head_dim (block) in hand, bf16 products summed in f32,
    in the grouped (kh, g) form: (B, KH, G, S, T)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())


def _hd_softmax_pv(scores, v, *, q_positions, kv_mask, window, softcap,
                   scale):
    """Scale, cap, mask (causal, window, the live slots) and softmax the
    whole scores, then PV with the V (block) in hand: (B, S, H, D_v)."""
    scores = scores * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    b, kh, g, s, t = scores.shape
    dev = scores.device
    qp = q_positions.to(dev)
    qp = qp if qp.ndim == 2 else qp[None, :]
    kp = torch.arange(t, device=dev)
    mask = kp[None, None, :] <= qp[:, :, None]
    if window:
        mask &= kp[None, None, :] > (qp[:, :, None] - window)
    km = kv_mask.to(dev)
    km = km if km.ndim == 2 else km[None, :]
    mask = mask & km[:, None, :]
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(-1e30, device=dev))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, kh * g, v.shape[-1])


def _hd_parallel_decode_attention(q, k, v, *, q_positions, kv_mask, window,
                                  softcap, scale, ctx: Optional[Ctx] = None):
    """GQA decode attention with the head_dim contraction split over the
    slice (``repro/models/layers.py:183-213``). q: (B, S, H, D); k, v:
    (B, T, KH, D). With ``ctx``, q, k and v are per-device lists of their
    head_dim blocks (and ``q_positions`` a tensor, or a list of each
    device's): each device computes its partial scores, an all-reduce
    over ``model`` sums them (f32), every device applies the softmax to
    the whole scores and PV with its block of V, and the per-device
    output blocks (B, S, H, D / n) come back. Plain PyTorch, as the
    reference's is XLA; with ``ctx=None`` the whole computation on one
    device."""
    opts = dict(kv_mask=kv_mask, window=window, softcap=softcap, scale=scale)
    if ctx is None:
        return _hd_softmax_pv(_hd_scores(q, k), v, q_positions=q_positions,
                              **opts)
    qps = q_positions if isinstance(q_positions, list) \
        else [q_positions] * len(q)
    parts = [_hd_scores(qr, kr) for qr, kr in zip(q, k)]
    scores = ctx.all_reduce(parts)
    return [_hd_softmax_pv(sc, vr, q_positions=qp, **opts)
            for sc, vr, qp in zip(scores, v, qps)]


def cross_decode(p, cfg: ModelConfig, h, cross_k, cross_v,
                 ctx: Optional[Ctx] = None):
    """A decode step's cross-attention over precomputed K/V (B, T, K, D),
    as whisper's and llama-3.2-vision's references compute it
    (``repro/models/whisper.py:104-115``, ``vision.py:70-77``): q alone is
    projected, unrotated, scaled by head_dim^-1/2 (not ``cfg.attn_scale``),
    over every key, non-causal and with no cap: K2 at ``pos = T - 1``.
    h: (B, 1, d_model). With ``ctx``, over the slice
    (:func:`_cross_decode_tp`)."""
    if ctx is not None:
        return _cross_decode_tp(p, cfg, h, cross_k, cross_v, ctx)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    out = kops.decode_attention(q[:, 0], cross_k, cross_v,
                                cross_k.shape[1] - 1,
                                scale=cfg.resolved_head_dim ** -0.5)
    return torch.einsum("bshk,hkd->bsd", out[:, None], p["wo"])


def _cross_decode_tp(p, cfg: ModelConfig, hs, cross_k, cross_v, ctx: Ctx):
    """:func:`cross_decode` over the slice. ``hs``: the input on every
    device; ``cross_k``, ``cross_v``: per-device lists of the layer's
    blocks of the cross K/V. Each device projects its local query heads
    and runs K2 over its block at ``pos = T - 1``; its rows of ``wo`` give
    a partial sum, and an all-reduce completes it. Where the cross K/V
    split over head_dim (the KV heads do not split), the head-dim-parallel
    route of the self decode (:func:`_hd_decode_tp`), every key live."""
    p = ctx.view(p)
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    g = h // cfg.num_kv_heads
    q_split, kv_split = shd.splits(p["wq"], 1), shd.splits(p["wk"], 1)
    hl = h // ctx.n if q_split else h
    scale, t = hd ** -0.5, cross_k[0].shape[1]
    qs = []
    for r, hr in enumerate(hs):
        pr = shd.local_tree(p, r)
        q = torch.einsum("bsd,dhk->bshk", hr, pr["wq"])
        qs.append(q + pr["bq"] if cfg.qkv_bias else q)
    if hd_parallel(cfg, ctx):
        # the last query position sees every key: the mask is all live
        positions = torch.full((hs[0].shape[0], 1), t - 1, dtype=torch.int32,
                               device=hs[0].device)
        outs = _hd_decode_tp(p, cfg, qs, {"k": cross_k, "v": cross_v},
                             positions=[positions] * len(qs), window=0,
                             softcap=None, scale=scale, cache_pos=t - 1,
                             q_split=q_split, hl=hl, ctx=ctx)
        return ctx.all_reduce(outs)
    outs = []
    for r, q in enumerate(qs):
        ck, cv = cross_k[r], cross_v[r]
        if q_split and not kv_split:
            m = ctx.m(r)
            ck, cv = _kv_for_heads(ck, m, hl, g), _kv_for_heads(cv, m, hl, g)
        out = kops.decode_attention(q[:, 0], ck, cv, t - 1, scale=scale)
        outs.append(torch.einsum("bshk,hkd->bsd", out[:, None],
                                 p["wo"].locals[r]))
    return ctx.all_reduce(outs) if q_split else outs


# --------------------------------------------------------------------- mlp

def mlp_param_specs(cfg: ModelConfig, d_ff: int):
    d = cfg.d_model
    if cfg.norm == "layernorm":  # whisper's plain MLP with biases
        return {
            "wi": spec((d, d_ff), ("embed", "mlp")),
            "bi": spec((d_ff,), ("mlp",), "zeros"),
            "wo": spec((d_ff, d), ("mlp", "embed")),
            "bo": spec((d,), ("embed",), "zeros"),
        }
    return {
        "wi_gate": spec((d, d_ff), ("embed", "mlp")),
        "wi_up": spec((d, d_ff), ("embed", "mlp")),
        "wo": spec((d_ff, d), ("mlp", "embed")),
    }


def _act(cfg: ModelConfig, x):
    """The activation: tanh-approximate GELU (gemma2's gate, whisper's
    MLP), else SiLU."""
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _mlp_product(p, cfg: ModelConfig, x):
    """The MLP up to its output projection, whisper's output bias left
    out."""
    if "wi" in p:
        return _act(cfg, x @ p["wi"] + p["bi"]) @ p["wo"]
    return (_act(cfg, x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


def mlp_apply(p, cfg: ModelConfig, x, ctx: Optional[Ctx] = None):
    """Gated MLP: act(x W_gate) * (x W_up), then W_o; or, with ``wi``,
    whisper's plain one: act(x W_i + b_i) W_o + b_o, each bias added to
    the bf16 product as the reference adds it. With ``ctx``, ``x`` is per
    device: column-parallel W_gate / W_up (W_i and b_i), row-parallel W_o
    summed by an all-reduce (or whole on every device where ``mlp`` does
    not split), then the replicated b_o added once, on every device."""
    if ctx is not None:
        p = ctx.view(p)
        outs = [_mlp_product(shd.local_tree(p, r), cfg, xr)
                for r, xr in enumerate(x)]
        if shd.splits(p["wo"], 0):
            outs = ctx.all_reduce(outs)
        if "bo" in p:
            outs = [o + b for o, b in zip(outs, p["bo"].locals)]
        return outs
    out = _mlp_product(p, cfg, x)
    return out + p["bo"] if "bo" in p else out


# -------------------------------------------------------------- embeddings

def embed_param_specs(cfg: ModelConfig):
    p = {"embedding": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           "embed", scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return p


def embed_apply(p, cfg: ModelConfig, tokens, ctx: Optional[Ctx] = None):
    """The bf16 embedding of ``tokens``. With ``ctx``, the input on every
    device: where the vocabulary splits, each device looks up the tokens
    in its rows (zero elsewhere) and an all-reduce sums them, which adds
    only zeros to each row."""
    if ctx is not None:
        return _embed_tp(p, cfg, tokens, ctx)
    x = p["embedding"].to(torch.bfloat16)[tokens]
    if cfg.family == "dense" and cfg.post_norms:
        # gemma scales by sqrt(d_model), the constant first rounded to x's
        # dtype as the reference's jnp.asarray(d ** 0.5, x.dtype): 68.0,
        # not 67.88, at gemma2-27b's 4608
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def _embed_tp(p, cfg: ModelConfig, tokens, ctx: Ctx):
    """Each position looks up its block of the batch's tokens (under
    ``fsdp_tp`` in the table gathered over ``data``)."""
    p = ctx.view(p)
    emb, devs = p["embedding"], ctx.devices
    if not shd.splits(emb, 0):
        return [embed_apply(shd.local_tree(p, r), cfg,
                            ctx.local_batch(tokens, r).to(d))
                for r, d in enumerate(devs)]
    parts = []
    for r, d in enumerate(devs):
        vl = emb.locals[r].shape[0]
        t = ctx.local_batch(tokens, r).to(d) \
            - emb.sharding.block(r, 2)[0] * vl
        hit = (t >= 0) & (t < vl)
        x = embed_apply(shd.local_tree(p, r), cfg, t.clamp(0, vl - 1))
        parts.append(torch.where(hit[..., None], x, torch.zeros(
            (), dtype=x.dtype, device=d)))
    return ctx.all_reduce(parts)


def _row_mesh(ctx: Ctx, r0: int):
    """The (1, n) mesh of the data row whose first position is ``r0``."""
    from repro_torch.launch.mesh import Mesh
    devs = ctx.mesh.flat_devices()[r0:r0 + ctx.n]
    ids = [int(i) for i in ctx.mesh.device_ids.flat][r0:r0 + ctx.n]
    return Mesh([devs], ("data", "model"), [ids])


def _unembed_product(p, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return (x @ p["embedding"].t()).float()
    return (x @ p["unembed"]).float()


def unembed_apply(p, cfg: ModelConfig, x, ctx: Optional[Ctx] = None):
    """bf16 product, then f32 (as the JAX einsum then astype), then the
    final logit softcap where the config has one. With ``ctx``, ``x`` is
    per device and the logits come back whole on the slice's first
    device: each device's block of the vocabulary gathered there (the
    sampling and the loss read them there), or the first device's own
    product where the vocabulary does not split."""
    if ctx is not None:
        p = ctx.view(p)
        w = p["embedding"] if cfg.tie_embeddings else p["unembed"]
        vdim = 0 if cfg.tie_embeddings else 1
        rows = []
        for r0 in ctx.row_starts():
            if shd.splits(w, vdim):
                parts = [_unembed_product(shd.local_tree(p, r), cfg, x[r])
                         for r in range(r0, r0 + ctx.n)]
                row = _row_mesh(ctx, r0)
                spec = shd.P(None, None, "model")
                rows.append(shd.gather(shd.Sharded(
                    parts, shd.NamedSharding(row, spec))))
            else:
                rows.append(_unembed_product(shd.local_tree(p, r0), cfg,
                                             x[r0]))
        if cfg.final_logit_softcap:
            cap = cfg.final_logit_softcap
            rows = [cap * torch.tanh(t / cap) for t in rows]
        return rows if ctx.dp else rows[0]
    else:
        logits = _unembed_product(p, cfg, x)
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


# ------------------------------------------------------------------ remat

# the ops a matmul, an einsum and ``@`` lower to: the outputs ``"dots"``
# keeps, as jax.checkpoint_policies.checkpoint_dots keeps dot_general's
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _wants_grad(tree) -> bool:
    if torch.is_tensor(tree) or isinstance(tree, shd.Sharded):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_wants_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_wants_grad(v) for v in tree)
    return False


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, one layer group of a forward, under ``cfg.remat`` as
    the reference's ``jax.checkpoint(fn, policy=remat_policy(cfg))``
    (``repro/models/layers.py:382-387``).

    It runs directly when ``cfg.remat == "none"`` or no gradient is wanted
    (grad mode off, or no tensor in ``args`` requires one). Otherwise it
    runs under a non-reentrant ``torch.utils.checkpoint``: ``"dots"`` keeps
    the matmuls' outputs and recomputes the rest in the backward, any other
    value (``"full"``) keeps nothing inside the group but its inputs. The
    group then runs twice in a forward and backward, kernels included.
    The groups draw no random numbers, so no RNG state is kept."""
    if cfg.remat == "none" or not torch.is_grad_enabled() \
            or not _wants_grad(args):
        return fn(*args)
    context_fn = ckpt.noop_context_fn
    if cfg.remat == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    # over data rows the rerun goes to the group's end: stopping early,
    # where the last tensor the backward needs is made, would skip the
    # last row's tail alone, and the rows would run different programs
    rows = any(isinstance(a, Ctx) and a.dp for a in args)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=context_fn,
                           early_stop=not rows)
