"""The port's GRPO training path, held against the JAX package on the CPU.

Inputs are drawn from numpy seeds and fed to both packages; model
parameters are the JAX package's seeded init carried across by
``models/convert.py``. The dense model is qwen2-0.5b cut to two narrow
layers that keep its GQA group of g = 7, QKV bias, tied embeddings and
RoPE. ``compute_grads`` and the WPG's update are also held for the ssm
family (``reduced_config("mamba2-2.7b")``: 3 layers) and the hybrid family
(``reduced_config("zamba2-7b")`` with ``attn_period`` 3 and 7 blocks: two
applications of the shared block, whose gradient sums over both, and a
trailing Mamba2 block).

Which JAX run is the reference for those two:
- mamba2: the JAX model in f32 (the same parameter values upcast, its bf16
  embedding cast patched out), compiled. Its bf16 run is no tighter
  reference than the port: op by op, JAX's CPU sums of bf16 cotangents
  (the gradients of ``D``, ``dt_bias``, norm scales) accumulate in bf16,
  7 % off a 1,536-term sum where PyTorch's is 0.2 % off
  (``test_jax_bf16_broadcast_sums_accumulate_in_bf16``), and compiled, XLA
  skips roundings (``A_log``'s gradient moves by 6 % of its leaf's
  largest). The port's bf16 gradients are within 3 % of the f32 ones.
- zamba2: the JAX model in bf16, op by op (``jax.disable_jit``), as
  ``tests/test_torch_hybrid.py``. At these widths bf16 gradients are far
  from the f32 reference's (the port's by more than 100 % on some leaves
  at 7 blocks), so only the same roundings in the same order agree. At 15 reduced blocks the two packages' roundings add
  up to 8 % of the largest gradient of the smallest leaves; in f32 (the
  embedding casts patched out) they agree within 1e-5. Hence 7 blocks.
In the WPG update, AdamW's first step moves a parameter by about
lr * sign(g), so new parameters are compared where |g| exceeds the
gradient's own tolerance times max|g| (1e-2 for the dense model, whose
gradients agree more closely; 5e-2 for the others), and at least a set
share of the parameters must be compared (``SIGN_FLOOR``).

K3's Function computes its forward with f32 intra-chunk scores
(``ref_ssd`` on the CPU) and differentiates ``ssd_chunked``, which rounds
them to bf16; the JAX model's forward is ``ssd_chunked`` itself, so the two
forwards differ by that rounding only (ROADMAP.md, Queue 3).

Tolerances: f32 quantities 2e-3 (rtol = atol, as tests/test_kernels.py),
or 1e-5 relative where both sides do the same f32 arithmetic (the
optimizer); bf16 quantities 5e-2 relative to the largest magnitude of the
leaf or metric (5e-2 * max(1, |JAX value|) for a scalar metric). At
AdamW's first step the update is about lr * sign(g), and the sign of a
gradient near 0 may differ between the packages, so new parameters are
compared only where |g| > 1e-2 * max|g| of the leaf.

The seeded init's unit-scale tied embedding makes the tiny model's policy
nearly one-hot (mean token logprob about -60), where the clipped ratio
against any behavior logprob leaves gradients of 1e-20 that AdamW's eps
swallows. The tests scale the embedding by 1/16 (exact in bf16), so the
policy is spread over the vocabulary and every leaf's gradient is O(1e-3)
or more.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as jmamba2
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core import api as japi
from repro.core.controller import JobConfig as JJobConfig
from repro.core.controller import RLControllerGRPO as JRLControllerGRPO
from repro.core.router import Router as JRouter
from repro.core.state_manager import StateManager as JStateManager
from repro.core.worker import WorkerProcessGroup as JWPG
from repro.models import layers as jl
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.common import canonical_unflatten as j_canonical_unflatten
from repro.models.registry import build_model as j_build_model
from repro.rl import data as jdata
from repro.rl import grpo as jgrpo
from repro.train import optimizer as jopt
from repro_torch.core import api
from repro_torch.core.controller import JobConfig, RLControllerGRPO
from repro_torch.core.router import Router
from repro_torch.core.state_manager import StateManager
from repro_torch.core.worker import WorkerProcessGroup
from repro_torch.kernels import ops
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import common, convert
from repro_torch.models.registry import build_model
from repro_torch.rl import data as tdata
from repro_torch.rl import grpo as tgrpo
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)

OVERRIDES = (("num_layers", 2), ("d_model", 64), ("num_heads", 14),
             ("num_kv_heads", 2), ("head_dim", 16), ("d_ff", 128),
             ("vocab_size", 128))
CFG_J = j_get_config("qwen2-0.5b").replace(**dict(OVERRIDES))
BF16_REL, F32_TOL = 5e-2, 2e-3


def _reduced_overrides(arch, **extra):
    """``reduced_config(arch)`` (and ``extra``) as DeploymentSpec
    overrides: the fields where it differs from the full config."""
    full, red = j_get_config(arch), j_reduced_config(arch).replace(**extra)
    return tuple((f.name, getattr(red, f.name))
                 for f in dataclasses.fields(red)
                 if getattr(red, f.name) != getattr(full, f.name))


# family -> (arch, overrides) of the models the training tests hold
FAMILIES = {
    "dense": ("qwen2-0.5b", OVERRIDES),
    "ssm": ("mamba2-2.7b", _reduced_overrides("mamba2-2.7b")),
    "hybrid": ("zamba2-7b", _reduced_overrides("zamba2-7b", attn_period=3,
                                               num_layers=7)),
}


# where a parameter's gradient decides its first AdamW step (module
# docstring), and the least share of the parameters that must pass it
# (above 5e-2 * max|g|: 41 % of mamba2's and of zamba2's at these seeds)
SIGN_FLOOR = {"dense": (1e-2, 0.5), "ssm": (BF16_REL, 0.35),
              "hybrid": (BF16_REL, 0.35)}


def _jax_side(family, jp, monkeypatch):
    """The JAX reference for ``family`` (module docstring): its params and
    the context to run it in."""
    if family == "ssm":
        monkeypatch.setattr(jmamba2, "embed_apply",
                            lambda p, cfg, tokens, ctx=None:
                            p["embedding"][tokens])
        return (jax.tree.map(lambda a: a.astype(jnp.float32), jp),
                contextlib.nullcontext())
    if family == "hybrid":
        return jp, jax.disable_jit()
    return jp, contextlib.nullcontext()
FAST_LR = dict(lr=1e-3, warmup_steps=1)   # a step larger than a bf16 ulp


def _cpu_router(**kw):
    return Router(device_plane=DevicePlane(devices=[torch.device("cpu")]),
                  **kw)


def _t(arr):
    return convert.tensor_from_numpy(np.asarray(arr))


def _n(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_rel(port, ref, rel=BF16_REL, what=""):
    port, ref = _n(port), _n(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    bound = rel * max(1.0, float(np.abs(ref).max())) if ref.ndim == 0 \
        else rel * float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert np.isfinite(port).all() and err <= bound, (what, err, bound)


IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))


def _reference_params(seed=0, family="dense"):
    """The JAX package's seeded init with the embedding scaled by 1/16:
    (model, params tree, canonical numpy leaves)."""
    arch, ov = FAMILIES[family]
    jm = j_build_model(j_get_config(arch).replace(**dict(ov)))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    jp["embed"]["embedding"] = jp["embed"]["embedding"] / 16
    flat = {k: np.asarray(v)
            for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    return jm, jp, flat


def _seeded_batch(seed, b=8, s=24, p_len=10, vocab=128):
    """A packed GRPO batch whose advantages are non-zero (numpy)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, vocab, size=(b, s)).astype(np.int32)
    behave = np.zeros((b, s), np.float32)
    # about the spread policy's own logprobs (log 128 = 4.85)
    behave[:, p_len:] = -rng.uniform(4.4, 5.4, size=(b, s - p_len))
    mask = np.zeros((b, s), np.float32)
    mask[:, p_len:] = 1.0
    adv = rng.standard_normal(b).astype(np.float32)
    return {"tokens": tokens, "behavior_logprobs": behave,
            "advantages": adv, "loss_mask": mask}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


# --------------------------------------------------- K1's autograd Function

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh", [(4, 4), (14, 2)])       # g = 1 and g = 7
def test_attention_function_grads_match_jax_xla_branch(h, kh, dtype):
    """Output and q, k, v grads of the Function against jax.grad of
    attention_core(impl="xla"), causal, at a ragged S = 37."""
    rng = np.random.default_rng(h)
    b, s, d = 2, 37, 16
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d),
                          (b, s, h, d))]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jct = (jnp.asarray(a).astype(jdt) for a in arrs)
    scale = d ** -0.5
    pos = jnp.arange(s)

    def jfn(q, k, v):
        return jl.attention_core(q, k, v, q_positions=pos, kv_positions=pos,
                                 causal=True, window=0, softcap=None,
                                 scale=scale, impl="xla")

    jout, vjp = jax.vjp(jfn, jq, jk, jv)
    jgrads = vjp(jct)
    tq, tk, tv, tct = (torch.from_numpy(a).to(tdt) for a in arrs)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=True, scale=scale)
    assert out.grad_fn is not None
    out.backward(tct)
    rel = BF16_REL if dtype == "bfloat16" else F32_TOL
    _close_rel(out, jout, rel, "out")
    for name, t, j in zip("qkv", leaves, jgrads):
        assert t.grad.dtype == tdt
        _close_rel(t.grad, j, rel, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_attention_chunks_queries_as_the_reference(dtype):
    """At S = 300 the queries go in a 256-row chunk and a ragged 44-row one
    (padded, each checkpointed): the output and the q, k, v gradients equal
    the unchunked computation's and jax.vjp of the reference's chunked
    attention_core. GQA 14:2."""
    from repro_torch.kernels.flash_attention import xla_attention
    rng = np.random.default_rng(11)
    b, s, h, kh, d = 1, 300, 14, 2, 16
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d),
                          (b, s, h, d))]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jct = (jnp.asarray(a).astype(jdt) for a in arrs)
    pos = jnp.arange(s)

    def jfn(q, k, v):
        return jl.attention_core(q, k, v, q_positions=pos, kv_positions=pos,
                                 causal=True, window=0, softcap=None,
                                 scale=d ** -0.5, impl="xla", q_chunk=256)

    jout, vjp = jax.vjp(jfn, jq, jk, jv)
    jgrads = vjp(jct)
    tq, tk, tv, tct = (torch.from_numpy(a).to(tdt) for a in arrs)
    runs = {}
    for q_chunk in (256, 0):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = xla_attention(*leaves, causal=True, q_chunk=q_chunk)
        out.backward(tct)
        runs[q_chunk] = [out] + [t.grad for t in leaves]
    # one chunk's rows see the same keys in the same order: the output is
    # the same bits; dk, dv sum the chunks' parts in another order
    assert torch.equal(runs[256][0], runs[0][0])
    rel = BF16_REL if dtype == "bfloat16" else F32_TOL
    for name, got, want, j in zip(["out", "dq", "dk", "dv"], runs[256],
                                  runs[0], [jout, *jgrads]):
        assert got.dtype == tdt
        _close_rel(got, want, 1e-5 if dtype == "float32" else rel, name)
        _close_rel(got, j, rel, name)


@pytest.mark.parametrize("q_chunk", [256, 8])
def test_attention_function_backward_is_the_xla_branch_on_the_cpu(q_chunk):
    """The Function's grads equal plain autograd through xla_attention
    (what its backward recomputes) at the same query chunk, bit for bit:
    one block of 19 rows, and blocks of 8 (a reduced config's
    ``attn_q_chunk`` is 32)."""
    from repro_torch.kernels.flash_attention import xla_attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 19, 14, 16), generator=g).bfloat16()
    k, v = (torch.randn((2, 19, 2, 16), generator=g).bfloat16()
            for _ in range(2))
    ct = torch.randn((2, 19, 14, 16), generator=g).bfloat16()
    grads = []
    for fn in (ops.flash_attention, functools.partial(xla_attention,
                                                      scale=None)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, causal=True, q_chunk=q_chunk).backward(ct)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# --------------------------------------------------- K3's autograd Function

def _ssd_arrays(b, s, h, p, n, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, p)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
                np.float32),
            -np.exp(rng.standard_normal(h)).astype(np.float32),
            rng.standard_normal((b, s, 1, n)).astype(np.float32),
            rng.standard_normal((b, s, 1, n)).astype(np.float32),
            rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.standard_normal((b, h, p, n)).astype(np.float32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,with_state", [
    (2, 96, 4, 8, 16, 32, False),       # three chunks; the state unused
    (2, 21, 4, 8, 16, 8, True),         # ragged S: a padded last chunk
])
def test_ssd_function_grads_match_jax_ssd_chunked(b, s, h, p, n, chunk,
                                                  with_state, dtype):
    """y and the x, dt, A, B, C gradients of K3's Function (x, B, C in
    ``dtype``, as the model passes them) against ``jax.vjp`` of the
    reference's ``ssd_chunked``, its bf16 score downcast included; with
    the final state's cotangent too, or with the state unused (the
    training path: its cotangent reaches the backward as None)."""
    x, dt, A, Bm, Cm, dy, dst = _ssd_arrays(b, s, h, p, n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jin = [jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
           jnp.asarray(Bm).astype(jdt), jnp.asarray(Cm).astype(jdt)]
    (jy, _), vjp = jax.vjp(lambda *a: jmamba2.ssd_chunked(*a, chunk), *jin)
    jgrads = vjp((jnp.asarray(dy).astype(jdt),
                  jnp.asarray(dst) if with_state
                  else jnp.zeros_like(jnp.asarray(dst))))
    leaves = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
              torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
              torch.from_numpy(Cm).to(tdt)]
    leaves = [t.requires_grad_() for t in leaves]
    y, state = ops.ssd(*leaves, chunk=chunk)
    assert y.grad_fn is not None and y.dtype == tdt
    outs, cts = [y], [torch.from_numpy(dy).to(tdt)]
    if with_state:
        outs.append(state)
        cts.append(torch.from_numpy(dst))
    torch.autograd.backward(outs, cts)
    rel = BF16_REL if dtype == "bfloat16" else F32_TOL
    _close_rel(y, jy, rel, "y")
    for name, t, j in zip(["x", "dt", "A", "B", "C"], leaves, jgrads):
        assert t.grad.dtype == t.dtype, name
        _close_rel(t.grad, j, rel, f"d{name}")


def test_ssd_function_backward_is_ssd_chunked_autograd_on_the_cpu():
    """The Function's gradients equal plain autograd through the port's
    ``ssd_chunked`` (what its backward recomputes), bit for bit, at a
    ragged S = 21 in bf16."""
    from repro_torch.models.mamba2 import ssd_chunked
    x, dt, A, Bm, Cm, dy, _ = _ssd_arrays(2, 21, 4, 8, 16)
    args = [torch.from_numpy(x).bfloat16(), torch.from_numpy(dt),
            torch.from_numpy(A), torch.from_numpy(Bm).bfloat16(),
            torch.from_numpy(Cm).bfloat16()]
    grads = []
    for fn in (lambda *a: ops.ssd(*a, chunk=8),
               lambda *a: ssd_chunked(*a, 8)):
        leaves = [t.clone().requires_grad_() for t in args]
        fn(*leaves)[0].backward(torch.from_numpy(dy).bfloat16())
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_jax_bf16_broadcast_sums_accumulate_in_bf16():
    """The reference quirk behind the mamba2 reference's f32 run (module
    docstring): op by op on the CPU, the gradient of a bf16 broadcast
    multiply (mamba2's ``D * x``) sums its 1,536 terms in bf16, 7 % off
    the exact sum, where PyTorch's is within 0.5 %."""
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((8, 24, 16, 8)).astype(np.float32)
            for _ in range(2))
    jx, jy = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, y))
    exact = (np.asarray(jx, np.float32) * np.asarray(jy, np.float32)).sum(
        (0, 1, 3))

    def f(d):
        return (d[None, None, :, None].astype(jnp.bfloat16) * jx * jy
                ).astype(jnp.float32).sum()

    with jax.disable_jit():
        jg = np.asarray(jax.grad(f)(jnp.ones((16,), jnp.float32)))
    td = torch.ones(16, requires_grad=True)
    (td[None, None, :, None].bfloat16() * _t(jx) * _t(jy)).float().sum(
    ).backward()
    scale = np.abs(exact).max()
    assert np.abs(jg - exact).max() > 0.05 * scale
    assert np.abs(td.grad.numpy() - exact).max() < 0.005 * scale


# ------------------------------------------------------------- GRPO pieces

def test_token_logprobs_matches_jax():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 9, 50)) * 4).astype(np.float32)
    tokens = rng.integers(0, 50, size=(3, 9)).astype(np.int32)
    jlp = jgrpo.token_logprobs(jnp.asarray(logits), jnp.asarray(tokens))
    tlp = tgrpo.token_logprobs(torch.from_numpy(logits),
                               torch.from_numpy(tokens))
    assert tlp.shape == (3, 8) and tlp.dtype == torch.float32
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("group_size", [2, 4])
def test_group_relative_advantages_match_jax(group_size):
    rng = np.random.default_rng(group_size)
    rewards = rng.integers(0, 2, size=16).astype(np.float32)
    rewards[:group_size] = 1.0            # one group with equal rewards
    jadv = jgrpo.group_relative_advantages(jnp.asarray(rewards), group_size)
    tadv = tgrpo.group_relative_advantages(torch.from_numpy(rewards),
                                           group_size)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), rtol=1e-5,
                               atol=1e-5)
    assert np.all(tadv.numpy()[:group_size] == 0.0)


def test_pack_rollout_batch_matches_jax():
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, 20, size=(8, 6)).astype(np.int32)
    comps = rng.integers(0, 20, size=(8, 10)).astype(np.int32)
    logps = -rng.uniform(0, 5, size=(8, 10)).astype(np.float32)
    rewards = rng.integers(0, 2, size=8).astype(np.float32)
    for seq_len in (12, 20):
        jb = jdata.pack_rollout_batch(prompts, comps, logps, rewards, 4,
                                      seq_len)
        tb = tdata.pack_rollout_batch(prompts, comps, logps, rewards, 4,
                                      seq_len)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tb[k].dtype == np.asarray(jb[k]).dtype, k
            np.testing.assert_allclose(tb[k], np.asarray(jb[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def _loss_inputs(seed=3, family="dense"):
    jm, jp, flat = _reference_params(seed, family)
    params = convert.params_from_reference(flat, _port_cfg(family))
    return jm, jp, build_model(_port_cfg(family)), params, _seeded_batch(seed)


def _port_cfg(family="dense"):
    from repro_torch.configs import get_config
    arch, ov = FAMILIES[family]
    return get_config(arch).replace(**dict(ov))


@pytest.mark.parametrize("kl_coef", [0.0, 0.1])
def test_grpo_loss_metrics_match_jax(kl_coef):
    jm, jp, tm, params, batch = _loss_inputs()
    jloss, jmet = jgrpo.grpo_loss(jp, jm, _jbatch(batch),
                                  jgrpo.GRPOConfig(kl_coef=kl_coef))
    tloss, tmet = tgrpo.grpo_loss(params, tm, _tbatch(batch),
                                  tgrpo.GRPOConfig(kl_coef=kl_coef))
    assert tmet.keys() == jmet.keys()
    _close_rel(tloss, jloss, what="loss")
    for k in jmet:
        _close_rel(tmet[k], jmet[k], what=k)
    assert abs(float(tmet["pg_loss"])) > 1e-3    # the batch bites


def _by_family(cases, families=("ssm", "hybrid")):
    """``cases`` for the dense model under their old ids, then the first
    case for each other family: what a case varies besides the model
    (micro-batching, the op path) is the same code for every family."""
    dense = [pytest.param(c, "dense", id=str(c)) for c in cases]
    return dense + [pytest.param(cases[0], f, id=f"{cases[0]}-{f}")
                    for f in families]


@pytest.mark.parametrize("grad_accum,family", _by_family([1, 2]))
def test_compute_grads_match_jax(grad_accum, family, monkeypatch):
    jm, jp, tm, params, batch = _loss_inputs(family=family)
    jp, mode = _jax_side(family, jp, monkeypatch)
    with mode:
        jgrads, jmet = jgrpo.compute_grads(jp, jm, _jbatch(batch),
                                           jgrpo.GRPOConfig(), None,
                                           grad_accum)
    tgrads, tmet = tgrpo.compute_grads(params, tm, _tbatch(batch),
                                       tgrpo.GRPOConfig(), grad_accum)
    jflat = j_canonical_flat(jgrads, is_leaf=lambda x: hasattr(x, "shape"))
    tflat = common.canonical_flat(tgrads)
    assert jflat.keys() == tflat.keys()
    for k, g in tflat.items():
        assert g.dtype == params_dtype(params, k)
        assert float(np.abs(_n(jflat[k])).max()) > 0, k
        _close_rel(g, jflat[k], what=k)
    for k in jmet:
        _close_rel(tmet[k], jmet[k], what=k)


@pytest.mark.parametrize("b", [6, 10])
def test_compute_grads_refuses_a_batch_grad_accum_does_not_divide(b):
    """As the reference's reshape to (accum, B // accum, ...) refuses it:
    at B = 6 ``chunk(4)`` gives three pieces, at B = 10 four unequal ones
    that would be averaged with equal weight."""
    jm, jp, tm, params, _ = _loss_inputs()
    batch = _seeded_batch(3, b=b)
    with pytest.raises(TypeError):          # the reference's reshape
        jgrpo.compute_grads(jp, jm, _jbatch(batch), jgrpo.GRPOConfig(), None,
                            4)
    with pytest.raises(ValueError, match="does not divide"):
        tgrpo.compute_grads(params, tm, _tbatch(batch), tgrpo.GRPOConfig(),
                            4)


def params_dtype(params, key):
    return common.canonical_flat(params)[key].dtype


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("case", ["clip", "no clip", "later step, decay"])
def test_optimizer_update_matches_jax(case):
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 7), "b/c": (3,), "b/d": (2, 4, 6)}

    def tree(scale):
        return {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in shapes.items()}

    grads, params = tree(3.0 if case == "clip" else 0.01), tree(1.0)
    step = 0
    mu = {k: np.zeros_like(v) for k, v in params.items()}
    nu = dict(mu)
    kw = dict(FAST_LR)
    if case == "later step, decay":
        step = 3
        mu, nu = tree(0.1), {k: np.abs(v) for k, v in tree(0.1).items()}
        kw = dict(lr=2e-3, warmup_steps=10, weight_decay=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)

    def jtree(flat):
        return j_canonical_unflatten(
            {"a": 0, "b": {"c": 0, "d": 0}},
            {k: jnp.asarray(v) for k, v in flat.items()},
            is_leaf=lambda x: not isinstance(x, dict))

    def ttree(flat):
        return common.canonical_unflatten(
            {"a": 0, "b": {"c": 0, "d": 0}},
            {k: torch.from_numpy(v.copy()) for k, v in flat.items()})

    jout = jopt.update(jtree(grads), jopt.AdamWState(
        jnp.asarray(step, jnp.int32), jtree(mu), jtree(nu)), jtree(params),
        jcfg)
    tp, tst = ttree(params), topt.AdamWState(
        torch.tensor(step, dtype=torch.int32), ttree(mu), ttree(nu))
    tm = topt.update_(ttree(grads), tst, tp, tcfg)
    jp, jst, jm = jout
    assert int(tst.step) == step + 1
    gnorm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                              for g in grads.values())))
    assert (gnorm > 1.0) == (case == "clip")
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    for tt, jt in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        jflat = j_canonical_flat(jt, is_leaf=lambda x: hasattr(x, "shape"))
        for k, v in common.canonical_flat(tt).items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), np.asarray(jflat[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_train_state_init_draws_params_and_zero_moments():
    from repro_torch.train import train_state
    model = build_model(_port_cfg())
    st = train_state.init(model, torch.Generator().manual_seed(0),
                          topt.AdamWConfig())
    ref = model.init_params(torch.Generator().manual_seed(0))
    for k, p in common.canonical_flat(st.params).items():
        assert torch.equal(p, common.canonical_flat(ref)[k]), k
        for mom in (st.opt_state.mu, st.opt_state.nu):
            m = common.canonical_flat(mom)[k]
            assert m.dtype == torch.float32 and m.shape == p.shape
            assert not m.any()
    assert int(st.step) == int(st.opt_state.step) == 0


# ------------------------------------------------------------------ the WPG

def _spec(mod, job, dep, role, family="dense"):
    arch, ov = FAMILIES[family]
    return mod.DeploymentSpec(deployment_id=dep, job_id=job,
                              model_name=arch, role=role, overrides=ov)


def _wpg_pair(family="dense", monkeypatch=None):
    """A JAX WPG and a port WPG (train role) holding the same parameters
    and zero AdamW moments, and the context to run the JAX one in."""
    _, jp, flat = _reference_params(5, family)
    jp, mode = _jax_side(family, jp, monkeypatch)
    jw = JWPG(_spec(japi, "A", "A-train", "train", family), JStateManager(),
              adamw_cfg=jopt.AdamWConfig(**FAST_LR))
    jw.execute(japi.make_op(jw.spec, japi.Op.INIT, 0))
    jw._store(params=jp)
    tw = WorkerProcessGroup(_spec(api, "A", "A-train", "train", family),
                            StateManager(),
                            adamw_cfg=topt.AdamWConfig(**FAST_LR))
    tw.execute(api.make_op(tw.spec, api.Op.INIT,
                           params=convert.params_from_reference(flat,
                                                                tw.cfg)))
    return jw, tw, mode


@pytest.mark.parametrize("path,family", _by_family(
    ["update_actor", "forward_backward+optim"]))
def test_wpg_update_matches_jax_wpg(path, family, monkeypatch):
    jw, tw, mode = _wpg_pair(family, monkeypatch)
    batch = _seeded_batch(5)
    with mode:
        # the gradient, for the mask below and the first moment
        jgrads, _ = jgrpo.compute_grads(jw.params(), jw.model,
                                        _jbatch(batch), jw.grpo_cfg, None)
        # FORWARD (compute_log_prob) first: it changes nothing
        jlp = jw.execute(japi.make_op(jw.spec, japi.Op.FORWARD,
                                      _jbatch(batch)))
        if path == "update_actor":
            jmet = jw.execute(japi.make_op(jw.spec, japi.Op.UPDATE_ACTOR,
                                           _jbatch(batch)))
        else:
            jfb = jw.execute(japi.make_op(jw.spec, japi.Op.FORWARD_BACKWARD,
                                          _jbatch(batch)))
            jmet = dict(jfb["metrics"], **jw.execute(japi.make_op(
                jw.spec, japi.Op.OPTIM_STEP, jfb["grads"])))
    tlp = tw.execute(api.make_op(tw.spec, api.Op.FORWARD, batch))
    _close_rel(tlp, jlp, what="logprobs")
    if path == "update_actor":
        tmet = tw.execute(api.make_op(tw.spec, api.Op.UPDATE_ACTOR, batch))
    else:
        tfb = tw.execute(api.make_op(tw.spec, api.Op.FORWARD_BACKWARD,
                                     batch))
        tmet = dict(tfb["metrics"], **tw.execute(api.make_op(
            tw.spec, api.Op.OPTIM_STEP, tfb["grads"])))
        assert tmet["step"] == jmet["step"] == 1
    for k in ("loss", "pg_loss", "kl", "grad_norm", "lr"):
        _close_rel(tmet[k], jmet[k], what=k)
    assert float(tmet["grad_norm"]) > 0
    assert [op for op, _ in tw.exec_log][-1] in ("update_actor",
                                                  "optim_step")
    jg = j_canonical_flat(jgrads, **IS_ARR)
    jp = j_canonical_flat(jw.params(), **IS_ARR)
    jmu = j_canonical_flat(jw.opt_state().mu, **IS_ARR)
    tp = common.canonical_flat(tw.params())
    tmu = common.canonical_flat(tw.opt_state().mu)
    assert int(tw.opt_state().step) == 1
    compared = 0
    for k, g in jg.items():
        if k == "layers/attn/bk":
            # 0 in exact arithmetic (a key bias shifts each query's scores
            # by a constant): its sign is rounding noise
            continue
        g = _n(g)
        sel = np.abs(g) > SIGN_FLOOR[family][0] * np.abs(g).max()
        compared += int(sel.sum())
        np.testing.assert_allclose(_n(tp[k])[sel], _n(jp[k])[sel],
                                   rtol=2.0 ** -7, atol=1e-6, err_msg=k)
        _close_rel(tmu[k], jmu[k], what=f"mu {k}")
    assert compared > SIGN_FLOOR[family][1] * sum(v.size
                                                  for v in jg.values())


def test_update_actor_writes_in_place_and_sync_weights_copies():
    """The job's entries keep their tensors across UPDATE_ACTOR; a rollout
    deployment synced before the update keeps the weights it was given."""
    router = _cpu_router(wpg_factory=functools.partial(
        WorkerProcessGroup, adamw_cfg=topt.AdamWConfig(**FAST_LR)))
    train = router.deploy(_spec(api, "A", "A-train", "train"))
    roll = router.deploy(_spec(api, "A", "A-roll", "rollout"))
    train.call(api.Op.INIT, params=convert.params_from_reference(
        _reference_params(3)[2], train.wpg.cfg))
    roll.init(seed=4)
    router.drain()
    sm = router.state_managers[0]
    keys = sm.keys_for(train.wpg.job_prefix)
    assert any("/opt/mu/" in k for k in keys) and \
        f"{train.wpg.job_prefix}/opt/step" in keys
    assert not sm.keys_for(roll.wpg.job_prefix, "opt")
    before = {k: sm.entries[k] for k in keys}
    ptrs = {k: e.ref.data_ptr() for k, e in before.items()}
    old = {k: e.ref.clone() for k, e in before.items()}
    synced = train.sync_weights(roll)
    upd = train.update_actor(_seeded_batch(6))
    router.drain()
    assert synced.result()["synced_bytes"] == sm.job_bytes(
        train.wpg.job_prefix)
    assert upd.result()["grad_norm"] > 0
    assert sm.keys_for(train.wpg.job_prefix) == keys
    for k in keys:
        assert sm.entries[k] is before[k] and \
            sm.entries[k].ref.data_ptr() == ptrs[k], k
    assert int(sm.entries[f"{train.wpg.job_prefix}/opt/step"].ref) == 1
    changed = [k for k in keys if "/params/" in k
               and not torch.equal(sm.entries[k].ref, old[k])]
    assert changed
    # the rollout deployment holds the pre-update weights, in its own
    # tensors
    rp = common.canonical_flat(roll.wpg.params())
    tp = common.canonical_flat(train.wpg.params())
    for k, v in rp.items():
        assert torch.equal(v, old[f"{train.wpg.job_prefix}/params/{k}"]), k
        assert v.data_ptr() != tp[k].data_ptr()


# --------------------------------------------------------- the controllers

def _answer(prompt_row):
    expr = tdata.decode(prompt_row).split("=")[0]
    return int(eval(expr))


def _fake_generate(self, prompt_tokens, max_new_tokens=32, temperature=1.0,
                   **_):
    """Seeded completions, the same in both packages: in each group of 4
    rows, two spell the right answer and two a wrong one."""
    prompts = np.asarray(prompt_tokens)
    rng = np.random.default_rng(int(prompts.sum()))
    toks = np.full((prompts.shape[0], max_new_tokens), tdata.EOS, np.int32)
    for i, row in enumerate(prompts):
        ans = _answer(row) + (0 if i % 4 < 2 else 1)
        ids = tdata.encode(str(ans))[1:]
        toks[i, :len(ids)] = ids
    logps = -rng.uniform(3.0, 6.0, size=toks.shape).astype(np.float32)
    return {"tokens": toks, "logprobs": logps,
            "alive": np.ones(toks.shape, bool)}


def _two_steps(ctl, router):
    """``run()`` after its init: submit a step, drain, twice."""
    tails = []
    for _ in range(ctl.cfg.steps):
        tails += ctl.submit_step()
        router.drain()
    for f in tails:
        f.result()


def test_grpo_controller_two_steps_match_jax(monkeypatch):
    monkeypatch.setattr(JWPG, "_op_generate", _fake_generate)
    monkeypatch.setattr(WorkerProcessGroup, "_op_generate", _fake_generate)
    kw = dict(job_id="A", model_name="qwen2-0.5b", batch_size=8,
              group_size=4, prompt_len=40, max_new_tokens=24, seq_len=64,
              steps=2, seed=7, overrides=OVERRIDES)
    _, jp0, flat0 = _reference_params(7)
    jrouter = JRouter(wpg_factory=functools.partial(
        JWPG, adamw_cfg=jopt.AdamWConfig(**FAST_LR)))
    jctl = JRLControllerGRPO(JJobConfig(**kw), jrouter)
    jctl.submit_init()
    jrouter.drain()
    jctl.dep.wpg._store(params=jp0)
    router = _cpu_router(wpg_factory=functools.partial(
        WorkerProcessGroup, adamw_cfg=topt.AdamWConfig(**FAST_LR)))
    ctl = RLControllerGRPO(JobConfig(**kw), router)
    ctl.dep.call(api.Op.INIT, params=convert.params_from_reference(
        flat0, ctl.dep.wpg.cfg))
    router.drain()
    _two_steps(jctl, jrouter)
    _two_steps(ctl, router)
    assert ctl.reward_log == jctl.reward_log == [0.5, 0.5]
    assert len(ctl.metrics_log) == len(jctl.metrics_log) == 2
    for tm, jm in zip(ctl.metrics_log, jctl.metrics_log):
        assert tm.keys() == jm.keys()
        for k in jm:
            _close_rel(tm[k], jm[k], what=k)
        assert tm["grad_norm"] > 0
    jflat = j_canonical_flat(jctl.dep.wpg.params(), **IS_ARR)
    moved = agree = 0
    for k, v in common.canonical_flat(ctl.dep.wpg.params()).items():
        p0, tp, jp = _n(_t(flat0[k])), _n(v), _n(jflat[k])
        # where the JAX steps moved a parameter, the port moved it the same
        # way; a sign flip of a gradient near 0 (bk's is 0 in exact
        # arithmetic: a key bias shifts each query's scores by a constant)
        # moves it by at most 2 lr a step
        dt, dj = tp - p0, jp - p0
        moved += int((dj != 0).sum())
        agree += int(((dj != 0) & (np.sign(dt) == np.sign(dj))).sum())
        bound = 2 * FAST_LR["lr"] * ctl.cfg.steps + 2.0 ** -7 * \
            np.abs(jp).max()
        assert np.abs(tp - jp).max() <= bound, k
    assert moved > 0 and agree >= 0.97 * moved, (agree, moved)
