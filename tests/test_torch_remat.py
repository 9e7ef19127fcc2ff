"""``cfg.remat`` in the port's training forward, held against the JAX
package on the CPU.

The reference checkpoints each layer group of every family under
``remat_policy(cfg)`` (``repro/models/layers.py:382-387``): a transformer
group of ``local_global_period`` layers (one layer but for gemma2's two),
a Mamba2 block, a zamba2 group (its Mamba2 blocks and that application
of the shared block) with the trailing Mamba2 blocks one at a time, and
each whisper encoder and decoder layer. The
port runs the same groups under ``layers.remat``: ``torch.utils.checkpoint``
for ``"full"``, a selective policy keeping the matmuls' outputs for
``"dots"``, directly for ``"none"`` or when no gradient is wanted.

Each family's reduced config runs in f32 on both sides (the parameters
upcast, the embedding's bf16 cast patched out of both packages), so the
three policies and ``jax.vjp`` of the reference's forward compute one
function: gradients of ``sum(logits * ct) + aux`` agree within 2e-3 of
each leaf's largest magnitude (f32, as tests/test_kernels.py). The group
functions are counted: twice a forward and backward under ``"full"`` and
``"dots"`` (the forward, then its recomputation), once under ``"none"`` or
``torch.no_grad()``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.hybrid as jhybrid
import repro.models.mamba2 as jmamba2
import repro.models.transformer as jtransformer
import repro.models.whisper as jwhisper
from repro.configs import reduced_config as j_reduced_config
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.models import common, convert
from repro_torch.models import hybrid as thybrid
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import transformer as ttransformer
from repro_torch.models import whisper as twhisper
from repro_torch.models.registry import build_model

torch.set_num_threads(1)

ARCHS = ("qwen2-0.5b", "granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-7b",
         "gemma2-27b", "whisper-large-v3")
REMATS = ("none", "full", "dots")
F32_TOL = 2e-3
B, S = 2, 12
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))


def _f32_embed(p, cfg, tokens, ctx=None):
    """``embed_apply`` without its bf16 cast, gemma's scale kept."""
    x = p["embedding"][tokens]
    if cfg.family == "dense" and cfg.post_norms:
        x = x * cfg.d_model ** 0.5
    return x


@pytest.fixture
def f32_models(monkeypatch):
    for mod in (jtransformer, jmamba2, jhybrid, jwhisper, ttransformer,
                tmamba2, thybrid, twhisper):
        monkeypatch.setattr(mod, "embed_apply", _f32_embed)


def _extra(arch, seed=0):
    """Each side's inputs beside the tokens: whisper's frames (f32 at
    scale 0.02), else none."""
    cfg = reduced_config(arch)
    if cfg.family != "audio":
        return {}, {}
    frames = (np.random.default_rng(seed + 1).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return {"frames": jnp.asarray(frames)}, {"frames": torch.from_numpy(frames)}


def _inputs(arch, seed=0):
    """The JAX model, its seeded params in f32, the port's params (f32
    leaves carried by canonical key), tokens and a logits cotangent."""
    jm = j_build_model(j_reduced_config(arch))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(seed)))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    rng = np.random.default_rng(seed)
    cfg = reduced_config(arch)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ct = rng.standard_normal((B, S, cfg.vocab_size)).astype(np.float32)
    return jm, jp, flat, tokens, ct


def _port_grads(arch, flat, tokens, ct, remat):
    cfg = reduced_config(arch).replace(remat=remat)
    params = convert.params_from_reference(flat, cfg)
    leaves = {k: p.requires_grad_() for k, p in
              common.canonical_flat(params).items()}
    logits, aux = build_model(cfg).forward(
        common.canonical_unflatten(params, leaves),
        {"tokens": torch.from_numpy(tokens).long(), **_extra(arch)[1]})[:2]
    ((logits * torch.from_numpy(ct)).sum() + aux).backward()
    return {k: p.grad for k, p in leaves.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_under_every_remat_and_match_jax_vjp(arch, f32_models):
    jm, jp, flat, tokens, ct = _inputs(arch)

    def fwd(p):
        return jm.forward(p, {"tokens": jnp.asarray(tokens),
                              **_extra(arch)[0]})[:2]

    (jlogits, jaux), vjp = jax.vjp(fwd, jp)
    (jgrads,) = vjp((jnp.asarray(ct), jnp.ones((), jnp.float32)))
    want = {k: np.asarray(v) for k, v in
            j_canonical_flat(jgrads, **IS_ARR).items()}
    got = {r: _port_grads(arch, flat, tokens, ct, r) for r in REMATS}
    for remat, grads in got.items():
        assert grads.keys() == want.keys(), remat
        for k, g in grads.items():
            assert g is not None and g.dtype == torch.float32, (remat, k)
            bound = F32_TOL * max(float(np.abs(want[k]).max()), 1e-30)
            err = float(np.abs(g.numpy() - want[k]).max())
            assert err <= bound, (remat, k, err, bound)
            if remat != "none":
                err = float((g - got["none"][k]).abs().max())
                assert err <= bound, (remat, "vs none", k, err, bound)


def _count_groups(monkeypatch):
    """Count calls of each family's per-layer functions: the transformer
    layer, the Mamba2 block, zamba2's shared block, whisper's encoder and
    decoder layers."""
    calls = {"layer": 0, "block": 0, "shared": 0, "enc": 0, "dec": 0}
    for mod, name, key in ((ttransformer, "layer_apply", "layer"),
                           (tmamba2, "block_apply", "block"),
                           (thybrid, "_shared_attn_apply", "shared"),
                           (twhisper, "enc_layer_apply", "enc"),
                           (twhisper, "dec_layer_apply", "dec")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _per_forward(arch):
    """The per-layer calls one forward makes at the reduced config."""
    cfg = reduced_config(arch)
    calls = {"layer": 0, "block": 0, "shared": 0, "enc": 0, "dec": 0}
    if cfg.family == "hybrid":
        n_attn = thybrid._layout(cfg)[0]
        return dict(calls, block=cfg.num_layers - n_attn, shared=n_attn)
    if cfg.family == "ssm":
        return dict(calls, block=cfg.num_layers)
    if cfg.family == "audio":
        return dict(calls, enc=cfg.encoder_layers, dec=cfg.num_layers)
    return dict(calls, layer=cfg.num_layers)


@pytest.mark.parametrize("remat", REMATS + ("no_grad",))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_group_runs_twice_under_remat_once_without(arch, remat,
                                                        monkeypatch,
                                                        f32_models):
    """A forward and backward runs every layer group twice under "full"
    and "dots" (the recomputation), once under "none"; a forward under
    ``torch.no_grad()`` (at the default "full") once, with no backward."""
    _, _, flat, tokens, ct = _inputs(arch)
    calls = _count_groups(monkeypatch)
    if remat == "no_grad":
        cfg = reduced_config(arch)
        params = convert.params_from_reference(flat, cfg)
        with torch.no_grad():
            build_model(cfg).forward(
                params, {"tokens": torch.from_numpy(tokens).long(),
                         **_extra(arch)[1]})
    else:
        _port_grads(arch, flat, tokens, ct, remat)
    times = 2 if remat in ("full", "dots") else 1
    assert calls == {k: times * n for k, n in _per_forward(arch).items()}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_full_remat_saves_little_more_than_each_groups_input(arch,
                                                            f32_models):
    """The bytes autograd saves for the backward, counted by a
    ``saved_tensors_hooks`` around the forward: under "full" the
    checkpoint keeps its groups' activations out of it, so what is saved
    falls well below "none"'s."""
    _, _, flat, tokens, _ = _inputs(arch)
    saved = {}
    for remat in ("none", "full"):
        cfg = reduced_config(arch).replace(remat=remat)
        params = convert.params_from_reference(flat, cfg)
        for p in common.canonical_flat(params).values():
            p.requires_grad_()
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            build_model(cfg).forward(
                params, {"tokens": torch.from_numpy(tokens).long()})
        saved[remat] = total[0]
    assert saved["full"] < saved["none"] / 2, saved
