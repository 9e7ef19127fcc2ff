"""The plain reference against hand-written checks at a tiny size, and
against the port (its kernels' plain versions on the CPU)."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from plexbench import weights as wts
from plexbench.harness import load_module

PB = Path(__file__).resolve().parents[1]
REF = load_module(PB / "reference" / "dense.py")
PORT = load_module(PB / "port" / "dense.py")
TINY = json.loads((PB / "tests" / "data" / "configs" /
                   "tiny-dense.json").read_text())


def _cfg(**kw):
    cfg = dict(TINY)
    cfg.update(kw)
    return cfg


def _loop_forward(w, cfg, tokens):
    """The decoder written out position by position and head by head, in
    float64 numpy: the hand-written check."""
    w = {k: v.double().numpy() for k, v in w.items()}
    h, k, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    s = len(tokens)

    def rms(x, g):
        return x / math.sqrt(np.mean(x * x) + eps) * (1 + g)

    def rot(vec, pos):
        half = hd // 2
        out = np.empty(hd)
        for i in range(half):
            a = pos * theta ** (-i / half)
            out[i] = vec[i] * math.cos(a) - vec[i + half] * math.sin(a)
            out[i + half] = vec[i + half] * math.cos(a) + vec[i] * math.sin(a)
        return out

    xs = [w["embed"][t].copy() for t in tokens]
    for layer in range(cfg["num_hidden_layers"]):
        g = lambda n: w[n][layer]  # noqa: E731
        qs, ks, vs = [], [], []
        for p, x in enumerate(xs):
            y = rms(x, g("ln1"))
            q = y @ g("wq") + g("bq")
            kk = y @ g("wk") + g("bk")
            v = y @ g("wv") + g("bv")
            qs.append([rot(q[i * hd:(i + 1) * hd], p) for i in range(h)])
            ks.append([rot(kk[i * hd:(i + 1) * hd], p) for i in range(k)])
            vs.append([v[i * hd:(i + 1) * hd] for i in range(k)])
        new = []
        for p, x in enumerate(xs):
            heads = []
            for i in range(h):
                kv = i // (h // k)
                sc = np.array([qs[p][i] @ ks[t][kv] / math.sqrt(hd)
                               for t in range(p + 1)])
                pr = np.exp(sc - sc.max())
                pr /= pr.sum()
                heads.append(sum(pr[t] * vs[t][kv] for t in range(p + 1)))
            x = x + np.concatenate(heads) @ g("wo")
            y = rms(x, g("ln2"))
            gate = y @ g("w_gate")
            act = gate / (1 + np.exp(-gate))
            new.append(x + (act * (y @ g("w_up"))) @ g("w_down"))
        xs = new
    out = []
    for x in xs:
        y = rms(x, w["ln_f"])
        out.append(y @ (w["embed"].T if cfg["tie_word_embeddings"]
                        else w["unembed"]))
    return np.stack(out)


@pytest.mark.parametrize("tied", [True, False])
def test_reference_forward_matches_the_written_out_decoder(tied):
    cfg = _cfg(tie_word_embeddings=tied, num_hidden_layers=2)
    w = wts.make_weights(cfg, 11, 0, "cpu")
    # non-zero norm offsets, so the (1 + g) gains are exercised
    for n in ("ln1", "ln2", "ln_f"):
        w[n] = (torch.randn(w[n].shape, generator=torch.Generator()
                            .manual_seed(3)) * 0.1).to(torch.bfloat16)
    tokens = torch.tensor([[5, 17, 200, 3, 9, 44]])
    p = {k: v.float() for k, v in w.items()}
    got = REF.head(p, cfg, REF.hidden(p, cfg, tokens), "f32")[0]
    want = _loop_forward(w, cfg, tokens[0].tolist())
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=2e-5)
    # served_logits: the same numbers at the positions after a prompt of 2
    served = REF.served_logits(w, cfg, tokens, 2)[0]
    np.testing.assert_allclose(served.double().numpy(), want[1:-1], rtol=0,
                               atol=2e-5)


def test_adamw_step_by_hand():
    opt = {"lr": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.0, "grad_clip": 1.0, "warmup_steps": 2}
    p = {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([0.5])}
    p["a"].grad = torch.tensor([3.0, 0.0])
    p["b"].grad = torch.tensor([4.0])
    ad = REF.AdamW(p, opt)
    gnorm, clipped = ad.update(p)
    assert gnorm == pytest.approx(5.0)
    # clipped to norm 1: (0.6, 0) and 0.8
    assert clipped["a"] == pytest.approx(0.6)
    assert clipped["b"] == pytest.approx(0.8)
    # step 1: lr 0.1 * 1/2; m/c1 = g, v/c2 = g^2: each moved by lr*sign(g)
    want_a = [float(torch.tensor(1.0 - 0.05).bfloat16()), -2.0]
    assert p["a"].tolist() == pytest.approx(want_a)
    assert p["b"].item() == pytest.approx(
        float(torch.tensor(0.5 - 0.05).bfloat16()))


def test_grpo_block_sum_by_hand():
    # one row, two positions after the first; uniform logits over 4 ids
    logits = torch.zeros(1, 3, 4)
    batch = {"tokens": torch.tensor([[0, 1, 2]]),
             "behavior_logprobs": torch.tensor([[0.0, math.log(0.25),
                                                 math.log(0.5)]]),
             "loss_mask": torch.tensor([[0.0, 1.0, 1.0]]),
             "advantages": torch.tensor([2.0])}
    part, logp = REF.grpo_block_sum(logits, batch, slice(0, 1), 0.2)
    assert logp[0].tolist() == pytest.approx([math.log(0.25)] * 2)
    # ratios 1 and 0.5: min(r A, clip(r) A) = 2 and min(1, 1.6) = 1
    assert float(part) == pytest.approx(-(2.0 + 1.0))


def test_reference_agrees_with_the_port_at_a_tiny_size():
    """The port's FORWARD log-probs (bf16, its kernels' plain versions)
    against the reference's f32 ones, over the weights the harness hands
    both."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.rl import grpo
    from plexbench.session import PORT_FIELDS
    cfg = _cfg()
    port_cfg = get_config(cfg["registry"]).replace(
        **{f: cfg[k] for k, f in PORT_FIELDS.items()})
    model = build_model(port_cfg)
    w = wts.make_weights(cfg, 5, 0, "cpu")
    params = PORT.to_port(cfg, w)
    tokens = torch.randint(3, cfg["vocab_size"], (2, 12),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = grpo.make_compute_log_prob(model)(params, {"tokens": tokens})
    p = {k: v.float() for k, v in w.items()}
    want = REF.token_logprobs(REF.head(p, cfg, REF.hidden(p, cfg, tokens),
                                       "f32"), tokens)
    gap = float((got.float() - want).abs().max())
    assert gap < 0.02, gap
    # the fp8 control sits well past the port's bf16
    ctrl = REF.token_logprobs(REF.head(p, cfg, REF.hidden(
        p, cfg, tokens, "fp8"), "fp8"), tokens)
    assert float((ctrl - want).abs().max()) > 3 * gap


def test_port_keys_cover_every_leaf_once():
    for tied in (True, False):
        cfg = _cfg(tie_word_embeddings=tied)
        names = set(wts.leaf_shapes(cfg))
        tree = PORT.to_port(cfg, wts.make_weights(cfg, 1, 0, "cpu"))
        assert set(PORT.by_reference_name(tree)) == names


def test_weights_repeat_from_the_seed_and_differ_by_job():
    a = wts.make_weights(TINY, 2 ** 40 + 1, 0, "cpu")
    b = wts.make_weights(TINY, 2 ** 40 + 1, 0, "cpu", names=["wq"])
    c = wts.make_weights(TINY, 2 ** 40 + 1, 1, "cpu", names=["wq"])
    assert torch.equal(a["wq"], b["wq"])
    assert not torch.equal(a["wq"], c["wq"])
    assert a["wq"].dtype == torch.bfloat16
