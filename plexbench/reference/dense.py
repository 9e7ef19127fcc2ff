"""Plain PyTorch reference of the dense decoder (qwen2 / Qwen2.5), its GRPO
loss and its AdamW step.

Every number is computed in float32 with TF32 off (``precision="f32"``). The
weights are the seed's bf16 draws (``plexbench/weights.py``) taken as f32.
Departures from the published Qwen2 description, each of them what the
configuration runs:

- an RMS norm's gain is stored as an offset from 1 (``x * (1 + g)``);
- parameters are stored in bf16, so an AdamW step computes in f32 and rounds
  the new parameter to bf16 (the moments stay f32).

``precision="fp8"`` is the control: every matrix product takes its two
inputs rounded to float8 (e4m3, one scale a row of the left input and one a
column of the right, as an fp8 GEMM takes them), the step below bf16 that
would tempt a faster program. Gradients pass the rounding unchanged.

Nothing here imports the program; the harness hands in the inputs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

FP8_MAX = 448.0


def strict_f32() -> None:
    """f32 products in f32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim``; the
    rounding's gradient is taken as 1."""
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp(
        min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def matmul(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _fp8(a, -1) @ _fp8(w, -2)
    return a @ w


def rms_norm(x, gain, eps: float):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + gain)


def rope(x, theta: float):
    """Rotate-half RoPE at positions 0..S-1. x: (B, S, heads, D)."""
    s, dim = x.shape[1], x.shape[-1]
    half = dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


LAYER_LEAVES = ("ln1", "wq", "wk", "wv", "bq", "bk", "bv", "wo", "ln2",
                "w_gate", "w_up", "w_down")


def layer(p: Dict[str, torch.Tensor], cfg: dict, x, precision: str):
    """One decoder layer (``p``: its leaves) on the residual stream x:
    (B, S, d) f32."""
    b, s, _ = x.shape
    h, k, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    y = rms_norm(x, p["ln1"], eps)
    q = matmul(y, p["wq"], precision)
    kk = matmul(y, p["wk"], precision)
    v = matmul(y, p["wv"], precision)
    if "bq" in p:
        q, kk, v = q + p["bq"], kk + p["bk"], v + p["bv"]
    q = rope(q.view(b, s, h, hd), cfg["rope_theta"])
    kk = rope(kk.view(b, s, k, hd), cfg["rope_theta"])
    v = v.view(b, s, k, hd)
    # every query head g reads key/value head g // (h / k)
    kk = kk.repeat_interleave(h // k, dim=2)
    v = v.repeat_interleave(h // k, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, kk) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    att = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
    x = x + matmul(att.reshape(b, s, h * hd), p["wo"], precision)
    y = rms_norm(x, p["ln2"], eps)
    gate = torch.nn.functional.silu(matmul(y, p["w_gate"], precision))
    return x + matmul(gate * matmul(y, p["w_up"], precision), p["w_down"],
                      precision)


def unembedding(p, cfg: dict):
    """The (d, V) output matrix."""
    return p["embed"].t() if cfg["tie_word_embeddings"] else p["unembed"]


def head(p, cfg: dict, x, precision: str):
    """Final norm and the logits (f32) of x: (..., d)."""
    x = rms_norm(x, p["ln_f"], cfg["rms_norm_eps"])
    return matmul(x, unembedding(p, cfg), precision)


def hidden(p, cfg: dict, tokens, precision: str = "f32"):
    """The final residual stream (B, S, d) of ``tokens`` (B, S); ``p``
    holds stacked f32 leaves."""
    x = p["embed"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        x = layer({n: p[n][i] for n in LAYER_LEAVES if n in p}, cfg, x,
                  precision)
    return x


def token_logprobs(logits, tokens):
    """log p(tokens[:, t+1] | tokens[:, :t+1]): (B, S-1)."""
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return torch.gather(lp, -1, tokens[:, 1:, None])[..., 0]


# ------------------------------------------------------------- serving

@torch.no_grad()
def served_logits(weights: Dict[str, torch.Tensor], cfg: dict, tokens,
                  prompt_len: int, precision: str = "f32"):
    """Logits (R, N, V) f32 that predict tokens[:, prompt_len:] (N served
    tokens after a prompt of ``prompt_len``), by a full forward pass over
    ``tokens`` (R, prompt_len + N). The bf16 weights are taken as f32 one
    layer at a time, and the output matrix once."""
    x = weights["embed"][tokens].float()
    for i in range(cfg["num_hidden_layers"]):
        x = layer({n: weights[n][i].float() for n in LAYER_LEAVES
                   if n in weights}, cfg, x, precision)
    x = x[:, prompt_len - 1:-1]
    top = {"ln_f": weights["ln_f"].float()}
    top["embed" if cfg["tie_word_embeddings"] else "unembed"] = (
        weights["embed"] if cfg["tie_word_embeddings"]
        else weights["unembed"]).float()
    return torch.cat([head(top, cfg, x[r:r + 1], precision)
                      for r in range(x.shape[0])])


# ------------------------------------------------------------- training

def grpo_block_sum(logits, batch, rows: slice, clip_eps: float):
    """The clipped surrogate's masked sum over the rows ``rows`` (its
    negative), and those rows' token log-probs."""
    tokens = batch["tokens"][rows]
    logp = token_logprobs(logits, tokens)
    behave = batch["behavior_logprobs"][rows, 1:]
    mask = batch["loss_mask"][rows, 1:]
    adv = batch["advantages"][rows, None]
    ratio = torch.exp(logp - behave)
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    surrogate = torch.minimum(ratio * adv, clipped * adv)
    return -(surrogate * mask).sum(), logp


def loss_and_grads(p: Dict[str, torch.Tensor], cfg: dict, batch, grpo: dict,
                   block_rows: int, precision: str = "f32"):
    """The GRPO loss of ``batch`` (masked mean over all its response
    tokens), its gradients (accumulated over blocks of ``block_rows`` rows)
    in each leaf's ``.grad``, and the token log-probs (B, S-1)."""
    for t in p.values():
        t.grad = None
    b = batch["tokens"].shape[0]
    denom = torch.clamp(batch["loss_mask"][:, 1:].sum(), min=1.0)
    loss = torch.zeros((), dtype=torch.float32, device=denom.device)
    logps = []
    for r0 in range(0, b, block_rows):
        rows = slice(r0, min(b, r0 + block_rows))
        x = hidden(p, cfg, batch["tokens"][rows], precision)
        logits = head(p, cfg, x, precision)
        part, logp = grpo_block_sum(logits, batch, rows, grpo["clip_eps"])
        part = part / denom
        part.backward()
        loss += part.detach()
        logps.append(logp.detach())
        del x, logits, part
    return loss, torch.cat(logps)


class AdamW:
    """The configuration's AdamW: the learning rate from the step count
    before the update (linear warmup), bias corrections from the count
    after it, gradients clipped by their global f32 norm, moments in f32,
    parameters rounded to their stored bf16."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.opt = opt
        self.step = 0
        self.m = {k: torch.zeros_like(t) for k, t in params.items()}
        self.v = {k: torch.zeros_like(t) for k, t in params.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor]):
        """One step from each leaf's ``.grad``. Returns the global
        gradient norm and each leaf's clipped gradient's norm."""
        o = self.opt
        gnorm = torch.sqrt(sum(torch.sum(t.grad * t.grad)
                               for t in params.values()))
        scale = torch.clamp(o["grad_clip"] / (gnorm + 1e-9), max=1.0) \
            if o["grad_clip"] else torch.ones_like(gnorm)
        lr = o["lr"] * min(1.0, (self.step + 1) / max(o["warmup_steps"], 1))
        t = self.step + 1
        c1, c2 = 1.0 - o["b1"] ** t, 1.0 - o["b2"] ** t
        clipped = {}
        for k, p in params.items():
            g = p.grad * scale
            clipped[k] = float(torch.linalg.vector_norm(g))
            self.m[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
            self.v[k].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            delta = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + o["eps"])
            if o["weight_decay"]:
                delta = delta + o["weight_decay"] * p
            p.copy_((p - lr * delta).to(torch.bfloat16).float())
        self.step = t
        return float(gnorm), clipped


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                batches: List[dict], block_rows: int,
                precision: str = "f32", rows: Optional[slice] = None):
    """Follow the program's first ``len(batches)`` GRPO steps from the
    seed's weights. ``rows`` keeps only those rows of every batch (a fault
    the check must catch). Returns each step's loss, the first step's
    token log-probs, each leaf's first clipped gradient norm and its raw
    gradient norm, and each leaf's change after the last step."""
    p = {k: t.float().requires_grad_() for k, t in weights.items()}
    opt = AdamW(p, cfg["optimizer"])
    losses, logp0, grad1, raw1 = [], None, None, None
    for batch in batches:
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
            # the advantages stay as packed: the mean over the rest
        loss, logp = loss_and_grads(p, cfg, batch, cfg["grpo"], block_rows,
                                    precision)
        losses.append(float(loss))
        if logp0 is None:
            logp0 = logp
            raw1 = {k: float(torch.linalg.vector_norm(t.grad))
                    for k, t in p.items()}
        _, clipped = opt.update(p)
        if grad1 is None:
            grad1 = clipped
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(t - weights[k].float()))
                  for k, t in p.items()}
    return {"losses": losses, "logp0": logp0, "grad1": grad1,
            "raw_grad1": raw1, "change": change}


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves) -> float:
    """The largest |prog - ref| of a leaf's norm over ``leaves``, against
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    base = median([ref[k] for k in leaves])
    worst = 0.0
    for k in leaves:
        den = max(ref[k], base)
        if den > 0:
            worst = max(worst, abs(prog[k] - ref[k]) / den)
    return worst


def moving_leaves(raw_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    base = median(list(raw_grad.values()))
    return [k for k, g in raw_grad.items() if g >= 1e-3 * base]


def sanity(x: float) -> float:
    return x if math.isfinite(x) else float("inf")
