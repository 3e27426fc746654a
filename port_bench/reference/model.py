"""The plain reference: the decoder of a configuration file in plain
PyTorch, float32 with TF32 off, written from the layer equations and not
from the program (it imports nothing of it).

A block is `x + mixer(norm(x))`, then `x + ffn(norm(x))`:

* RMSNorm `x * rsqrt(mean(x^2) + eps) * scale`;
* attention: q, k, v projections with their biases when the
  configuration has them, rotary embeddings on q and k (half-split
  rotation, theta from the file), causal softmax(q k^T / sqrt(hd)) v with
  each group of q heads on one kv head, the output projection;
* Mamba: in_proj into x and z, a depthwise causal conv of width K by
  shifted adds, silu, x_proj into dt (through dt_proj, its bias and a
  softplus), B and C; h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
  y_t = C_t h_t + D x_t with A = -exp(a_log), walked in order; y silu(z)
  through out_proj;
* the gated silu MLP `(silu(x Wg) * (x Wu)) Wd`;
* the routed experts: router logits in f32 over the padded experts, the
  pads masked, softmax, top-k renormalised; per batch row each (token,
  choice) slot, in token order, ranks among the slots of its expert and
  is dropped at the capacity; each kept slot's expert MLP weighted by its
  router weight; the shared experts as one MLP; the Switch aux loss
  `E * sum(mean(probs) * share of first choices)`;
* the head: final norm, x @ unembed over the padded vocabulary; the
  training loss `mean NLL + w_aux * sum(aux) + w_z * mean(lse^2)`.

Every weight product goes through `Linear`, whose `precision` "fp8" is
the control: both operands rounded to float8 e4m3 with a per-tensor
scale, the product in f32 (the precision below the configuration's
bfloat16); "bf16" rounds them to bfloat16, a witness of what that
precision alone does to the reference.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..arch import Arch
from . import judge

Params = Dict[str, torch.Tensor]
E4M3_MAX = 448.0
HEADS_AT_ONCE = 8


@contextlib.contextmanager
def exact_f32():
    """float32 products as float32 (no TF32), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with a per-tensor scale; the gradient
    passes as through the identity."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


def bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16; the gradient passes as through the
    identity."""
    return t + (t.detach().bfloat16().float() - t.detach())


ROUND = {"f32": None, "bf16": bf16, "fp8": fp8}


class Linear:
    """x @ w in f32, both operands first rounded to `precision`."""

    def __init__(self, precision: str = "f32"):
        self.round = ROUND[precision]

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.round is not None:
            x, w = self.round(x), self.round(w)
        return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B,S,H,hd]: the first and second halves of each head rotated by
    position * theta^(-i/half)."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


class Reference:
    """The forward of `arch` over the leaves `p` (any float dtype; each is
    read as f32), its weight products in `precision`."""

    def __init__(self, arch: Arch, p: Params, precision: str = "f32"):
        self.a, self.p, self.lin = arch, p, Linear(precision)
        self.eps = arch.rms_norm_eps

    def w(self, name: str, index: Optional[int] = None) -> torch.Tensor:
        t = self.p[name]
        return (t if index is None else t[index]).float()

    # ------------------------------------------------------------ mixers
    def attention(self, m: str, x: torch.Tensor) -> torch.Tensor:
        a, lin = self.a, self.lin
        b, s, _ = x.shape
        hd, nq, nkv = a.head_dim, a.num_heads, a.num_kv_heads
        q, k, v = (lin(x, self.w(m + n)) for n in ("wq", "wk", "wv"))
        if a.raw.get("qkv_bias"):
            q, k, v = q + self.w(m + "bq"), k + self.w(m + "bk"), \
                v + self.w(m + "bv")
        q = rope(q.view(b, s, nq, hd), a.rope_theta)
        k = rope(k.view(b, s, nkv, hd), a.rope_theta)
        v = v.view(b, s, nkv, hd)
        k = k.repeat_interleave(nq // nkv, dim=2)
        v = v.repeat_interleave(nq // nkv, dim=2)
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        outs = []
        for h0 in range(0, nq, HEADS_AT_ONCE):     # bounds the f32 scores
            hs = slice(h0, h0 + HEADS_AT_ONCE)
            scores = torch.einsum("bshd,bthd->bhst", q[:, :, hs],
                                  k[:, :, hs]) * hd ** -0.5
            scores = scores.masked_fill(~mask, float("-inf"))
            outs.append(torch.einsum("bhst,bthd->bshd",
                                     torch.softmax(scores, -1), v[:, :, hs]))
        o = torch.cat(outs, 2)
        return lin(o.reshape(b, s, nq * hd), self.w(m + "wo"))

    def mamba(self, m: str, x: torch.Tensor) -> torch.Tensor:
        a, lin = self.a, self.lin
        di, n, dr = a.d_inner, a.ssm_d_state, a.dt_rank
        xz = lin(x, self.w(m + "in_proj"))
        xin, z = xz[..., :di], xz[..., di:]
        cw = self.w(m + "conv_w")
        kw, s = cw.shape[0], x.shape[1]
        conv = self.w(m + "conv_b").expand_as(xin).clone()
        for i in range(kw):
            shift = kw - 1 - i
            conv = conv + F.pad(xin, (0, 0, shift, 0))[:, :s] * cw[i]
        xin = F.silu(conv)
        dbc = lin(xin, self.w(m + "x_proj"))
        dt = F.softplus(lin(dbc[..., :dr], self.w(m + "dt_proj"))
                        + self.w(m + "dt_bias"))
        y = selective_scan(xin, dt, self.w(m + "a_log"), dbc[..., dr:dr + n],
                           dbc[..., dr + n:], self.w(m + "d"))
        return lin(y * F.silu(z), self.w(m + "out_proj"))

    # -------------------------------------------------------------- ffns
    def mlp(self, f: str, x: torch.Tensor) -> torch.Tensor:
        lin = self.lin
        h = F.silu(lin(x, self.w(f + "w_gate"))) * lin(x, self.w(f + "w_up"))
        return lin(h, self.w(f + "w_down"))

    def moe(self, f: str, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
        """(y, aux, the rows kept per expert of each batch row [b][E])."""
        a, lin = self.a, self.lin
        b, s, d = x.shape
        e_real, e_pad, k = a.num_experts, a.experts_padded, a.experts_per_tok
        cap = a.capacity(s)
        logits = lin(x, self.w(f + "router"))
        pad = torch.arange(e_pad, device=x.device) >= e_real
        logits = logits.masked_fill(pad, -1e30)
        probs = torch.softmax(logits, -1)
        top_w, top_i = torch.topk(probs, k, dim=-1)
        top_w = top_w / top_w.sum(-1, keepdim=True)
        first = F.one_hot(top_i[..., 0], e_pad).float().mean((0, 1))
        aux = (probs.mean((0, 1)) * first).sum() * e_real

        # slot j of row r is (token j // k, choice j % k); its rank is the
        # number of earlier slots of that row on the same expert
        slot_e = top_i.reshape(b, s * k)
        onehot = F.one_hot(slot_e, e_pad)
        rank = (onehot.cumsum(1) * onehot).sum(-1) - 1
        keep = (rank < cap).reshape(-1)
        flat_e = slot_e.reshape(-1)
        token = (torch.arange(b * s * k, device=x.device) // k)
        xs = x.reshape(b * s, d)
        rows = (onehot * keep.view(b, s * k, 1)).sum(1).tolist()
        idx_all, out_all = [], []
        for e in range(e_real):
            idx = torch.nonzero(keep & (flat_e == e)).flatten()
            if not idx.numel():
                continue
            xe = xs[token[idx]]
            h = F.silu(lin(xe, self.w(f + "w_gate", e))) \
                * lin(xe, self.w(f + "w_up", e))
            out_all.append(lin(h, self.w(f + "w_down", e))
                           * top_w.reshape(-1)[idx, None])
            idx_all.append(idx)
        slots = torch.zeros(b * s * k, d, device=x.device)
        if idx_all:
            slots = slots.index_copy(0, torch.cat(idx_all), torch.cat(out_all))
        y = slots.view(b, s, k, d).sum(2)
        if a.num_shared_experts:
            y = y + self.mlp(f + "shared.", x)
        return y, aux, rows

    # ------------------------------------------------------------ blocks
    def block(self, i: int, x: torch.Tensor):
        """Layer i: (x, aux, rows kept per expert or None)."""
        mixer, ffn = self.a.layers[i]
        p = f"layers.{i}."
        h = rms_norm(x, self.w(p + "norm_mixer.scale"), self.eps)
        if mixer == "attn":
            x = x + self.attention(p + "mixer.", h)
        elif mixer == "mamba":
            x = x + self.mamba(p + "mixer.", h)
        else:
            raise ValueError(f"mixer {mixer!r}")
        aux, rows = x.new_zeros(()), None
        if ffn != "none":
            h = rms_norm(x, self.w(p + "norm_ffn.scale"), self.eps)
            if ffn == "moe":
                h, aux, rows = self.moe(p + "ffn.", h)
            else:
                h = self.mlp(p + "ffn.", h)
            x = x + h
        return x, aux, rows

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.p["embed.embedding"][tokens.long()].float()

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.w("final_norm.scale"), self.eps)
        return self.lin(x, self.w("embed.unembed"))


def selective_scan(x, dt, a_log, bm, cm, dvec, chunk: int = 256):
    """y [B,S,D] of h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t (h_0 = 0),
    y_t = C_t h_t + D x_t, walked step by step in f32, `chunk` steps of
    [B,D,N] terms formed at a time."""
    a = -torch.exp(a_log)
    bsz, s, d = x.shape
    h = x.new_zeros(bsz, d, a.shape[1])
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(s, c0 + chunk))
        dtc = dt[:, sl].transpose(0, 1)                       # [T,B,D]
        da = torch.exp(dtc[..., None] * a)                    # [T,B,D,N]
        dbx = (dtc * x[:, sl].transpose(0, 1))[..., None] \
            * bm[:, sl].transpose(0, 1)[:, :, None, :]
        hs = []
        for t in range(da.shape[0]):
            h = torch.addcmul(dbx[t], da[t], h)
            hs.append(h)
        hs = torch.stack(hs, 1)                               # [B,T,D,N]
        ys.append(torch.einsum("btdn,btn->btd", hs, cm[:, sl]))
    return torch.cat(ys, 1) + x * dvec


# ------------------------------------------------------------ entry points
@torch.no_grad()
def logits(arch: Arch, p: Params, tokens: torch.Tensor,
           precision: str = "f32"):
    """Forward of `tokens` [n,S], layer by layer: (logits [n,S,V] f32,
    {expert layer index: rows kept per expert [n][E]})."""
    with exact_f32():
        ref = Reference(arch, p, precision)
        x = ref.embed(tokens)
        rows = {}
        for i in range(len(arch.layers)):
            x, _, r = ref.block(i, x)
            if r is not None:
                rows[i] = r
        return ref.head(x), rows


def loss(ref: Reference, tokens, labels, w_aux: float, w_z: float,
         row_chunk: int = 1024):
    """The training loss over [B,S] tokens, each block and each chunk of
    rows of the head recomputed in the backward: (total, mean NLL, rows
    kept per expert by layer)."""
    x = ref.embed(tokens)
    aux_sum = x.new_zeros(())
    rows = {}
    for i in range(len(ref.a.layers)):
        out = {}

        def run(x, i=i, out=out):
            y, aux, r = ref.block(i, x)
            out["rows"] = r
            return y, aux
        x, aux = checkpoint(run, x, use_reentrant=False)
        aux_sum = aux_sum + aux
        if out["rows"] is not None:
            rows[i] = out["rows"]

    def head_sums(xc, lc):
        lg = ref.head(xc)
        lse = torch.logsumexp(lg, -1)
        nll = lse - torch.gather(lg, -1, lc.long()[..., None])[..., 0]
        return nll.sum(), (lse * lse).sum()
    xf, lf = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    nll_sum, z_sum = x.new_zeros(()), x.new_zeros(())
    for r0 in range(0, xf.shape[0], row_chunk):
        a_, b_ = checkpoint(head_sums, xf[r0:r0 + row_chunk],
                            lf[r0:r0 + row_chunk], use_reentrant=False)
        nll_sum, z_sum = nll_sum + a_, z_sum + b_
    n = xf.shape[0]
    nll = nll_sum / n
    return nll + w_aux * aux_sum + w_z * z_sum / n, nll, rows


def adamw_lr(step: int, peak_lr: float, warmup_steps: int, total_steps: int,
             min_lr_frac: float) -> float:
    """Linear warm-up to the peak over `warmup_steps`, then cosine decay
    to `min_lr_frac` of it at `total_steps`."""
    import math
    if step < warmup_steps:
        return peak_lr * step / max(warmup_steps, 1)
    prog = min(1.0, max(0.0, (step - warmup_steps)
                        / max(total_steps - warmup_steps, 1)))
    return peak_lr * (min_lr_frac + (1 - min_lr_frac) * 0.5
                      * (1 + math.cos(math.pi * prog)))


def train(arch: Arch, p: Params, batches: list, opt: dict, w_aux: float,
          w_z: float, precision: str = "f32", device=None,
          sample_seed: int = 0) -> dict:
    """Steps 1.. of clipped AdamW over `batches` ({"tokens", "labels"}
    numpy arrays), from the leaves `p`, which are updated in place and
    kept in their own dtypes (the configuration's parameter dtype), the
    arithmetic in f32. Returns each step's mean NLL, each leaf's norm of
    the step-1 gradient as the optimizer takes it (from m after one
    step) and a sample of its elements drawn from `sample_seed`
    ("grad1", `judge.sample_leaves`), and the rows kept per expert of
    every step and expert layer."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    names = list(p)
    m = {n: torch.zeros(p[n].shape, device=p[n].device) for n in names}
    v = {n: torch.zeros(p[n].shape, device=p[n].device) for n in names}
    losses, rows_by_step, grad_norms = [], [], {}
    with exact_f32():
        for t, batch in enumerate(batches, 1):
            leaves = {n: (p[n].float() if p[n].dtype != torch.float32
                          else p[n].clone()).requires_grad_() for n in names}
            ref = Reference(arch, leaves, precision)
            tok = torch.as_tensor(batch["tokens"], device=device)
            lab = torch.as_tensor(batch["labels"], device=device)
            total, nll, rows = loss(ref, tok, lab, w_aux, w_z)
            grads = torch.autograd.grad(total, [leaves[n] for n in names])
            losses.append(float(nll.detach()))
            rows_by_step.append(rows)
            del leaves, ref, total
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9), max=1.0)
            lr = adamw_lr(t, opt["peak_lr"], opt["warmup_steps"],
                          opt["total_steps"], opt["min_lr_frac"])
            with torch.no_grad():
                for n, g in zip(names, grads):
                    g = g * scale
                    m[n].mul_(b1).add_((1 - b1) * g)
                    v[n].mul_(b2).add_((1 - b2) * g * g)
                    pf = p[n].float()
                    delta = (m[n] / (1 - b1 ** t)) / (
                        torch.sqrt(v[n] / (1 - b2 ** t)) + eps) + wd * pf
                    p[n].copy_(pf - lr * delta)
            del grads
            if t == 1:
                grad_norms = {n: float(m[n].norm()) / (1 - b1) for n in names}
                grad1 = {n: v / (1 - b1) for n, v in
                         judge.sample_leaves(m, sample_seed).items()}
    return {"losses": losses, "grad_norms": grad_norms, "grad1": grad1,
            "rows": rows_by_step}
