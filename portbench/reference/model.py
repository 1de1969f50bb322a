"""Plain fp32 PyTorch reference of the benchmark's models.

The dense decoder (RMSNorm, RoPE, causal GQA attention, SwiGLU), Jamba's
Mamba mixer (causal depthwise conv, selective scan walked position by
position), its top-k MoE with GShard capacity (token-major choices sorted
stably by expert, each expert keeping its first ``ceil(T·k/E·factor)``,
the rest dropped) and untied or tied heads. The MoE takes DeepSeek's
variant from the configuration: shared experts, sigmoid scoring with a
selection bias, a routed scale (``Ref.moe``). It reads the configuration's
JSON file and the benchmark's weights (the parameter tree of
``portbench.weights``); every product runs in fp32 with TF32 off.

``Ref(cfg, params, quant=True)`` is the control: the same reference with
both operands of every product rounded to fp8 (e4m3, one scale a tensor),
the step below the configuration's bf16.

It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from portbench import archs

__all__ = ["Ref", "fp8_round", "exact_fp32"]

_NEG = -1e30
_FP8_MAX = 448.0


def exact_fp32() -> None:
    """Products in true fp32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, rounded to e4m3 under one per-tensor scale (amax to
    448), as an fp8 product's operand is."""
    x = x.float()
    amax = x.abs().amax().clamp(min=1e-30)
    scale = _FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Product(torch.autograd.Function):
    """x @ w with both operands rounded to fp8; the backward's products
    take fp8 operands too."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return fp8_round(x) @ fp8_round(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g8 = fp8_round(g)
        return g8 @ fp8_round(w).transpose(-1, -2), fp8_round(x).transpose(-1, -2) @ g8


class Ref:
    """The reference model over ``params`` (leaves of any float dtype,
    read as fp32). ``params`` may hold fp32 leaves that require grad (the
    training reference differentiates through them). A layer runs its
    mixer and MLP by kind (``mixer``, ``mixer_state``, ``mixer_step``,
    ``ffn``); a kind the built-ins lack runs ``archs/<kind>.py``'s
    ``forward``, ``state`` and ``step``, and raises where there is none."""

    def __init__(self, cfg: dict, params: dict, *, quant: bool = False):
        self.cfg = cfg
        self.p = params
        self.quant = quant
        d = cfg["d_model"]
        self.d = d
        self.h, self.hkv = cfg["num_heads"], cfg["num_kv_heads"]
        self.hd = cfg.get("head_dim") or d // self.h
        self.eps = cfg["norm_eps"]
        self.pattern = [tuple(b) for b in cfg["pattern"]]
        self.periods = cfg["num_layers"] // len(self.pattern)
        self.ds = cfg.get("ssm_d_state", 16)
        self.dtr = cfg.get("ssm_dt_rank") or math.ceil(d / 16)
        self.vocab = cfg["vocab_size"]

    # -- pieces ---------------------------------------------------------------

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.quant:
            return _Fp8Product.apply(x, w)
        return x @ w

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * scale.float()

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """(B, S, H, D) rotated by positions (B, S): the two halves of each
        head as the real and imaginary parts."""
        if self.cfg.get("rope_type", "rope") != "rope":
            return x
        hd = x.shape[-1]
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = pos[..., None].float() * inv
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def mlp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return self.mm(F.silu(self.mm(x, p["w_gate"])) * self.mm(x, p["w_up"]), p["w_down"])

    def head(self, x: torch.Tensor) -> torch.Tensor:
        e = self.p["embed"]
        if self.cfg.get("tie_embeddings", False):
            return self.mm(x, e["tokens"].transpose(0, 1))
        return self.mm(x, e["head"])

    # -- attention --------------------------------------------------------------

    def _qkv(self, p: dict, x: torch.Tensor, pos: torch.Tensor):
        b, s, _ = x.shape
        q = self.mm(x, p["wq"]).view(b, s, self.h, self.hd)
        k = self.mm(x, p["wk"]).view(b, s, self.hkv, self.hd)
        v = self.mm(x, p["wv"]).view(b, s, self.hkv, self.hd)
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q, k, v, q0: int, block: int = 1024) -> torch.Tensor:
        """Causal softmax attention of q (B, Sq, H, D) at positions q0.. over
        k (B, Skv, Hkv, D) and v (B, Skv, Hkv, Dv) at positions 0.., in
        blocks of queries, scaled by D^-1/2: (B, Sq, H·Dv)."""
        b, sq, h, hd = q.shape
        dv = v.shape[-1]
        g = h // self.hkv
        kk = k.permute(0, 2, 3, 1)[:, :, None]                 # (B, Hkv, 1, D, Skv)
        vv = v.permute(0, 2, 1, 3)[:, :, None]                 # (B, Hkv, 1, Skv, Dv)
        kpos = torch.arange(k.shape[1], device=q.device)
        outs = []
        for s0 in range(0, sq, block):
            qb = q[:, s0:s0 + block]
            n = qb.shape[1]
            qg = qb.permute(0, 2, 1, 3).reshape(b, self.hkv, g, n, hd)
            sc = self.mm(qg, kk) * hd ** -0.5                   # (B, Hkv, g, n, Skv)
            qpos = q0 + s0 + torch.arange(n, device=q.device)
            sc = sc.masked_fill(kpos[None, :] > qpos[:, None], _NEG)
            o = self.mm(torch.softmax(sc, dim=-1), vv)          # (B, Hkv, g, n, Dv)
            outs.append(o.reshape(b, h, n, dv).permute(0, 2, 1, 3))
        return torch.cat(outs, dim=1).reshape(b, sq, h * dv)

    # -- MoE ----------------------------------------------------------------------

    def moe(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """x (T, d) -> (T, d): top-k routing, GShard capacity, renormalised
        weights; a dropped choice adds nothing. The configuration's fields,
        each defaulting to the plain GShard MoE:

        * ``moe_scoring``: ``"softmax"`` (the weights are the softmax of
          x·router) or ``"sigmoid"`` (scores sigmoid(x·router) in fp32; the
          experts chosen by the top-k of the scores plus the fp32 leaf
          ``router_bias``, the weights the chosen scores without it); either
          way the k weights are divided by their sum;
        * ``moe_routed_scale`` (1.0): multiplies the routed sum;
        * ``moe_shared_experts`` (0): a SwiGLU MLP of that many experts'
          width (``shared_up``, ``shared_gate``, ``shared_down``) on every
          token, added to the routed sum unscaled.

        Dropless needs no field: a ``moe_capacity_factor`` of at least E/k
        gives a capacity of at least T, and no expert is chosen by more
        than the T tokens, so every choice is kept."""
        cfg = self.cfg
        e, k = cfg["moe_experts"], cfg["moe_top_k"]
        t = x.shape[0]
        cap = max(1, math.ceil(t * k / e * cfg["moe_capacity_factor"]))
        logits = self.mm(x, p["router"])
        if cfg.get("moe_scoring", "softmax") == "sigmoid":
            scores = torch.sigmoid(logits)
            top_e = torch.topk(scores + p["router_bias"].float(), k, dim=-1).indices
            top_p = torch.gather(scores, -1, top_e)
        else:
            top_p, top_e = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        first = torch.searchsorted(sorted_e, torch.arange(e, device=x.device))
        rank = torch.empty_like(flat_e)
        rank[order] = torch.arange(t * k, device=x.device) - first[sorted_e]
        kept = (rank < cap).view(t, k)
        y = torch.zeros_like(x)
        tok = torch.arange(t, device=x.device)[:, None].expand(t, k)
        for j in range(e):
            sel = (top_e == j) & kept
            if not bool(sel.any()):
                continue
            rows, w = tok[sel], top_p[sel]
            h = F.silu(self.mm(x[rows], p["w_gate"][j])) * self.mm(x[rows], p["w_up"][j])
            y.index_add_(0, rows, self.mm(h, p["w_down"][j]) * w[:, None])
        y = y * cfg.get("moe_routed_scale", 1.0)
        if cfg.get("moe_shared_experts", 0):
            y = y + self.mlp({"w_gate": p["shared_gate"], "w_up": p["shared_up"],
                              "w_down": p["shared_down"]}, x)
        return y

    # -- Mamba ----------------------------------------------------------------------

    def _mamba_in(self, p: dict, x: torch.Tensor, conv_state: torch.Tensor | None):
        """(xin after conv and SiLU, z, the conv window's new state)."""
        di = self.cfg.get("ssm_expand", 2) * self.d
        xz = self.mm(x, p["w_in"])
        xin, z = xz[..., :di], xz[..., di:]
        kc = p["conv_w"].shape[0]
        left = (torch.zeros(x.shape[0], kc - 1, di, device=x.device)
                if conv_state is None else conv_state)
        xp = torch.cat([left, xin], dim=1)
        w = p["conv_w"].float()
        conv = sum(xp[:, i:i + xin.shape[1]] * w[i] for i in range(kc)) + p["conv_b"].float()
        return F.silu(conv), z, xp[:, -(kc - 1):]

    def _ssm_params(self, p: dict, xin: torch.Tensor):
        proj = self.mm(xin, p["w_x"])
        dt_low = proj[..., :self.dtr]
        bm = proj[..., self.dtr:self.dtr + self.ds]
        cm = proj[..., self.dtr + self.ds:]
        dt = F.softplus(self.mm(dt_low, p["w_dt"]) + p["dt_bias"].float())
        a = -torch.exp(p["a_log"].float())
        return dt, bm, cm, a

    def mamba(self, p: dict, x: torch.Tensor, chunk: int = 128) -> torch.Tensor:
        """Full sequence x (B, S, d): h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t B_t,
        y_t = h_t·C_t + D x_t, walked one position at a time."""
        xin, z, _ = self._mamba_in(p, x, None)
        dt, bm, cm, a = self._ssm_params(p, xin)
        b, s, di = xin.shape
        h = torch.zeros(b, di, self.ds, device=x.device)
        ys = []
        for c0 in range(0, s, chunk):
            da = torch.exp(dt[:, c0:c0 + chunk, :, None] * a)            # (B, c, di, ds)
            dbx = (dt[:, c0:c0 + chunk] * xin[:, c0:c0 + chunk])[..., None] \
                * bm[:, c0:c0 + chunk, None, :]
            for t in range(da.shape[1]):
                h = da[:, t] * h + dbx[:, t]
                ys.append(torch.einsum("bis,bs->bi", h, cm[:, c0 + t]))
        y = torch.stack(ys, dim=1) + xin * p["d_skip"].float()
        return self.mm(y * F.silu(z), p["w_out"])

    def mamba_step(self, p: dict, x: torch.Tensor, state: dict) -> torch.Tensor:
        """One position x (B, 1, d) against ``state`` ({"conv", "h"}, updated)."""
        xin, z, state["conv"] = self._mamba_in(p, x, state["conv"])
        dt, bm, cm, a = self._ssm_params(p, xin)
        state["h"] = torch.exp(dt[:, 0, :, None] * a) * state["h"] \
            + (dt[:, 0] * xin[:, 0])[..., None] * bm[:, 0, None, :]
        y = torch.einsum("bis,bs->bi", state["h"], cm[:, 0]) + xin[:, 0] * p["d_skip"].float()
        return self.mm(y[:, None] * F.silu(z), p["w_out"])

    # -- a layer, by kind ----------------------------------------------------------------

    def mixer(self, kind: str, p: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The mixer over a full sequence x (B, S, d) at positions ``pos``."""
        if kind == "attn":
            q, k, v = self._qkv(p, x, pos)
            return self.mm(self.attend(q, k, v, 0), p["wo"])
        if kind == "mamba":
            return self.mamba(p, x)
        return archs.find(kind, "forward", "reference for mixer")(self, p, x, pos)

    def mixer_state(self, kind: str, batch: int, max_len: int, device: Any) -> dict:
        """The mixer's decoding state for ``batch`` rows of up to ``max_len``
        positions."""
        if kind == "attn":
            return {"k": torch.zeros(batch, max_len, self.hkv, self.hd, device=device),
                    "v": torch.zeros(batch, max_len, self.hkv, self.hd, device=device)}
        if kind == "mamba":
            di = self.cfg.get("ssm_expand", 2) * self.d
            kc = self.cfg.get("ssm_d_conv", 4)
            return {"conv": torch.zeros(batch, kc - 1, di, device=device),
                    "h": torch.zeros(batch, di, self.ds, device=device)}
        return archs.find(kind, "state", "reference for mixer")(self, batch, max_len, device)

    def mixer_step(self, kind: str, p: dict, x: torch.Tensor, t: int,
                   state: dict) -> torch.Tensor:
        """The mixer on one position x (B, 1, d) at position ``t`` against
        its ``state`` (updated)."""
        if kind == "attn":
            q, k, v = self._qkv(p, x, torch.full((x.shape[0], 1), t, device=x.device))
            state["k"][:, t], state["v"][:, t] = k[:, 0], v[:, 0]
            o = self.attend(q, state["k"][:, :t + 1], state["v"][:, :t + 1], t)
            return self.mm(o, p["wo"])
        if kind == "mamba":
            return self.mamba_step(p, x, state)
        return archs.find(kind, "step", "reference for mixer")(self, p, x, t, state)

    def ffn(self, kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
        """The MLP on x (B, S, d); an MoE layer routes the B·S tokens as one
        group."""
        if kind == "dense":
            return self.mlp(p, x)
        if kind == "moe":
            b, s, d = x.shape
            return self.moe(p, x.reshape(b * s, d)).view(b, s, d)
        return archs.find(kind, "forward", "reference for mlp")(self, p, x)

    # -- the stack --------------------------------------------------------------------

    def blocks(self):
        for i in range(self.periods):
            for j, kind in enumerate(self.pattern):
                yield (i, j), kind, self.p["stack"][i][j]

    def block(self, kind, p: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Full-sequence block on x (B, S, d)."""
        mixer, mlp = kind
        x = x + self.mixer(mixer, p["mixer"], self.norm(x, p["ln1"]["scale"]), pos)
        if mlp == "none":
            return x
        return x + self.ffn(mlp, p["mlp"], self.norm(x, p["ln2"]["scale"]))

    def block_step(self, kind, p: dict, x: torch.Tensor, t: int, state: dict) -> torch.Tensor:
        """The block on one position x (B, 1, d) at position ``t``."""
        mixer, mlp = kind
        x = x + self.mixer_step(mixer, p["mixer"], self.norm(x, p["ln1"]["scale"]), t, state)
        if mlp == "none":
            return x
        return x + self.ffn(mlp, p["mlp"], self.norm(x, p["ln2"]["scale"]))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.p["embed"]["tokens"][tokens.long()].float()

    def hidden(self, tokens: torch.Tensor, *, checkpoint: bool = False) -> torch.Tensor:
        """Final-normed hidden states (B, S, d) of a full-sequence forward."""
        b, s = tokens.shape
        pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
        x = self.embed(tokens)
        for _, kind, p in self.blocks():
            if checkpoint:
                x = torch.utils.checkpoint.checkpoint(self.block, kind, p, x, pos,
                                                      use_reentrant=False)
            else:
                x = self.block(kind, p, x, pos)
        return self.norm(x, self.p["final_norm"]["scale"])

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.head(self.hidden(tokens))

    # -- step-by-step decoding over every row -------------------------------------------

    def decode_state(self, batch: int, max_len: int, device: Any) -> dict:
        st: dict = {"len": 0}
        for at, (mixer, _), _ in self.blocks():
            st[at] = self.mixer_state(mixer, batch, max_len, device)
        return st

    def step(self, tok: torch.Tensor, st: dict) -> torch.Tensor:
        """Logits (B, V) after feeding one token a row (B,) at position
        ``st["len"]``; every row is one request of one batch, so an MoE
        layer routes the B tokens as one group."""
        t = st["len"]
        x = self.embed(tok[:, None])
        for at, kind, p in self.blocks():
            x = self.block_step(kind, p, x, t, st[at])
        st["len"] = t + 1
        return self.head(self.norm(x, self.p["final_norm"]["scale"]))[:, 0]
